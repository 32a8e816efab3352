"""Minimal PLY mesh I/O (replaces trimesh export in utils/plots.py).

A copy of ``hashmodnffbanks_idr_tpu/utils/ply.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray = None) -> None:
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    has_color = colors is not None
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(verts)}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            c = np.asarray(colors)
            if c.dtype != np.uint8:
                c = np.clip(c * 255, 0, 255).astype(np.uint8)
            vdata = np.zeros(len(verts), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            vdata["xyz"] = verts
            vdata["rgb"] = c
            f.write(vdata.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        fdata = np.zeros(len(faces), dtype=[("n", np.uint8), ("idx", "<i4", 3)])
        fdata["n"] = 3
        fdata["idx"] = faces
        f.write(fdata.tobytes())


def read_ply(path: str):
    """Read a PLY written by write_ply or simple ascii/binary meshes."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", "not a ply file"
        fmt = None
        n_verts = n_faces = 0
        vert_props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                n_verts = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element face"):
                n_faces = int(line.split()[-1])
                in_vertex = False
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                vert_props.append((parts[1].decode(), parts[2].decode()))
            elif line == b"end_header":
                break
        tmap = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4"}
        if fmt == b"ascii":
            verts = []
            for _ in range(n_verts):
                vals = f.readline().split()
                verts.append([float(v) for v in vals[:3]])
            faces = []
            for _ in range(n_faces):
                vals = f.readline().split()
                faces.append([int(v) for v in vals[1:4]])
            return np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int64)
        dtype = np.dtype([(name, tmap[t]) for t, name in vert_props])
        vdata = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype)
        verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], axis=-1).astype(np.float32)
        fdtype = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        fdata = np.frombuffer(f.read(n_faces * fdtype.itemsize), dtype=fdtype)
        return verts, fdata["idx"].astype(np.int64)
