"""Camera preprocessing and the COLMAP import in the port against the JAX
package, on the CPU.

* ``preprocess_cameras`` on the dummy scene (8 views, 64x64): the epipolar
  bounds equal for the same seed (a numpy copy); both voxel carves' votes
  equal to the JAX module's loops (written out here in numpy, as the JAX
  module keeps them inside its functions); the centres and scales of
  ``refine_visual_hull``, ``visual_hull_scale`` and ``compute_scale_mats``
  (every method, and the linear-init file) within 1e-9 of JAX's;
* COLMAP: a small binary sparse model written here (two cameras, three
  images, points and 2D tracks), read by both readers to the same fields,
  and ``colmap_to_cameras_npz`` writing the same ``cameras.npz``.
"""

import os
import struct

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu.data import preprocess_cameras as jpc
from hashmodnffbanks_idr_tpu.data.colmap import gen_cameras as j_gen_cameras
from hashmodnffbanks_idr_tpu.data.colmap import read_model as j_read_model

from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
from hashmodnffbanks_idr_tpu_torch.data import preprocess_cameras as pc
from hashmodnffbanks_idr_tpu_torch.data.colmap import gen_cameras, read_model
from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import glob_imgs, load_mask

N_VIEWS = 8


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    scan = str(tmp_path_factory.mktemp("pre") / "dummy" / "scan0")
    dummy_cli.main(["--out", scan, "--views", str(N_VIEWS), "--size", "64"])
    cams = np.load(os.path.join(scan, "cameras.npz"))
    masks = np.stack([load_mask(p) for p in glob_imgs(os.path.join(scan, "mask"))])
    Ps = np.stack([cams[f"world_mat_{i}"][:3, :4].astype(np.float64)
                   for i in range(N_VIEWS)])
    return scan, masks, Ps


def _numpy_refine_votes(masks, Ps, scale, center, grid):
    """The JAX module's refine_visual_hull carve (:150-164), as numpy."""
    V, H, W = masks.shape
    axs = np.linspace(-scale, scale, grid)
    X, Y, Z = np.meshgrid(axs, axs, axs)
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()]) + center[:, None]
    pts_h = np.concatenate([pts, np.ones((1, pts.shape[1]))], axis=0)
    appears = np.zeros(pts.shape[1], dtype=np.int32)
    for i in range(V):
        proj = Ps[i] @ pts_h
        z = proj[2]
        xy = np.round(proj[:2] / np.where(np.abs(z) < 1e-12, 1e-12, z)).astype(np.int64)
        ok = (xy[0] >= 0) & (xy[0] < W) & (xy[1] >= 0) & (xy[1] < H) & (z > 0)
        idx = np.where(ok)[0]
        inside = masks[i][xy[1, idx], xy[0, idx]]
        appears[idx[inside]] += 1
    return pts, appears


def _numpy_hull_votes(masks, Ps, grid, extent=6.0):
    """The JAX module's visual_hull_scale carve (:189-201), as numpy."""
    V, H, W = masks.shape
    axs = np.linspace(-extent, extent, grid)
    X, Y, Z = np.meshgrid(axs, axs, axs, indexing="ij")
    pts = np.stack([X, Y, Z, np.ones_like(X)], axis=-1).reshape(-1, 4)
    votes = np.zeros(len(pts), dtype=np.int32)
    for v in range(V):
        proj = pts @ Ps[v].T
        z = proj[:, 2]
        x = proj[:, 0] / np.where(np.abs(z) < 1e-9, 1e-9, z)
        y = proj[:, 1] / np.where(np.abs(z) < 1e-9, 1e-9, z)
        inside = (z > 0) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
        xi = np.clip(x.astype(np.int64), 0, W - 1)
        yi = np.clip(y.astype(np.int64), 0, H - 1)
        votes += (inside & masks[v, yi, xi]).astype(np.int32)
    return pts[:, :3], votes


def test_epipolar_bounds_equal_jax(scan):
    _, masks, Ps = scan
    for mp_got, mp_want in zip(pc.mask_points(masks), jpc.mask_points(masks)):
        np.testing.assert_array_equal(mp_got, mp_want)
    got = pc.epipolar_depth_bounds(Ps, pc.mask_points(masks), n_points=100, view_stride=2,
                                   seed=3)
    want = jpc.epipolar_depth_bounds(Ps, jpc.mask_points(masks), n_points=100,
                                     view_stride=2, seed=3)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[2]) > 20


@pytest.mark.parametrize("grid", [48, 100])
def test_refine_votes_and_hull_match_jax(scan, grid):
    """The carve at ``grid``^3 voxels (100: the default, 1,000,000)."""
    _, masks, Ps = scan
    center, scale, _ = jpc.epipolar_depth_bounds(Ps, jpc.mask_points(masks), n_points=100)
    pts, votes = pc.refine_votes(masks, Ps, scale, center, grid=grid, device="cpu")
    want_pts, want_votes = _numpy_refine_votes(masks, Ps, scale, center, grid)
    assert votes.dtype == torch.int32 and pts.dtype == torch.float64
    np.testing.assert_array_equal(pts.numpy(), want_pts)
    np.testing.assert_array_equal(votes.numpy(), want_votes)
    assert 0 < (want_votes >= N_VIEWS).sum() < grid ** 3

    got_c, got_s = pc.refine_visual_hull(masks, Ps, scale, center, grid=grid, device="cpu")
    want_c, want_s = jpc.refine_visual_hull(masks, Ps, scale, center, grid=grid)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-9)


def test_hull_votes_and_scale_match_jax(scan):
    _, masks, Ps = scan
    pts, votes = pc.hull_votes(masks, Ps, grid=64, device="cpu")
    want_pts, want_votes = _numpy_hull_votes(masks, Ps, 64)
    np.testing.assert_array_equal(pts.numpy(), want_pts)
    np.testing.assert_array_equal(votes.numpy(), want_votes)
    assert 0 < (want_votes >= N_VIEWS).sum()

    got_c, got_r = pc.visual_hull_scale(masks, Ps, masks.shape[1:], grid=64, device="cpu")
    want_c, want_r = jpc.visual_hull_scale(masks, Ps, masks.shape[1:], grid=64)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-9)


@pytest.mark.parametrize("method,linear_init", [("hull", False), ("epipolar", False),
                                                ("epipolar+hull", False),
                                                ("epipolar+hull", True)])
def test_compute_scale_mats_matches_jax(scan, method, linear_init):
    """Both writers on the same scan (each writes ``cameras*_new.npz`` in
    place; JAX's is read before the port's overwrites it)."""
    path, _, _ = scan
    want_path = jpc.compute_scale_mats(path, grid=48, use_linear_init=linear_init,
                                       method=method)
    want = dict(np.load(want_path))
    os.remove(want_path)
    got_path = pc.main(["--source_dir", path, "--grid", "48", "--method", method,
                        "--platform", "cpu"] + (["--use_linear_init"] if linear_init else []))
    assert got_path == want_path
    got = dict(np.load(got_path))
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("world_mat"):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
    if method == "epipolar+hull":  # the reference's pipeline fits the cube in the unit sphere
        sm = got["scale_mat_0"]
        corner = np.array([0.35, 0.35, 0.35])
        assert np.linalg.norm((corner - sm[:3, 3]) / sm[0, 0]) < 1.0


# ---------------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------------

def _write_colmap_model(sparse, rng):
    """cameras.bin (a PINHOLE and a SIMPLE_RADIAL), images.bin (three
    images with 2D points, listed out of name order) and points3D.bin."""
    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48) + struct.pack("<4d", 70.0, 72.0, 32.0, 24.0))
        f.write(struct.pack("<iiQQ", 2, 2, 64, 48) + struct.pack("<4d", 66.0, 31.5, 23.5, 0.01))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for iid, name, cam in ((3, "img_002.png", 1), (1, "img_000.png", 2), (2, "img_001.png", 1)):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i", iid) + struct.pack("<4d", *q)
                    + struct.pack("<3d", *rng.normal(size=3)) + struct.pack("<i", cam))
            f.write(name.encode() + b"\x00")
            n2d = int(rng.integers(1, 5))
            f.write(struct.pack("<Q", n2d))
            for _ in range(n2d):
                f.write(struct.pack("<ddq", *rng.normal(size=2), int(rng.integers(0, 40))))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 40))
        for pid in range(40):
            f.write(struct.pack("<Q", pid) + struct.pack("<3d", *rng.normal(size=3))
                    + bytes(rng.integers(0, 255, 3).tolist()) + struct.pack("<d", 0.5))
            tl = int(rng.integers(0, 4))
            f.write(struct.pack("<Q", tl) + b"\x01" * (8 * tl))


def test_colmap_reader_and_cameras_npz_match_jax(tmp_path):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap_model(sparse, np.random.default_rng(0))
    cams, imgs, pts = read_model.read_model(sparse)
    jcams, jimgs, jpts = j_read_model.read_model(sparse)
    np.testing.assert_array_equal(pts, jpts)
    assert pts.shape == (40, 3)
    assert sorted(cams) == sorted(jcams) == [1, 2]
    for cid in cams:
        a, b = cams[cid], jcams[cid]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.K(), b.K())
    assert sorted(imgs) == sorted(jimgs) == [1, 2, 3]
    for iid in imgs:
        a, b = imgs[iid], jimgs[iid]
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
        np.testing.assert_array_equal(a.R(), b.R())
        np.testing.assert_array_equal(a.tvec, b.tvec)

    got = gen_cameras.colmap_to_cameras_npz(sparse, str(tmp_path / "port" / "cameras.npz"))
    want = j_gen_cameras.colmap_to_cameras_npz(sparse, str(tmp_path / "jax" / "cameras.npz"))
    got, want = dict(np.load(got)), dict(np.load(want))
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # images in name order: world_mat_0 is img_000's K [R | t]
    im0 = imgs[1]
    np.testing.assert_allclose(got["world_mat_0"][:3, :4],
                               cams[2].K() @ np.concatenate([im0.R(), im0.tvec[:, None]], 1))
