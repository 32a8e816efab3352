"""Parallel scene decode: the views' images and masks in worker processes.

Counterpart of ``hashmodnffbanks_idr_tpu/data/native_loader.py``, which
decodes through OpenCV in the multithreaded ``native/scene_loader.cpp``.
The port has no OpenCV: its decoder is ``data/image_io.py`` (numpy +
zlib), whose Paeth and Average rows are undone along anti-diagonals in many
small numpy calls that hold the GIL.  So the views are decoded in worker
processes, each a fresh interpreter that runs this module alone (numpy and
zlib, no torch) on every ``n_workers``-th view and writes its pixels into
one memory-mapped file in the temporary directory; no pixel is pickled.
(Threads lose to the serial decode: PERF.md §6, from
``scripts/time_scene_decode.py``.)
The result equals the serial decode bit for bit, in view order; a worker's
failure raises its error.
"""

from __future__ import annotations

import builtins
import json
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .image_io import load_gray, load_rgb

# Below this many pixels over all views a scan decodes serially: starting
# the workers costs more than a small scan's serial decode.
MIN_PARALLEL_PIXELS = 1 << 22
_ROOT = Path(__file__).resolve().parents[2]
_ERRORS = (ValueError, OSError, KeyError)   # re-raised as themselves


def load_mask(path: str) -> np.ndarray:
    return load_gray(path) > 127.5  # rend_util.py:18-23


def _checked(img: np.ndarray, path: str, img_res: Tuple[int, int]) -> np.ndarray:
    if img.shape[:2] != tuple(img_res):
        raise ValueError(f"{path} is {img.shape[:2]}, the conf says img_res={tuple(img_res)}")
    return img


def _views(buf: np.ndarray, V: int, H: int, W: int):
    """The (V, H*W, 3) uint8 RGB and (V, H*W) bool mask arrays over the flat
    uint8 ``buf`` of V*H*W*4 bytes."""
    n = V * H * W
    return buf[:3 * n].reshape(V, H * W, 3), buf[3 * n:].view(np.bool_).reshape(V, H * W)


def _decode_into(rgb: np.ndarray, mask: np.ndarray, i: int, image_path: str,
                 mask_path: str, img_res) -> None:
    rgb[i] = _checked(load_rgb(image_path), image_path, img_res).reshape(-1, 3)
    mask[i] = _checked(load_mask(mask_path), mask_path, img_res).reshape(-1)


def default_workers(n_views: int) -> int:
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # not on Linux
        cores = os.cpu_count() or 1
    return max(1, min(n_views, cores))


def load_scene_native(image_paths: List[str], mask_paths: List[str],
                      img_res: Tuple[int, int], n_workers: int = 0,
                      workers: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb (V, H*W, 3) uint8, mask (V, H*W) bool) of the views, in order.

    ``n_workers`` 0 takes one a core (at most one a view); ``workers`` is
    'process' or 'serial' (None: 'serial' for a scan of fewer than
    ``MIN_PARALLEL_PIXELS`` pixels or one worker, else 'process').  Raises
    if a file is missing, unreadable or not ``img_res``."""
    if len(image_paths) != len(mask_paths) or not image_paths:
        raise ValueError(f"{len(image_paths)} images and {len(mask_paths)} masks; "
                         "expected the same non-zero number")
    missing = [p for p in list(image_paths) + list(mask_paths) if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(f"no such file: {missing[0]}"
                                + (f" (and {len(missing) - 1} more)" if len(missing) > 1 else ""))
    H, W = img_res
    V = len(image_paths)
    n_workers = min(n_workers or default_workers(V), V)
    if workers is None:
        small = V * H * W < MIN_PARALLEL_PIXELS
        workers = "serial" if small or n_workers == 1 else "process"
    if workers == "serial":
        rgb, mask = _views(np.zeros(V * H * W * 4, np.uint8), V, H, W)
        for i, (ip, mp) in enumerate(zip(image_paths, mask_paths)):
            _decode_into(rgb, mask, i, ip, mp, img_res)
        return rgb, mask
    if workers != "process":
        raise ValueError(f"workers={workers!r}; expected 'process' or 'serial'")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scan.u8")
        with open(out, "wb") as f:
            f.truncate(V * H * W * 4)
        # one thread each: the decode calls no BLAS, and a BLAS pool a worker
        # costs start-up time
        env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join([str(_ROOT)] + [p for p in (env.get("PYTHONPATH"),) if p])
        procs = []
        try:
            for k in range(n_workers):
                jobs = [(i, str(image_paths[i]), str(mask_paths[i])) for i in range(k, V, n_workers)]
                p = subprocess.Popen([sys.executable, "-m", __name__, out, str(V), str(H), str(W)],
                                     stdin=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                                     text=True)
                procs.append(p)
                p.stdin.write(json.dumps(jobs))
                p.stdin.close()
            for p in procs:
                err = p.stderr.read()
                if p.wait() != 0:
                    _raise_worker_error(err, p.returncode)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rgb, mask = _views(np.fromfile(out, dtype=np.uint8), V, H, W)
    return rgb, mask


def _raise_worker_error(stderr: str, code: int) -> None:
    """A worker's error again in the caller: its last stderr line is
    ``{"type": ..., "message": ...}``; ValueError, OSError (and its
    subclasses) and KeyError keep their type, anything else is a
    RuntimeError with the worker's traceback."""
    lines = stderr.strip().splitlines()
    try:
        info = json.loads(lines[-1])
        cls = getattr(builtins, info["type"], None)
    except (IndexError, ValueError, KeyError, TypeError):
        info, cls = {"message": stderr}, None
    if isinstance(cls, type) and issubclass(cls, _ERRORS):
        raise cls(info["message"])
    raise RuntimeError(f"a decode worker failed (exit {code}):\n{stderr}")


def _worker_main(argv: List[str]) -> int:
    """A worker: ``python -m <this module> OUT V H W`` with a JSON list of
    ``[view, image path, mask path]`` on stdin; decodes them into the
    memory-mapped ``OUT``.  On an error it prints the traceback and a last
    line ``{"type", "message"}`` to stderr and exits 1."""
    out, V, H, W = argv[0], *map(int, argv[1:4])
    try:
        jobs = json.loads(sys.stdin.read())
        buf = np.memmap(out, dtype=np.uint8, mode="r+", shape=(V * H * W * 4,))
        rgb, mask = _views(buf, V, H, W)
        for i, image_path, mask_path in jobs:
            _decode_into(rgb, mask, i, image_path, mask_path, (H, W))
        buf.flush()
    except Exception as e:  # reported to the caller, which raises it again
        traceback.print_exc()
        print(json.dumps({"type": type(e).__name__, "message": str(e)}), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
