#!/usr/bin/env python3
"""Time the decode of a DTU-size scan three ways: serially, in worker
processes (``data/native_loader.py``, what ``SceneDataset`` runs) and in
threads (the same per-view decode in a thread pool: the comparison that
chose processes, whose numbers PERF.md keeps).

Run from the repository root:

    python3 scripts/time_scene_decode.py [--views 49] [--res 1200 1600]

It writes the scan of ``chip_smoke.py``'s ``[decode]`` phase (distinct
views, every row Paeth-filtered) into a temporary directory, checks that
the three decodes are equal, and prints one JSON line of seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hashmodnffbanks_idr_tpu_torch.data import native_loader  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.data.image_io import load_rgb  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import glob_imgs  # noqa: E402


def decode_threads(images, masks, n_workers):
    """The views decoded in a pool of ``n_workers`` threads, in order."""
    def one(paths):
        image_path, mask_path = paths
        return load_rgb(image_path).reshape(-1, 3), native_loader.load_mask(mask_path).reshape(-1)

    with ThreadPoolExecutor(n_workers) as ex:
        views = list(ex.map(one, zip(images, masks)))
    return np.stack([v[0] for v in views]), np.stack([v[1] for v in views])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--views", type=int, default=49)
    p.add_argument("--res", type=int, nargs=2, default=(1200, 1600))
    args = p.parse_args(argv)
    from chip_smoke import write_decode_view

    res = tuple(args.res)
    n = native_loader.default_workers(args.views)
    with tempfile.TemporaryDirectory() as tmp:
        scan = os.path.join(tmp, "scan0")
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(scan, sub))
        with ThreadPoolExecutor(n) as ex:  # zlib.compress releases the GIL for the most part
            list(ex.map(lambda i: write_decode_view(scan, i, res), range(args.views)))
        images, masks = (glob_imgs(os.path.join(scan, sub)) for sub in ("image", "mask"))
        rec = {"views": args.views, "res": list(res), "workers": n}
        out = {}
        for name, fn in (("serial", lambda: native_loader.load_scene_native(
                              images, masks, res, workers="serial")),
                         ("processes", lambda: native_loader.load_scene_native(
                              images, masks, res, workers="process")),
                         ("threads", lambda: decode_threads(images, masks, n))):
            t0 = time.perf_counter()
            out[name] = fn()
            rec[f"{name}_s"] = time.perf_counter() - t0
        for name in ("processes", "threads"):
            for a, b in zip(out[name], out["serial"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"the {name} decode differs from the serial one")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
