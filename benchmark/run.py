#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one cell a run:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for (``BENCHMARK.json``).  The last line of standard output is one
JSON object: ``correct``, ``attempted`` and ``failed`` (steps run in the
window, and those whose update the program skipped), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, each
number compared with the reference beside its limit (also the last lines
of standard error).  No result is printed, and the exit code is not 0,
when the cards are missing, when the port cannot be imported, or when JAX
or the JAX package is loaded in this process.

Caches stay inside the checkout, at fixed paths: the port's kernel builds
in ``build/`` (``HMNFFB_COMPILE_CACHE``), and ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` under it."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hashmodnffbanks_idr_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not read (exit {out.returncode})"


def _plain(x):
    """The result with non-finite numbers spelt as strings (JSON has none)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["HMNFFB_COMPILE_CACHE"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))

    from harness.spec import resolve

    cell = resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import hashmodnffbanks_idr_tpu_torch  # noqa: F401  (fails where the port is absent)
    from harness.driver import run_cell

    result = run_cell(cell, ROOT, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process, and not allowed: {', '.join(loaded)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    check = result.pop("check")
    result["check"] = check
    print(f"[device] {result['device']['kind']}, power limit {result['device']['power_limit']}",
          file=sys.stderr)
    for k, v in check.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
