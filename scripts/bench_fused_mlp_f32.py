#!/usr/bin/env python3
"""The f32 fused SDF-MLP kernel at the tracer's call sizes: every cluster size,
against other versions of its source and the cuBLAS chain.

    python3 scripts/bench_fused_mlp_f32.py [--other OTHER.cu ...] [--variant NAME ...]
        [--n 256 2048 ...]

Builds the current ``hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu``,
each ``--other`` source and each ``--variant`` (a copy of the current source
with one constant of the f32 kernel changed, or one part taken out, by a
text substitution inside ``namespace f32``; see ``VARIANTS``) into
``build/bench_f32/`` (one ``nvcc`` each, all started together).  A source whose C interface has no cluster argument (the
kernel before clusters) is called as it is, with one CTA a tile; a source
with one is called at every cluster size and at the size its own occupancy
query and ``fused_mlp.cluster_size`` choose ("auto").  On the flagship's SDF
network (d_in 59, random weights from seed 0) and seeded points at each N:

  - every version and cluster size is held against the plain twin (the
    card's f32 tolerance, 1e-5), and compared bit for bit with the current
    source's C = 1 output;
  - each is timed with CUDA events (warm L2, mean of ``--iters`` launches)
    in two passes, the versions in opposite orders (others, current; then
    current, others), beside the cuBLAS chain and the plain twin.

Prints the card's name and power limit, each version's registers and spills
from ``-Xptxas -v``, the current source's slots per (K0, C), and one JSON
line per (version, C, N).  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import library_chain, sdf_mlp_cost  # noqa: E402
from hashmodnffbanks_idr_tpu_torch import resolve_device  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.utils.profiling import (  # noqa: E402
    H100_PEAK_BYTES_PER_S, H100_PEAK_FLOPS)

OUT_DIR = ROOT / "build" / "bench_f32"
# the camera step's calls (256 rays), the secant (2048), the march and line
# search (4096), the exact sweep's coarse and fine probes (24576, 49152)
SIZES = (256, 2048, 4096, 24576, 49152)
TOL = 1e-5
D_IN = 59  # the flagship's first-layer width: K0 = 64
# variants of the current source: (pattern, replacement) pairs applied
# inside namespace f32, every pattern must match.  The constants of the
# cluster split and the ring keep the math; the others take a part out and
# are for timing only
VARIANTS = {
    # 16-row stages at C = 2 and 4 too, three of them
    "kc16": [(r"static constexpr int KC = C == 1 \? 16 : 32;", "static constexpr int KC = 16;"),
             (r"static constexpr int STAGES = C == 2 \? 2 : 3;",
              "static constexpr int STAGES = 3;")],
    # a fourth 32-row stage at C = 4
    "ring4": [(r"static constexpr int STAGES = C == 2 \? 2 : 3;",
               "static constexpr int STAGES = C == 2 ? 2 : (C == 4 ? 4 : 3);")],
    # one 8-deep k-step at a time at every C
    "unroll1": [(r"static constexpr int K_UNROLL = C == 1 \? 1 : 2;",
                 "static constexpr int K_UNROLL = 1;")],
    # 16 warps a CTA at C = 2 (2 x 8 of 32 x 32) and 4 (4 x 4 of 16 x 32)
    "nt512": [(r"static constexpr int NT = 256;", "static constexpr int NT = C == 1 ? 256 : 512;"),
              (r"static constexpr int WR = C == 1 \? 1 : 2;",
               "static constexpr int WR = C == 1 ? 1 : C;")],
    # the other warp layouts: 1 x 8 of 64 x 32 at C = 2, 4 x 2 of 16 x 64 at 4
    "warps_alt": [(r"static constexpr int WR = C == 1 \? 1 : 2;",
                   "static constexpr int WR = C == 1 ? 1 : (C == 2 ? 1 : 4);")],
    # timing only: no store into another CTA's tile
    "no_dsmem": [(r'asm volatile\("st\.shared::cluster\.v2\.f32.*?: "memory"\);', ";")],
    # timing only: each mma.sync becomes one float add that reads its operands
    "no_mma": [(r'asm\("mma\.sync.*?"f"\(0\.f\)\);',
                "c[0] = c[1] = c[2] = c[3] = __uint_as_float(a[0] ^ b[0]);"),
               (r'asm\("mma\.sync.*?"r"\(b\[1\]\)\);', "c[0] += __uint_as_float(a[1] ^ b[1]);")],
}
KEEPS_MATH = ("kc16", "ring4", "unroll1", "nt512", "warps_alt")


def variant_source(src: str, subs) -> str:
    head, sep, body = src.partition("namespace f32 {")
    body, sep2, tail = body.partition("}  // namespace f32")
    if not sep or not sep2:
        raise ValueError("no namespace f32 in the source")
    for pat, repl in subs:
        body, k = re.subn(pat, repl, body, flags=re.S)
        if k == 0:
            raise ValueError(f"pattern {pat!r} not found")
    return head + sep + body + sep2 + tail


def build_all(sources):
    """{name: path} -> {name: (library, ptxas report)}, all nvcc runs in
    parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = OUT_DIR / f"lib{name}.so"
        cmd = [fm._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib), str(path)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, log)
    return built


def f32_ptxas(log: str) -> dict:
    """Registers and spill bytes of each f32:: kernel instantiation in a
    ``-Xptxas -v`` report, by its template arguments."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(r"3f3216fused_sdf_kernelI((?:Li\d+E)+)E", entry)
        if not m:
            continue
        args = ",".join(re.findall(r"Li(\d+)E", m.group(1)))
        regs = re.search(r"Used (\d+) registers", entry)
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry)]
        out[args] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_bytes": sum(spills)}
    return out


def bind(path: Path):
    """The library's f32 entry and whether it takes a cluster size."""
    lib = ctypes.CDLL(str(path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    clustered = hasattr(lib, "fused_sdf_raw_f32_slots")
    fn = lib.fused_sdf_raw_f32
    fn.argtypes = [ptr, c_int, c_int, c_int] + ([c_int] if clustered else []) + [ptr] * 8
    fn.restype = c_int
    if clustered:
        lib.fused_sdf_raw_f32_slots.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
        lib.fused_sdf_raw_f32_slots.restype = c_int
    return lib, clustered


def lib_slots(lib, k0: int) -> dict:
    slots = {}
    for c in fm.CLUSTER_SIZES:
        got = ctypes.c_int(0)
        err = lib.fused_sdf_raw_f32_slots(k0, c, ctypes.byref(got))
        if err:
            raise RuntimeError(f"occupancy query K0={k0} C={c}: CUDA error {err}")
        slots[c] = got.value
    return slots


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another version of fused_mlp.cu, built and timed as it is")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="a variant of the current source (VARIANTS)")
    ap.add_argument("--n", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_fused_mlp_f32: CUDA is not available", file=sys.stderr)
        return 2
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    sources = {"current": fm._CSRC}
    for path in args.other:
        sources[Path(path).stem] = Path(path)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name in args.variant:
        path = OUT_DIR / f"{name}.cu"
        path.write_text(variant_source(fm._CSRC.read_text(), VARIANTS[name]))
        sources[name] = path
    built = build_all(sources)
    libs = {}
    for name, (path, log) in built.items():
        libs[name] = bind(path)
        print(json.dumps({"version": name, "clustered": libs[name][1],
                          "ptxas": f32_ptxas(log)}))
    cur = libs["current"][0]
    slots = {k0: lib_slots(cur, k0) for k0 in fm.KERNEL_DEPTHS}
    print(json.dumps({"slots": slots}))

    net = IDRNetwork(flagship_conf(num_pixels=2048).get_config("model"), device=dev,
                     seed=0).implicit_network
    assert net.dims[0] == D_IN
    k0 = fm.kernel_depth(D_IN)
    packed = fm.pack_params(net.lin, D_IN, net.dims[1], dtype=torch.float32)
    pointers = [packed[k].data_ptr() for k in ("w_in", "b_in", "w_mid", "b_mid", "w_out",
                                               "b_out")]
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(1)

    # (version, C) -> a launch writing out; C is "auto", 1, 2, 4, or None (no
    # cluster interface)
    entries = {}
    for name, (lib, clustered) in libs.items():
        if not clustered:
            entries[(name, None)] = (lib, None)
            continue
        own = lib_slots(lib, k0)
        entries[(name, "auto")] = (lib, own)
        for c in fm.CLUSTER_SIZES:
            entries[(name, c)] = (lib, c)

    def launcher(key, x, out):
        (lib, arg), n = entries[key], x.shape[0]
        if key[1] is None:
            extra = []
        elif key[1] == "auto":
            extra = [fm.cluster_size(n, arg)]
        else:
            extra = [arg]

        def call():
            err = lib.fused_sdf_raw_f32(x.data_ptr(), n, D_IN, k0, *extra, *pointers,
                                        out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{key}: launch failed: CUDA error {err}")
        return call, (extra[0] if extra else 1)

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    others = [k for k in entries if k[0] != "current"]
    mine = [k for k in entries if k[0] == "current"]
    for n in args.n:
        pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
        with torch.no_grad():
            x = net._embed(pts).contiguous()
            want = fm.fused_sdf_raw_plain(x, packed)
        outs = {key: torch.full((n,), float("nan"), device=dev) for key in entries}
        calls = {key: launcher(key, x, outs[key]) for key in entries}
        for key, (call, _) in calls.items():
            call()
        torch.cuda.synchronize()
        ref = outs[("current", 1)].view(torch.int32)
        ms = {key: [] for key in entries}
        lib_ms, plain_ms = [], []
        for order in (others + mine, mine + others):
            for key in order:
                ms[key].append(time_ms(calls[key][0]))
            with torch.no_grad():
                lib_ms.append(time_ms(lambda: library_chain(x, packed)))
                plain_ms.append(time_ms(lambda: fm.fused_sdf_raw_plain(x, packed)))
        flops, nbytes = sdf_mlp_cost(n, D_IN, net.dims[1], 4)
        bound_ms = max(3 * flops / H100_PEAK_FLOPS["tf32"], nbytes / H100_PEAK_BYTES_PER_S) * 1e3
        for key in entries:
            err = float((outs[key] - want).abs().max())
            rec = {"version": key[0], "cluster": key[1], "n": n, "launched_cluster": calls[key][1],
                   "keeps_math": key[0] not in VARIANTS or key[0] in KEEPS_MATH,
                   "ms": ms[key], "library_ms": lib_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "max_abs_err": err,
                   "within_tol": bool(err <= TOL) and not math.isnan(err),
                   "bit_equal_to_current_c1": bool(torch.equal(outs[key].view(torch.int32), ref))}
            print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
