#!/usr/bin/env python3
"""One fused SDF-MLP kernel variant (f32 or bf16 weights) at the tracer's call
sizes: every cluster size, against other versions of its source and the
cuBLAS chain, and the time of one full wave of clusters of each size.

    python3 scripts/bench_fused_mlp_f32.py [--dtype f32|bf16] [--other OTHER.cu ...]
        [--variant NAME ...] [--n 256 2048 ...]

Builds the current ``hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu``,
each ``--other`` source and each ``--variant`` (a copy of the current source
with one constant of the variant's kernel changed, or one part taken out, by
a text substitution inside its namespace, ``f32`` or ``bf16k``; see
``VARIANTS``) into ``build/bench_<dtype>/`` (one ``nvcc`` each, all started
together).  A source whose C interface for the variant has no cluster
argument (a kernel before clusters) is called as it is, with one CTA a
tile; a source with one is called at every cluster size and at the size its
own occupancy query and ``fused_mlp.cluster_size`` (with the variant's
``WAVE_MS``) choose ("auto").  On the flagship's SDF network (d_in 59,
random weights from seed 0) and seeded points at each N:

  - every version and cluster size is held against the plain twin (the
    card's tolerance: f32 1e-5, bf16 3e-2 with signs where |sdf| > 5e-2),
    and compared bit for bit with the current source's C = 1 output;
  - each is timed with CUDA events (warm L2, mean of ``--iters`` launches)
    in two passes, the versions in opposite orders (others, current; then
    current, others), beside the cuBLAS chain and the plain twin.

Then each clustered version's ``wave_ms``: the time of a call of exactly one
full wave of clusters of C (slots[C] / C tiles), and of four waves over
four, in two passes.  Prints the card's name and power limit, each
version's registers and spills from ``-Xptxas -v``, the current source's
slots per (K0, C), and one JSON line per (version, C, N).  Needs one CUDA
card; imports nothing of JAX.
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
from hashmodnffbanks_idr_tpu_torch.utils.compile_cache import nvcc  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.utils.profiling import (  # noqa: E402
    H100_PEAK_BYTES_PER_S, H100_PEAK_FLOPS)

# per weight type: the variant's entry point, its namespace in the source
# and its mangled kernel name, its tolerance against the plain twin, the
# peak and products per product of its bound, and its calls: the camera
# step's (256 rays), the secant (2048), the march and line search (4096),
# the exact sweep's coarse and fine probes (24576, 49152), the ngp cells'
# and the mixed sweep's coarse probes (69632)
DTYPES = {"f32": dict(name="fused_sdf_raw_f32", namespace="f32", dtype=torch.float32,
                      mangled="3f3216fused_sdf_kernel", tol=1e-5, peak="tf32", products=3,
                      sizes=(256, 2048, 4096, 24576, 49152)),
          "bf16": dict(name="fused_sdf_raw_bf16", namespace="bf16k", dtype=torch.bfloat16,
                       mangled="5bf16k16fused_sdf_kernel", tol=3e-2, peak="bf16", products=1,
                       sizes=(256, 2048, 4096, 69632))}
D_IN = 59  # the flagship's first-layer width: K0 = 64
# variants of the current source, by weight type: (pattern, replacement)
# pairs applied inside the variant's namespace, every pattern must match.
# The constants of the cluster split and the ring keep the math; the others
# take a part out and are for timing only
F32_VARIANTS = {
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
# the bf16 kernel's parts, each taken out by itself (timing only)
_BF16_PARTS = {
    # bias and rounding stay; softplus becomes the identity
    "softplus": [(r"softplus100\((acc\[mi\]\[ni\]\[2 \* half(?: \+ 1)?\] \+ b\.[xy])\)",
                  r"(\1)")],
    # fragments come from the address registers instead of ldmatrix
    "ldmatrix": [(r'asm volatile\("ldmatrix\.sync\.aligned\.m8n8\.x4\.shared\.b16.*?\);',
                  "r[0] = r[1] = r[2] = r[3] = addr;"),
                 (r'asm volatile\("ldmatrix\.sync\.aligned\.m8n8\.x4\.trans\.shared\.b16.*?\);',
                  "r0 = r1 = r2 = r3 = addr;")],
    # the ring is never filled
    "weight_copy": [(r"cp_async16\(dst \+ r \* S::LDW, .*?\);", ";")],
}
_BF16_STAGES = r"static constexpr int STAGES = 2;"
BF16_VARIANTS = {
    # four ring stages at C = 2 and 4
    "stages4": [(_BF16_STAGES, "static constexpr int STAGES = C == 1 ? 2 : 4;")],
    # 32-row stages, four of them
    "kc32": [(r"constexpr int KC = 64;", "constexpr int KC = 32;"),
             (_BF16_STAGES, "static constexpr int STAGES = 4;")],
    # sixteen warps a CTA at C = 1 and 2 (64 x 32 and 64 x 16 a warp)
    "warps16": [(r"static constexpr int NT = 256;",
                 "static constexpr int NT = C == 4 ? 256 : 512;")],
    # two CTAs an SM at C = 4 (128 registers a thread)
    "c4_two_ctas": [(r"__launch_bounds__\(Split<C>::NT, 1\)",
                     "__launch_bounds__(Split<C>::NT, C == 4 ? 2 : 1)")],
    # timing only: no store into another CTA's tile
    "no_dsmem": [(r'asm volatile\("st\.shared::cluster\.v4\.b32.*?: "memory"\);', ";")],
    # timing only: each mma.sync becomes one float add that reads its operands
    "no_mma": [(r'asm\("mma\.sync.*?"r"\(b\[1\]\)\);',
                "c[0] += __uint_as_float(a[0] ^ b[0]);")],
    "no_softplus": _BF16_PARTS["softplus"],
    "no_ldmatrix": _BF16_PARTS["ldmatrix"],
    "no_weight_copy": _BF16_PARTS["weight_copy"],
    # timing only: the products, the barriers and the stores alone
    "mma_only": sum(_BF16_PARTS.values(), []),
}
VARIANTS = {"f32": F32_VARIANTS, "bf16": BF16_VARIANTS}
KEEPS_MATH = ("kc16", "ring4", "unroll1", "nt512", "warps_alt", "stages4", "kc32", "warps16",
              "c4_two_ctas")


def variant_source(src: str, namespace: str, subs) -> str:
    head, sep, body = src.partition(f"namespace {namespace} {{")
    body, sep2, tail = body.partition(f"}}  // namespace {namespace}")
    if not sep or not sep2:
        raise ValueError(f"no namespace {namespace} in the source")
    for pat, repl in subs:
        body, k = re.subn(pat, repl, body, flags=re.S)
        if k == 0:
            raise ValueError(f"pattern {pat!r} not found")
    return head + sep + body + sep2 + tail


def build_all(sources, out_dir: Path):
    """{name: path} -> {name: (library, ptxas report)}, all nvcc runs in
    parallel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
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


def kernel_ptxas(log: str, mangled: str) -> dict:
    """Registers and spill bytes of each instantiation of the kernel named
    ``mangled`` in a ``-Xptxas -v`` report, by its template arguments."""
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(mangled + r"I((?:Li\d+E)+)E", entry)
        if not m:
            continue
        args = ",".join(re.findall(r"Li(\d+)E", m.group(1)))
        regs = re.search(r"Used (\d+) registers", entry)
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry)]
        out[args] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_bytes": sum(spills)}
    return out


def bind(path: Path, name: str):
    """The library's entry ``name`` and its occupancy query, or None where
    the entry takes no cluster size."""
    lib = ctypes.CDLL(str(path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    slots = getattr(lib, f"{name}_slots", None)
    fn = getattr(lib, name)
    fn.argtypes = [ptr, c_int, c_int, c_int] + ([c_int] if slots else []) + [ptr] * 8
    fn.restype = c_int
    if slots:
        slots.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
        slots.restype = c_int
    return fn, slots


def lib_slots(query, k0: int) -> dict:
    slots = {}
    for c in fm.CLUSTER_SIZES:
        got = ctypes.c_int(0)
        err = query(k0, c, ctypes.byref(got))
        if err:
            raise RuntimeError(f"occupancy query K0={k0} C={c}: CUDA error {err}")
        slots[c] = got.value
    return slots


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                    help="the kernel variant: f32 or bf16 weights")
    ap.add_argument("--other", action="append", default=[],
                    help="another version of fused_mlp.cu, built and timed as it is")
    ap.add_argument("--variant", action="append", default=[],
                    help="a variant of the current source (VARIANTS of --dtype)")
    ap.add_argument("--n", type=int, nargs="+", help="call sizes (default: the variant's)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    spec, variants = DTYPES[args.dtype], VARIANTS[args.dtype]
    unknown = sorted(set(args.variant) - set(variants))
    if unknown:
        ap.error(f"--variant {unknown}: {args.dtype} has {sorted(variants)}")
    if not torch.cuda.is_available():
        print("bench_fused_mlp_f32: CUDA is not available", file=sys.stderr)
        return 2
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    out_dir = ROOT / "build" / f"bench_{args.dtype}"
    sources = {"current": fm._CSRC}
    for path in args.other:
        sources[Path(path).stem] = Path(path)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in args.variant:
        path = out_dir / f"{name}.cu"
        path.write_text(variant_source(fm._CSRC.read_text(), spec["namespace"], variants[name]))
        sources[name] = path
    built = build_all(sources, out_dir)
    libs = {}
    for name, (path, log) in built.items():
        libs[name] = bind(path, spec["name"])
        print(json.dumps({"version": name, "clustered": libs[name][1] is not None,
                          "ptxas": kernel_ptxas(log, spec["mangled"])}))
    slots = {k0: lib_slots(libs["current"][1], k0) for k0 in fm.KERNEL_DEPTHS}
    print(json.dumps({"slots": slots}))

    net = IDRNetwork(flagship_conf(num_pixels=2048).get_config("model"), device=dev,
                     seed=0).implicit_network
    assert net.dims[0] == D_IN
    k0 = fm.kernel_depth(D_IN)
    packed = fm.pack_params(net.lin, D_IN, net.dims[1], dtype=spec["dtype"])
    pointers = [packed[k].data_ptr() for k in ("w_in", "b_in", "w_mid", "b_mid", "w_out",
                                               "b_out")]
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(1)
    wave_ms = fm.WAVE_MS[spec["name"]]

    # (version, C) -> (entry, its slots); C is "auto", 1, 2, 4, or None (no
    # cluster interface)
    entries = {}
    for name, (fn, query) in libs.items():
        if query is None:
            entries[(name, None)] = (fn, None)
            continue
        own = lib_slots(query, k0)
        for c in ("auto",) + fm.CLUSTER_SIZES:
            entries[(name, c)] = (fn, own)

    def launcher(key, x, out):
        (fn, own), n = entries[key], x.shape[0]
        if key[1] is None:
            extra = []
        elif key[1] == "auto":
            extra = [fm.cluster_size(n, own, wave_ms)]
        else:
            extra = [key[1]]

        def call():
            err = fn(x.data_ptr(), n, D_IN, k0, *extra, *pointers, out.data_ptr(), stream)
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

    def embedded(n):
        pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
        with torch.no_grad():
            return net._embed(pts).contiguous()

    others = [k for k in entries if k[0] != "current"]
    mine = [k for k in entries if k[0] == "current"]
    for n in args.n or spec["sizes"]:
        x = embedded(n)
        with torch.no_grad():
            want = fm.fused_sdf_raw_plain(x, packed)
        big = want.abs() > 5e-2
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
        flops, nbytes = sdf_mlp_cost(n, D_IN, net.dims[1], packed["w_in"].element_size())
        bound_ms = max(spec["products"] * flops / H100_PEAK_FLOPS[spec["peak"]],
                       nbytes / H100_PEAK_BYTES_PER_S) * 1e3
        for key in entries:
            err = float((outs[key] - want).abs().max())
            signs = bool((torch.sign(outs[key][big]) == torch.sign(want[big])).all())
            rec = {"version": key[0], "cluster": key[1], "n": n, "launched_cluster": calls[key][1],
                   "keeps_math": key[0] not in variants or key[0] in KEEPS_MATH,
                   "ms": ms[key], "library_ms": lib_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "max_abs_err": err,
                   "within_tol": bool(err <= spec["tol"]) and not math.isnan(err) and signs,
                   "bit_equal_to_current_c1": bool(torch.equal(outs[key].view(torch.int32), ref))}
            print(json.dumps(rec))

    # wave_ms: one full wave of clusters of C, and four waves over four
    for name, (fn, own) in {k[0]: v for k, v in entries.items() if k[1] == 1}.items():
        rec = {"version": name, "slots": own, "wave_ms": {}, "four_waves_ms_per_wave": {}}
        for c in fm.CLUSTER_SIZES:
            if own[c] < c:
                continue
            for waves, field in ((1, "wave_ms"), (4, "four_waves_ms_per_wave")):
                n = waves * own[c] // c * fm.TILE
                x, out = embedded(n), torch.empty(n, device=dev)
                call, _ = launcher((name, c), x, out)
                rec[field][c] = [time_ms(call) / waves for _ in range(2)]
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
