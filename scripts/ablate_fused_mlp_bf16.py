#!/usr/bin/env python3
"""What bounds the bf16 fused SDF-MLP kernel on the card: an ablation.

    python3 scripts/ablate_fused_mlp_bf16.py [--source OTHER.cu ...]

Builds variants of ``hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu``
into ``build/ablate/`` (one ``nvcc`` each, all started together).  Each
variant takes one part of the bf16 kernel out, or changes one of its
constants, by a text substitution inside ``namespace bf16k`` of a copy; the
shipped source is not changed.  Every ``--source`` file is built as it is,
for a comparison with another version of the kernel with the same C
interface.  Then it times each
variant's ``fused_sdf_raw_bf16`` with CUDA events at N=2048 and 4096 (one
wave of blocks) and N=69632 (the mixed tracer's largest call), on the same
weights and inputs, in two passes in opposite orders, and prints one JSON
line per variant: registers and spills from ``-Xptxas -v``, ms per pass,
and the max abs error against the plain twin (meaningful only for variants
that keep the math).  The card's name and power limit come first.  Needs one CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hashmodnffbanks_idr_tpu_torch import resolve_device  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf  # noqa: E402

OUT_DIR = ROOT / "build" / "ablate"
SIZES = (2048, 4096, 69632)
# the flagship's first-layer depth (d_in 59): the kernel instantiation timed
DEPTH = fm.kernel_depth(59)

# each ablation: (pattern, replacement) pairs, applied inside namespace bf16k;
# every pattern must match
ABLATIONS = {
    # bias and rounding stay; softplus becomes the identity
    "softplus": [(r"softplus100\((acc\[mi\]\[ni\]\[2 \* half(?: \+ 1)?\] \+ b\.[xy])\)",
                  r"(\1)")],
    # each mma.sync becomes one float add that still reads its fragments
    "mma": [(r'asm\("mma\.sync\.aligned\.m16n8k16.*?"r"\(b\[1\]\)\);',
             "c[0] += __uint_as_float(a[0] ^ b[0]);")],
    # fragments come from the address registers instead of ldmatrix
    "ldmatrix": [(r'asm volatile\("ldmatrix\.sync\.aligned\.m8n8\.x4\.shared\.b16.*?\);',
                  "r[0] = r[1] = r[2] = r[3] = addr;"),
                 (r'asm volatile\("ldmatrix\.sync\.aligned\.m8n8\.x4\.trans\.shared\.b16.*?\);',
                  "r0 = r1 = r2 = r3 = addr;")],
    # no block barriers around the epilogues: racy, timing only
    "layer_barrier": [(r"__syncthreads\(\);  // every warp has loaded", "// every warp has loaded"),
                      (r"__syncthreads\(\);  // the new tile", "// the new tile")],
    # the ring is never filled
    "weight_copy": [(r"cp_async16\(dst \+ r \* LDW, .*?\);", ";")],
    # constants of the ring
    "kc32_stages3": [(r"constexpr int KC = 64;", "constexpr int KC = 32;"),
                     (r"constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "kc32_stages4": [(r"constexpr int KC = 64;", "constexpr int KC = 32;"),
                     (r"constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    # sixteen warps of 64 x 32 (a 128-register cap) instead of eight of 64 x 64
    "warps16": [(r"constexpr int NT = 256;", "constexpr int NT = 512;")],
}
VARIANTS = {
    "base": [],
    "no_softplus": ["softplus"],
    "no_mma": ["mma"],
    "no_ldmatrix": ["ldmatrix"],
    "no_layer_barrier": ["layer_barrier"],
    "no_weight_copy": ["weight_copy"],
    "mma_only": ["ldmatrix", "softplus", "layer_barrier", "weight_copy"],
    "kc32_stages3": ["kc32_stages3"],
    "kc32_stages4": ["kc32_stages4"],
    "warps16": ["warps16"],
}
KEEPS_MATH = ("base", "kc32_stages3", "kc32_stages4", "warps16")


def variant_source(src: str, ablations) -> str:
    head, sep, body = src.partition("namespace bf16k {")
    if not sep:
        raise ValueError("no namespace bf16k in the source")
    for name in ablations:
        for pat, repl in ABLATIONS[name]:
            body, k = re.subn(pat, repl, body, flags=re.S)
            if k == 0:
                raise ValueError(f"ablation {name}: pattern {pat!r} not found")
    return head + sep + body


def build_all(sources):
    """sources: {name: text} -> {name: (library path, ptxas report)}, all
    nvcc runs in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        lib = OUT_DIR / f"lib{name}.so"
        cmd = [fm._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, log)
    return built


def bf16_ptxas(log: str) -> dict:
    """Registers and spill bytes of the bf16k:: kernel at the timed inputs'
    first-layer depth (None where another version of the source names its
    kernel otherwise)."""
    entries = [e for e in log.split("Compiling entry function")[1:]
               if f"5bf16k16fused_sdf_kernelILi{DEPTH}E" in e]
    if not entries:
        return {"registers": None, "spill_bytes": None}
    entry = entries[0]
    regs = re.search(r"Used (\d+) registers", entry)
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry)]
    return {"registers": int(regs.group(1)) if regs else None, "spill_bytes": sum(spills)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="another version of fused_mlp.cu to time as it is")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_fused_mlp_bf16: CUDA is not available", file=sys.stderr)
        return 2
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    src = fm._CSRC.read_text()
    sources = {name: variant_source(src, abl) for name, abl in VARIANTS.items()}
    for path in args.source:
        sources[Path(path).stem] = Path(path).read_text()
    built = build_all(sources)

    ptr = ctypes.c_void_p
    fns = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(str(lib)).fused_sdf_raw_bf16
        fn.argtypes = [ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ptr] * 8
        fn.restype = ctypes.c_int
        fns[name] = fn

    net = IDRNetwork(flagship_conf(num_pixels=2048).get_config("model"), device=dev,
                     seed=0).implicit_network
    d_in, hidden = net.dims[0], net.dims[1]
    packed = fm.pack_params(net.lin, d_in, hidden, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = {}
    with torch.no_grad():
        for n in SIZES:
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            x = net._embed(pts).contiguous()
            inputs[n] = (x, fm.fused_sdf_raw_plain(x, packed), torch.empty(n, device=dev))

    def call(fn, n):
        x, _, out = inputs[n]
        err = fn(x.data_ptr(), n, d_in, DEPTH, packed["w_in"].data_ptr(),
                 packed["b_in"].data_ptr(),
                 packed["w_mid"].data_ptr(), packed["b_mid"].data_ptr(),
                 packed["w_out"].data_ptr(), packed["b_out"].data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def time_ms(fn, n):
        for _ in range(3):
            call(fn, n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            call(fn, n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    results = {name: {"variant": name, **bf16_ptxas(log), "ms": {n: [] for n in SIZES}}
               for name, (_, log) in built.items()}
    for name, fn in fns.items():
        errs = []
        for n in SIZES:
            call(fn, n)
            torch.cuda.synchronize()
            _, want, got = inputs[n]
            errs.append(float((got - want).abs().max()))
        results[name]["max_abs_err"] = max(errs)
        results[name]["keeps_math"] = name in KEEPS_MATH or name not in VARIANTS
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            for n in SIZES:
                results[name]["ms"][n].append(time_ms(fns[name], n))
    for name in order:
        print(json.dumps(results[name]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
