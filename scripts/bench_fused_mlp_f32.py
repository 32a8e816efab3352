#!/usr/bin/env python3
"""One fused SDF-MLP kernel variant (f32 or bf16 weights) at the tracer's call
sizes: every cluster size, against other versions of its source and the
cuBLAS chain, and the time of one full wave of clusters of each size.

    python3 scripts/bench_fused_mlp_f32.py [--dtype f32|bf16] [--other OTHER.cu ...]
        [--other-wave-ms JSON] [--variant NAME ...] [--n 256 2048 ...]
        [--errors-d-in 59 102 198 510 --errors-n 4113 49152]

Builds the current ``hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu``,
each ``--other`` source and each ``--variant`` (a copy of the current source
with one constant of the variant's kernel changed, or one part taken out, by
a text substitution inside its namespace, ``f32`` or ``bf16k``; see
``VARIANTS``) into ``build/bench_<dtype>/`` (one ``nvcc`` each, all started
together; a version other than the current one that fails to build is
reported and left out).  Each version's C interface is read from its
source: a version whose entry for the variant has no cluster argument (a
kernel before clusters) is called as it is, with one CTA a 64-point tile;
one with a cluster argument is called at every cluster size its occupancy
query takes and at the size that query and ``fused_mlp.cluster_size``
choose ("auto"), with the variant's ``WAVE_MS`` (an ``--other`` source's:
``--other-wave-ms``, by C).  The current source and its variants run each C
on the tile of ``fused_mlp.TILES``, an ``--other`` source (the port's
kernels before the bf16 kernel's 128-point tiles) on 64-point tiles.  The
weights go to each entry in the order its parameters name them (``w_img``,
the bf16 kernel's weight stream, or ``w_in`` and ``w_mid``).  First, with
``--errors-d-in``, every version's error against the plain twin at each of
those first-layer widths (``chip_smoke.CHECK_D_IN``, input weights spread)
at ``--errors-n``, untimed.  Then on the flagship's SDF network (d_in 59,
random weights from seed 0) and seeded points at each N:

  - every version and cluster size is held against the plain twin (the
    card's tolerance: f32 1e-5, bf16 3e-2 with signs where |sdf| > 5e-2),
    and compared bit for bit with the current source's output at its
    smallest C;
  - each is timed with CUDA events (warm L2, mean of ``--iters`` launches)
    in two passes, the versions in opposite orders (others, current; then
    current, others), beside the cuBLAS chain and the plain twin.

Then each clustered version's ``wave_ms``: the time of a call of exactly one
full wave of clusters of C (slots[C] / C tiles of its tile at C), and of
four waves over four, in two passes.  Prints the card's name and power limit, each
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

from chip_smoke import (CHECK_D_IN, library_chain, sdf_mlp_cost,  # noqa: E402
                        spread_input_weights)
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
# the exact sweep's coarse and fine probes (24576, 49152; in bf16 the fast
# sweep's, 49152), the ngp cells' and the mixed sweep's coarse probes (69632)
DTYPES = {"f32": dict(name="fused_sdf_raw_f32", namespace="f32", dtype=torch.float32,
                      mangled="3f3216fused_sdf_kernel", tol=1e-5, peak="tf32", products=3,
                      sizes=(256, 2048, 4096, 24576, 49152, 69632)),
          "bf16": dict(name="fused_sdf_raw_bf16", namespace="bf16k", dtype=torch.bfloat16,
                       mangled="5bf16k16fused_sdf_kernel", tol=3e-2, peak="bf16", products=1,
                       sizes=(256, 2048, 4096, 24576, 49152, 69632))}
D_IN = 59  # the flagship's first-layer width: K0 = 64
# variants of the current source, by weight type: (pattern, replacement)
# pairs applied inside the variant's namespace, every pattern must match.
# Each takes a part out and is for timing only
F32_VARIANTS = {
    # timing only: no weight copies (the products read stale weights)
    "no_copy": [(r"cp_async16\(dst \+ 16 \* r, valid \? src \+ r \* HIDDEN : W, valid\);", ";")],
    # timing only: every copy reads the same 16 bytes a thread (L2 and L1
    # hits, no stream)
    "copy_same": [(r"cp_async16\(dst \+ 16 \* r, valid \? src \+ r \* HIDDEN : W, valid\);",
                   "cp_async16(dst + 16 * r, w_in + (threadIdx.x % 64) * 4, true);")],
    # timing only: no weight copies, no split, no A loads (A from one
    # column): the products, folds, barriers and epilogues alone
    "wgmma_only": [(r"cp_async16\(dst \+ 16 \* r, valid \? src \+ r \* HIDDEN : W, valid\);", ";"),
                   (r"split_block<C>\(bufs, c, block\);", ";"),
                   (r"load_a\(act, wq, g, t, k0 \+ 8 \* s, ah\[j\]\[s\], al\[j\]\[s\]\);",
                    "load_a(act, wq, g, t, 0, ah[j][s], al[j][s]);")],
    # timing only: no split of the weights (the products read stale hi and
    # lo)
    "no_split": [(r"split_block<C>\(bufs, c, block\);", ";")],
}
# the bf16 kernel's parts, each taken out by itself (timing only)
_BF16_PARTS = {
    # bias and rounding stay; softplus becomes the identity
    "softplus": [(r"softplus100\((acc\[i\]\[2 \* half(?: \+ 1)?\] \+ b\.[xy])\)", r"(\1)")],
    # the ring is never filled: the producer's bulk copies are not issued and
    # each `full` mbarrier expects no bytes
    "weight_copy": [(r'"r"\(S::STAGE\)', '"r"(0)'),
                    (r'asm volatile\(\s*"cp\.async\.bulk\.shared::cluster\.global.*?: "memory"\);',
                     ";")],
}
BF16_VARIANTS = {
    # timing only: no store into another CTA's tile
    "no_dsmem": [(r'asm volatile\("st\.shared::cluster\.v4\.b32.*?: "memory"\);', ";")],
    "no_softplus": _BF16_PARTS["softplus"],
    "no_weight_copy": _BF16_PARTS["weight_copy"],
    # timing only: the products, the barriers and the stores alone
    "wgmma_only": sum(_BF16_PARTS.values(), []),
}
VARIANTS = {"f32": F32_VARIANTS, "bf16": BF16_VARIANTS}


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
    parallel; a version other than the current one that fails to build is
    reported and left out."""
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
            if name == "current":
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            print(json.dumps({"version": name, "build_failed": log[-2000:]}))
            continue
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


def entry_params(source: str, name: str) -> list:
    """The parameter names of the C entry ``name`` in a version's source."""
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", source, flags=re.S)
    if not m:
        raise ValueError(f"no entry {name} in the source")
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


class Entry:
    """A version's entry for the variant, bound as its source declares it:
    whether it takes a cluster size, and which tensors.  ``own``: a build
    of the current source (or a variant of it), whose tile at each C is
    ``fused_mlp.TILES``'s; another version's is 64 points."""

    def __init__(self, path: Path, source: str, name: str, own: bool):
        params = entry_params(source, name)
        lib = ctypes.CDLL(str(path))
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        self.clustered, self.own = "cluster" in params, own
        self.pointers = [p for p in params[1:] if p not in ("n", "d_in", "k0", "cluster", "out",
                                                            "stream")]
        ints = [c_int] if self.clustered else []
        self.fn = getattr(lib, name)
        self.fn.argtypes = [ptr, c_int, c_int, c_int] + ints + [ptr] * (len(self.pointers) + 2)
        self.fn.restype = c_int
        self.query = getattr(lib, f"{name}_slots", None) if self.clustered else None
        if self.query:
            self.query.argtypes = [c_int] + ints + [ctypes.POINTER(c_int)]
            self.query.restype = c_int

    def tile(self, spec_name: str, c) -> int:
        return fm.TILES[spec_name][c] if self.own else 64


def lib_slots(entry: Entry, spec_name: str, k0: int, sizes=fm.CLUSTER_SIZES) -> dict:
    """C -> the library's slots at depth k0 for each C of ``sizes`` that its
    occupancy query takes (a source need not compile every C)."""
    slots = {}
    for c in sizes:
        got = ctypes.c_int(0)
        if entry.query(k0, c, ctypes.byref(got)) == 0:
            slots[c] = got.value
    if not slots:
        raise RuntimeError(f"occupancy query K0={k0}: no cluster size of {sizes} is taken")
    return slots


def both_forms(packed: dict, d_in: int) -> dict:
    """A pack that every version's entry can read: the bf16 kernel's stream
    ``w_img`` where ``pack_params`` built it, and ``w_in``/``w_mid``
    (contiguous) for a version that takes the layers' weights."""
    layers = {k: v.contiguous() for k, v in fm.plain_pack(packed, d_in).items()}
    return {**layers, **packed}


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
    ap.add_argument("--errors-d-in", type=int, nargs="*", default=[],
                    help="first-layer widths (chip_smoke.CHECK_D_IN, input weights spread) "
                         "at which every version's error against the plain twin is read, "
                         "untimed, at --errors-n")
    ap.add_argument("--errors-n", type=int, nargs="+", default=[4113, 49152])
    ap.add_argument("--other-wave-ms", type=json.loads, default=None,
                    help='each --other\'s WAVE_MS for its "auto" C, as JSON by C '
                         '(default: the current WAVE_MS of the sizes it compiles)')
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
        libs[name] = Entry(path, Path(sources[name]).read_text(), spec["name"],
                           own=name in ("current", *args.variant))
        print(json.dumps({"version": name, "clustered": libs[name].clustered,
                          "pointers": libs[name].pointers,
                          "ptxas": kernel_ptxas(log, spec["mangled"]),
                          "ptxas_warnings": sorted({ln.strip() for ln in log.splitlines()
                                                    if "arning" in ln})}))
    sizes = fm.cluster_sizes(spec["name"])
    slots = {k0: lib_slots(libs["current"], spec["name"], k0, sizes) for k0 in fm.KERNEL_DEPTHS}
    print(json.dumps({"slots": slots}))

    net = IDRNetwork(flagship_conf(num_pixels=2048).get_config("model"), device=dev,
                     seed=0).implicit_network
    assert net.dims[0] == D_IN
    k0 = fm.kernel_depth(D_IN)
    packed = both_forms(fm.pack_params(net.lin, D_IN, net.dims[1], dtype=spec["dtype"]), D_IN)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(1)
    wave_ms = fm.WAVE_MS[spec["name"]]
    other_wave_ms = ({int(c): v for c, v in args.other_wave_ms.items()}
                     if args.other_wave_ms else None)

    # (version, C) -> (entry, its slots, its WAVE_MS); C is "auto", one of
    # the sizes the version compiles, or None (no cluster interface)
    entries = {}
    for name, entry in libs.items():
        if not entry.clustered:
            entries[(name, None)] = (entry, None, None)
            continue
        own = lib_slots(entry, spec["name"], k0, sizes if entry.own else fm.CLUSTER_SIZES)
        own_wave = wave_ms if entry.own else other_wave_ms or wave_ms
        own_wave = {c: v for c, v in own_wave.items() if c in own}
        for c in ("auto",) + tuple(own):
            entries[(name, c)] = (entry, own, own_wave)

    def launcher(key, x, out, pk=packed):
        (entry, own, own_wave), (n, d_in) = entries[key], x.shape
        c = key[1]
        if c == "auto":
            c = fm.cluster_size(n, own, own_wave,
                                {d: entry.tile(spec["name"], d) for d in own_wave})
        extra = [] if c is None else [c]
        ptrs = [pk[p].data_ptr() for p in entry.pointers]

        def call():
            err = entry.fn(x.data_ptr(), n, d_in, fm.kernel_depth(d_in), *extra, *ptrs,
                           out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{key}: launch failed: CUDA error {err}")
        return call, (c if c is not None else 1)

    # each version's error at other first-layer depths (the occupancy of
    # another K0 is that of K0 64: the depth changes only l0's chunk count)
    for d_in in args.errors_d_in:
        embed_type, puts = CHECK_D_IN[d_in]
        conf = flagship_conf(num_pixels=2048, embed_type=embed_type)
        for key_, v in puts.items():
            conf.put(key_, v)
        dnet = IDRNetwork(conf.get_config("model"), device=dev, seed=0).implicit_network
        spread_input_weights(dnet, torch.Generator(device=dev).manual_seed(d_in))
        dpacked = both_forms(fm.pack_params(dnet.lin, d_in, dnet.dims[1], dtype=spec["dtype"]),
                             d_in)
        for n in args.errors_n:
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            with torch.no_grad():
                x = dnet._embed(pts).contiguous()
                want = fm.fused_sdf_raw_plain(x, dpacked)
            errs = {}
            for key in entries:
                out = torch.full((n,), float("nan"), device=dev)
                launcher(key, x, out, dpacked)[0]()
                torch.cuda.synchronize()
                errs[f"{key[0]},{key[1]}"] = float((out - want).abs().max())
            print(json.dumps({"d_in": d_in, "k0": fm.kernel_depth(d_in), "n": n,
                              "max_abs_err": errs}))

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
        ref = outs[("current", sizes[0])].view(torch.int32)
        ms = {key: [] for key in entries}
        lib_ms, plain_ms = [], []
        for order in (others + mine, mine + others):
            for key in order:
                ms[key].append(time_ms(calls[key][0]))
            with torch.no_grad():
                lib_ms.append(time_ms(lambda: library_chain(x, packed)))
                plain_ms.append(time_ms(lambda: fm.fused_sdf_raw_plain(x, packed)))
        flops, nbytes = sdf_mlp_cost(n, D_IN, net.dims[1], packed["w_out"].element_size())
        bound_ms = max(spec["products"] * flops / H100_PEAK_FLOPS[spec["peak"]],
                       nbytes / H100_PEAK_BYTES_PER_S) * 1e3
        for key in entries:
            err = float((outs[key] - want).abs().max())
            signs = bool((torch.sign(outs[key][big]) == torch.sign(want[big])).all())
            launched = calls[key][1]
            rec = {"version": key[0], "cluster": key[1], "n": n, "launched_cluster": launched,
                   "launched_tile": entries[key][0].tile(spec["name"], launched),
                   "keeps_math": key[0] not in variants,
                   "ms": ms[key], "library_ms": lib_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "max_abs_err": err,
                   "within_tol": bool(err <= spec["tol"]) and not math.isnan(err) and signs,
                   "bit_equal_to_current_smallest_c": bool(
                       torch.equal(outs[key].view(torch.int32), ref))}
            print(json.dumps(rec))

    # wave_ms: one full wave of clusters of C, and four waves over four
    for name, (entry, own, _) in {k[0]: v for k, v in entries.items() if k[1] == "auto"}.items():
        rec = {"version": name, "slots": own,
               "tiles": {c: entry.tile(spec["name"], c) for c in own},
               "wave_ms": {}, "four_waves_ms_per_wave": {}}
        for c in own:
            if own[c] < c:
                continue
            for waves, field in ((1, "wave_ms"), (4, "four_waves_ms_per_wave")):
                n = waves * own[c] // c * entry.tile(spec["name"], c)
                x, out = embedded(n), torch.empty(n, device=dev)
                call, _ = launcher((name, c), x, out)
                rec[field][c] = [time_ms(call) / waves for _ in range(2)]
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
