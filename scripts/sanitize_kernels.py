#!/usr/bin/env python3
"""Both fused-kernel variants under the CUDA toolkit's compute-sanitizer, and
the checks that need no sanitizer.

Each variant (f32, bf16) is launched at every compiled first-layer depth
K0 (64, 128, 256, 512; d_in 59, 102, 198 and 510, the depths the encoders
and NerfPos give, as ``chip_smoke.py`` holds them), at every configuration
it compiles (the cluster size C, the CTAs that share a tile through
distributed shared memory, and the tile's points: f32 64 at C = 2 and 4;
bf16 64 at C = 1 and 128 at C = 4, ``fused_mlp.TILES``), and at N =
1, 63, 64, 65, 127, 128, 129 and 4113 (the edges of both tiles and a
ragged last tile), from seeded points and an ``IDRNetwork``
whose first-layer and skip weights are spread as
``chip_smoke.spread_input_weights`` spreads them, so that every input
column counts.

    python scripts/sanitize_kernels.py

First, in this process, each launch is held to what the sanitizers would
catch where it changes the output:
  - ``x`` and ``out`` sit inside NaN-filled buffers with 64 guard rows on
    each side: the guards must come back untouched, every output must be
    written (``out`` starts as NaN) and within the variant's tolerance of
    its plain twin;
  - just before the launch the same variant runs over NaN points and NaN
    weights on every SM, at the launch's cluster size, which leaves shared
    memory full of NaN: the output must equal, bit for bit, the one from an
    unpoisoned launch (a read of shared memory the kernel did not write
    would show, such as a slice of a layer that a CTA of the cluster did not
    write into another's tile);
  - ten more launches on the same input give the same bits;
  - each cluster size gives the bits of the variant's smallest C on the
    same input.
Then, for each tool, it runs itself with ``--launches-only`` (each launch
once, nothing else) under ``compute-sanitizer --tool <tool>`` and reads the
tool's ERROR SUMMARY.  The last line is a JSON record: the checks, and per
tool its error count, exit code and seconds, or why its launches did not
run.  Where a tool refuses the card ("Device not supported"), it stops
the program at its first CUDA call: the in-process checks are then what
there is, and the script exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

# first-layer depth -> (SDF encoder, conf overrides); d_in 59 / 102 / 198 / 510
DEPTHS = {64: ("StyleModNFFB", {}),
          128: ("NerfPos", {"model.implicit_network.multires": 16}),
          256: ("NerfPos", {"model.implicit_network.multires": 32}),
          512: ("NerfPos", {"model.implicit_network.multires": 84})}
NS = (1, 63, 64, 65, 127, 128, 129, 4113)
TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
VARIANTS = (("fused_sdf_raw_f32", torch.float32, 1e-5), ("fused_sdf_raw_bf16", torch.bfloat16, 3e-2))
GUARD = 64
REPEATS = 10
TOOL_TIMEOUT = 300  # seconds a sanitizer tool may take over the 128 launches


def cases(dev):
    """(variant, K0, C, N, x, packed, tol) for every launch, from seeds."""
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf

    gen = torch.Generator(device=dev).manual_seed(3)
    for k0, (embed, puts) in DEPTHS.items():
        conf = flagship_conf(num_pixels=64, embed_type=embed)
        for key, value in puts.items():
            conf.put(key, value)
        net = IDRNetwork(conf.get_config("model"), device=dev, seed=0).implicit_network
        with torch.no_grad():
            for l in (0, *net.skip_in):  # chip_smoke.spread_input_weights
                p = net.lin[l].v if net.lin[l].weight_norm else net.lin[l].w
                p.add_(0.03 * torch.randn(p.shape, generator=gen, device=dev))
        d_in = net.dims[0]
        assert fm.kernel_depth(d_in) == k0, (embed, d_in, k0)
        for name, dtype, tol in VARIANTS:
            packed = fm.pack_params(net.lin, d_in, net.dims[1], dtype=dtype)
            for n in NS:
                pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
                with torch.no_grad():
                    x = net._embed(pts).contiguous()
                for c in fm.cluster_sizes(name):
                    yield name, k0, c, n, x, packed, tol


def launch(fm, x, packed, out, cluster):
    """One launch of the variant that ``packed`` selects at cluster size
    ``cluster`` (on that configuration's tile), writing ``out``."""
    lib = fm.load_library()
    n, d_in = x.shape
    name = "fused_sdf_raw_f32" if packed["w_out"].dtype == torch.float32 else "fused_sdf_raw_bf16"
    pointers = [packed[k].data_ptr() for k in fm.POINTERS[name]]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(x.data_ptr(), n, d_in, fm.kernel_depth(d_in), cluster, *pointers,
                             out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def make_poison(fm, dev, dtype):
    """Inputs of the variant of weight type ``dtype`` that poison shared
    memory: NaN points and NaN weights (the bf16 kernel's as its weight
    image), at least two CTAs an SM at every configuration, whose tile and
    ring fill every SM's shared memory with NaN."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d_in, hidden = 59, fm.KERNEL_HIDDEN
    nan = float("nan")
    w_in = torch.full((d_in, hidden), nan, device=dev, dtype=dtype)
    w_mid = torch.full((fm.N_MID, hidden, hidden), nan, device=dev, dtype=dtype)
    packed = {"b_in": torch.full((hidden,), nan, device=dev),
              "b_mid": torch.full((fm.N_MID, hidden), nan, device=dev),
              "w_out": torch.full((hidden,), nan, device=dev, dtype=dtype),
              "b_out": torch.full((1,), nan, device=dev)}
    if dtype == torch.bfloat16:
        packed["w_img"] = fm.stream_image(w_in, w_mid)
    else:
        packed.update(w_in=w_in, w_mid=w_mid)
    n = 2 * sms * 64
    return torch.full((n, d_in), nan, device=dev), packed, torch.empty(n, device=dev)


def checks(dev) -> dict:
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm

    poison = {name: make_poison(fm, dev, dtype) for name, dtype, _ in VARIANTS}
    nan_bits = torch.tensor(float("nan"), device=dev).view(torch.int32)
    worst = {name: 0.0 for name, *_ in VARIANTS}
    n_cases = 0
    c1 = {}  # (variant, K0, N) -> the output bits at the variant's smallest C
    for name, k0, c, n, x, packed, tol in cases(dev):
        where = f"{name} K0={k0} C={c} N={n}"
        xbuf = torch.full((n + 2 * GUARD, x.shape[1]), float("nan"), device=dev)
        xbuf[GUARD:GUARD + n] = x
        obuf = torch.full((n + 2 * GUARD,), float("nan"), device=dev)
        xg, og = xbuf[GUARD:GUARD + n], obuf[GUARD:GUARD + n]
        launch(fm, xg, packed, og, c)
        torch.cuda.synchronize()
        guards = torch.cat([obuf[:GUARD], obuf[GUARD + n:]]).view(torch.int32)
        if not bool((guards == nan_bits).all()):
            raise AssertionError(f"{where}: a write outside out")
        if not bool(torch.isfinite(og).all()):
            raise AssertionError(f"{where}: an output left unwritten or not finite")
        want = fm.fused_sdf_raw_plain(x, packed)
        err = float((og - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"{where}: max abs err {err} against the plain twin > {tol}")
        big = want.abs() > 5e-2
        if not bool((torch.sign(og[big]) == torch.sign(want[big])).all()):
            raise AssertionError(f"{where}: sign disagreement with the plain twin where "
                                 "|sdf| > 5e-2")
        worst[name] = max(worst[name], err)
        first = og.clone()
        for _ in range(REPEATS):
            launch(fm, *poison[name], c)
            again = torch.full((n,), float("nan"), device=dev)
            launch(fm, xg, packed, again, c)
            if not torch.equal(again.view(torch.int32), first.view(torch.int32)):
                raise AssertionError(f"{where}: a launch after poisoned shared memory, or a "
                                     "repeat, changed the output")
        bits = first.view(torch.int32)
        if not torch.equal(c1.setdefault((name, k0, n), bits), bits):
            raise AssertionError(f"{where}: differs from the smallest C on the same input")
        n_cases += 1
        print(f"[check] {where}: guards intact, all written, max abs err {err:.3e}, "
              f"{REPEATS} launches over poisoned shared memory bit-identical, equal to the "
              "smallest C")
    return {"cases": n_cases, "max_abs_err": worst, "repeats": REPEATS,
            "clusters": {name: list(fm.cluster_sizes(name)) for name, *_ in VARIANTS}}


def launches_only(dev) -> None:
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm

    count = 0
    for name, k0, c, n, x, packed, _ in cases(dev):
        out = torch.empty(n, device=dev)
        launch(fm, x, packed, out, c)
        torch.cuda.synchronize()
        count += 1
    print(f"[launches] {count} launches")


def run_tool(tool: str) -> dict:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(cuda, "bin", "compute-sanitizer")
    if not os.path.exists(exe):
        return {"ran": False, "why": f"{exe} not found"}
    cmd = [exe, "--tool", tool, "--print-limit", "20", sys.executable,
           os.path.abspath(__file__), "--launches-only"]
    t0 = time.time()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=TOOL_TIMEOUT)
    except subprocess.TimeoutExpired:
        return {"ran": False, "why": f"timed out after {TOOL_TIMEOUT} s"}
    text = res.stdout + res.stderr
    summary = re.findall(r"ERROR SUMMARY: (\d+) error", text)
    launched = re.search(r"\[launches\] (\d+) launches", text)
    refused = re.search(r"=+ Error: (.*)", text)
    rec = {"ran": bool(summary) and launched is not None, "exit_code": res.returncode,
           "seconds": round(time.time() - t0, 1),
           "errors": int(summary[-1]) if summary and launched else None,
           "launches": int(launched.group(1)) if launched else None}
    if launched is None:
        # the tool stopped the program before its launches (an ERROR SUMMARY
        # then counts the tool's own failure, not a finding in a kernel)
        rec["why"] = refused.group(1).strip() if refused else "the launches did not run"
    if not rec["ran"] or rec["errors"]:
        rec["output_tail"] = text[-3000:]
    print(f"[{tool}] " + json.dumps({k: v for k, v in rec.items() if k != "output_tail"}))
    if "output_tail" in rec:
        print(rec["output_tail"])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--launches-only", action="store_true",
                   help="each launch once and nothing else (what a sanitizer tool runs)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sanitize_kernels: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if args.launches_only:
        launches_only(dev)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    record = {"card": smi, "checks": checks(dev), "tools": {}}
    for tool in TOOLS:
        record["tools"][tool] = run_tool(tool)
    ok = all(r["ran"] and r["errors"] == 0 for r in record["tools"].values())
    record["ok"] = ok
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
