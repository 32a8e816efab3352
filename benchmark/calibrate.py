#!/usr/bin/env python3
"""The readings that the correctness limits of a cell are set from (not
run by the benchmark's own runs):

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--kinds program control control_tf32 half unchanged f32_guidance]

For each seed, in one process on one card: ``program`` builds the port's
step as a run does and drives it through the checked steps, then compares
it with the plain reference (float32, TF32 off, bf16 guidance): the lower
readings.  ``control`` puts in the program's place the reference one step
below each precision the configuration states: its float32 products in
TF32 and its bf16 guidance SDF in fp8 (e4m3; a cell without guidance has
none to lower): an upper reading.  ``control_tf32`` lowers the float32
products alone (a later change could lower only those).  ``half`` puts the reference on half of each
step's rays (the mean taken over the rest) in its place, and
``unchanged`` is a step that leaves the state as it was (computed, no
run): the faults' readings.  ``f32_guidance`` is a witness: the program
and the reference both with the mixed tracer's guidance in float32 (the
f32 kernel and its plain twin in place of the bf16 ones), compared as
the program is.  One JSON line a seed and kind on standard output."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT))


def f32_closure(make_fast_sdf):
    """``make_fast_sdf`` that builds every guidance SDF in float32."""
    def make(precision="bf16", **kw):
        return make_fast_sdf("f32", **kw)
    return make


@contextlib.contextmanager
def f32_guidance(cls):
    """The reference's guidance in float32 while the block runs."""
    orig = cls.make_fast_sdf
    cls.make_fast_sdf = lambda self, precision="bf16", **kw: orig(self, "f32", **kw)
    try:
        yield
    finally:
        cls.make_fast_sdf = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+",
                    default=["program", "control", "control_tf32", "half", "unchanged"],
                    choices=["program", "control", "control_tf32", "half", "unchanged",
                             "f32_guidance"])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch

    from harness import check
    from harness.driver import free, start
    from harness.scene import build_scene
    from harness.spec import resolve
    from reference import step as ref_step
    from reference.networks import ImplicitNetwork as RefImplicit

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = resolve(ROOT, args.workload)
    conf = cell.conf
    rays = int(cell.traffic["rays_per_step"])
    scene = build_scene(cell.traffic, args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        st = start(cell, scene, seed, args.device)
        prog, weights, checked = st.prog, st.weights, st.checked
        del st
        free(args.device)
        t1 = time.perf_counter()
        ref = ref_step.run_steps(conf, scene, weights, checked)
        t2 = time.perf_counter()

        readings, steps = {}, {"program": prog["losses"]}
        if "program" in args.kinds:
            readings["program"] = check.gaps(prog, ref, weights)
        if "f32_guidance" in args.kinds:
            with f32_guidance(RefImplicit):
                ref32 = ref_step.run_steps(conf, scene, weights, checked)

            def guide_f32(program):
                net = program.model.implicit_network
                net.make_fast_sdf = f32_closure(net.make_fast_sdf)
                return program
            st = start(cell, scene, seed, args.device, wrap_program=guide_f32)
            readings["f32_guidance"] = check.gaps(st.prog, ref32, weights)
            steps["f32_guidance"] = st.prog["losses"]
            del st
            free(args.device)
        variants = {"control": {"tf32": True, "guide_dtype": torch.float8_e4m3fn},
                    "control_tf32": {"tf32": True},
                    "half": {"keep_rays": rays // 2}}
        for kind, kw in variants.items():
            if kind in args.kinds:
                other = ref_step.run_steps(conf, scene, weights, checked, **kw)
                readings[kind] = check.gaps(other, ref, weights)
                steps[kind] = other["losses"]
        if "unchanged" in args.kinds:
            readings["unchanged"] = check.gaps(dict(ref, params=weights), ref, weights)
        for kind, numbers in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **numbers,
                              "step_loss_gaps": [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                                 for a, b in zip(steps.get(kind, []),
                                                                 ref["losses"])],
                              "program_losses": ([t["loss"] for t in prog["losses"]]
                                                 if kind == "program" else None),
                              "reference_losses": [t["loss"] for t in ref["losses"]],
                              "program_s": t1 - t0, "reference_s": t2 - t1}), flush=True)
        free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
