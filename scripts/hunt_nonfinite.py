#!/usr/bin/env python3
"""Hunt for non-finite training steps of ``dtu_shaped_hashgridtcnn.conf``.

Trains the conf (``mixed`` tracer, 2048 rays a step) on the port's
``dtu_shaped`` scene at 240x320, 8 views (the scene ``chip_smoke.py``'s
``[ngp]`` runner phase trains on), again and again from the runner's seed
until ``--seconds`` have passed, in ``--workers`` processes sharing the
card.  Every step is checked: its loss terms and the global norm of its
gradient must be finite.  Per step it also keeps the smallest |grad . dir|
over the surface rays (the denominator of ``sample_network``) and the
gradient's global norm.  On the first non-finite step of a run it prints
the step's numbers, restores the state from before the step, replays it
under ``torch.autograd.detect_anomaly`` (which names the backward function
that made a NaN) and saves the pre-step weights and batch under ``--out``.

    python scripts/hunt_nonfinite.py --workers 6 --seconds 660

``--poison`` fills the CUDA caching allocator with NaN before each run, so
that a read of memory no kernel wrote shows as a NaN.  ``--after_smoke``
hunts in one process that first ran ``chip_smoke.py``'s phases up to and
with ``[cameras]``, on the scene those phases generated, in place of the
smoke's ``[ngp]`` runner phase.  The last line is a JSON summary: runs,
steps checked, non-finite steps.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.data import dtu_shaped  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models import renderer as rn  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.train import trainer as tr  # noqa: E402

CONF = os.path.join(REPO, "hashmodnffbanks_idr_tpu/config/confs/dtu_shaped_hashgridtcnn.conf")
RES = (240, 320)
EPOCHS = 40  # a run: epochs 0-40 of 8 steps, past the smoke's 30

# the last step's numbers, on the device (read once a step)
stats: dict = {}
_sample_network = rn.sample_network
_clip = tr.clip_by_global_norm


def sample_network_kept(out, sdf0, grad, dists, cam, dirs, valid_mask=None):
    """``sample_network``, keeping the smallest |grad . dir| of a surface ray."""
    dot = (grad * dirs.detach()).sum(-1).abs()
    stats["min_dot"] = torch.where(valid_mask, dot, torch.full_like(dot, math.inf)).min()
    return _sample_network(out, sdf0, grad, dists, cam, dirs, valid_mask)


def clip_kept(params, max_norm):
    stats["g_norm"] = _clip(params, max_norm)
    return stats["g_norm"]


def make_scene(root: str) -> str:
    gen = dtu_shaped.main(["--out", os.path.join(root, "gen"), "--n_views", "8", "--img_res",
                           str(RES[0]), str(RES[1]), "--scan_id", "0", "--mesh_resolution", "320"])
    scene = os.path.join(root, "data", "dtu_shaped_small", "scan0")
    os.makedirs(os.path.dirname(scene))
    shutil.move(gen, scene)
    return os.path.join(root, "data")


def poison_allocator() -> None:
    junk = [torch.full((1 << k,), math.nan, device="cuda") for k in range(6, 20) for _ in range(40)]
    junk += [torch.full((1 << 28,), math.nan, device="cuda") for _ in range(6)]
    del junk


class NonFinite(Exception):
    pass


def one_run(data_root: str, deadline: float, out_dir: str, tag: str, poison: bool) -> dict:
    """One training run; returns its steps, whether it met a non-finite
    step, and its smallest |grad . dir| and largest gradient norm."""
    conf = parse_file(CONF)
    conf.put("dataset.img_res", list(RES))
    conf.put("dataset.data_dir", "dtu_shaped_small")
    if poison:
        poison_allocator()
    with tempfile.TemporaryDirectory() as exps:
        runner = tr.IDRTrainRunner(conf, nepochs=EPOCHS, exps_folder_name=exps,
                                   data_root=data_root, log_tensorboard=False)
        model, opt, built = runner.model, runner.optimizer, runner._step_fn
        seen = {"steps": 0, "min_dot": math.inf, "g_norm_max": 0.0}

        def checked(scene, img_idx, pixel_idx, gen, alpha, draws=None):
            before = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                      copy.deepcopy(opt.state_dict()), gen.get_state())
            losses = built(scene, img_idx, pixel_idx, gen, alpha)
            vals = torch.stack([v.float() for v in losses.values()]
                               + [stats["g_norm"].float(), stats["min_dot"].float()]).tolist()
            rec = dict(zip(list(losses) + ["g_norm", "min_dot"], vals))
            seen["steps"] += 1
            seen["min_dot"] = min(seen["min_dot"], rec["min_dot"])
            if math.isfinite(rec["g_norm"]):
                seen["g_norm_max"] = max(seen["g_norm_max"], rec["g_norm"])
            if all(math.isfinite(v) for v in vals[:-1]):
                if time.time() > deadline:
                    raise TimeoutError
                return losses
            print(f"[{tag}] NON-FINITE at step {seen['steps']}: {json.dumps(rec)}", flush=True)
            model.load_state_dict(before[0])
            opt.load_state_dict(before[1])
            gen.set_state(before[2])
            opt.zero_grad(set_to_none=True)
            try:
                with torch.autograd.detect_anomaly(check_nan=True):
                    again = tr.loss_fn(model, runner.loss_cfg, scene, img_idx, pixel_idx, gen,
                                       alpha)
                    print(f"[{tag}] replay forward: "
                          f"{json.dumps({k: float(v) for k, v in again.items()})}", flush=True)
                    again["loss"].backward()
                print(f"[{tag}] replay backward finite", flush=True)
            except RuntimeError as e:
                print(f"[{tag}] replay: {str(e)[:2000]}", flush=True)
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{tag}_step{seen['steps']}.pt")
            torch.save({"model": {k: v.cpu() for k, v in before[0].items()},
                        "img_idx": img_idx.cpu(), "pixel_idx": pixel_idx.cpu(),
                        "generator_state": before[2], "alpha": alpha, "rec": rec}, path)
            print(f"[{tag}] saved {path}", flush=True)
            raise NonFinite

        runner._step_fn = checked
        end = "clean"
        try:
            runner.run()
        except NonFinite:
            end = "non-finite"
        except TimeoutError:
            end = "deadline"
    return dict(seen, end=end)


def worker(args) -> dict:
    rn.sample_network = sample_network_kept
    tr.clip_by_global_norm = clip_kept
    deadline = time.time() + args.seconds
    runs = []
    while time.time() < deadline - 30:
        r = one_run(args.data_root, deadline, args.out,
                    f"w{args.worker_id}r{len(runs)}", args.poison and args.worker_id == 0)
        print(f"[w{args.worker_id}r{len(runs)}] {json.dumps(r)}", flush=True)
        runs.append(r)
    summary = {"worker": args.worker_id, "runs": len(runs),
               "steps": sum(r["steps"] for r in runs),
               "non_finite": sum(r["end"] == "non-finite" for r in runs)}
    print(json.dumps(summary), flush=True)
    return summary


def after_smoke(args) -> dict:
    """``chip_smoke.main`` with its ``[ngp]`` runner phase replaced by the
    hunt, stopped there."""
    import chip_smoke

    class Hunted(Exception):
        pass

    def hunt_instead(fm, smi, workdir, data_root):
        args.data_root, args.worker_id = data_root, 0
        raise Hunted(worker(args))

    chip_smoke.phase_ngp_runner = hunt_instead
    try:
        chip_smoke.main()
    except Hunted as done:
        return done.args[0]
    finally:
        chip_smoke.stop_children()
    raise RuntimeError("chip_smoke.main returned before its [ngp] runner phase")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--seconds", type=float, default=600.0)
    p.add_argument("--poison", action="store_true",
                   help="worker 0 fills the allocator with NaN before each run")
    p.add_argument("--after_smoke", action="store_true",
                   help="hunt in chip_smoke.py's process, after its phases up to [cameras]")
    p.add_argument("--out", default=os.path.join(REPO, "build", "nonfinite"))
    p.add_argument("--worker_id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--data_root", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker_id is not None:
        worker(args)
        return 0
    if not torch.cuda.is_available():
        print("hunt_nonfinite: CUDA is not available", file=sys.stderr)
        return 2
    if args.after_smoke:
        total = after_smoke(args)
        print(json.dumps(dict(total, workers=1, seconds=args.seconds, after_smoke=True)))
        return 0
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm

    fm.load_library()  # once, before the workers load it
    with tempfile.TemporaryDirectory() as root:
        data_root = make_scene(root)
        cmd = [sys.executable, os.path.abspath(__file__), "--seconds", str(args.seconds),
               "--out", args.out, "--data_root", data_root]
        logs = [os.path.join(root, f"worker{i}.log") for i in range(args.workers)]
        procs = []
        try:
            for i, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        cmd + ["--worker_id", str(i)] + (["--poison"] if args.poison else []),
                        stdout=f))
            for proc in procs:
                proc.wait()
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        summaries = []
        for log in logs:
            with open(log) as f:
                out = f.read()
            print(out, end="")
            summaries.append(json.loads(out.strip().splitlines()[-1]))
    total = {k: sum(s[k] for s in summaries) for k in ("runs", "steps", "non_finite")}
    print(json.dumps(dict(total, workers=args.workers, seconds=args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
