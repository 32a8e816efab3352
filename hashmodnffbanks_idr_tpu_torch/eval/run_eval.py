"""Evaluation CLI — parity with code/evaluation/eval.py:17-304 and the JAX
package's ``eval/run_eval.py`` (same flags and outputs).

    python -m hashmodnffbanks_idr_tpu_torch.eval.run_eval \
        --conf <conf> --scan_id 65 [--checkpoint latest] [--resolution 400] \
        [--eval_rendering] [--eval_cameras] [--is_uniform_grid] [--timestamp latest] \
        [--platform cpu]

Loads the latest (or named) ``.pt`` checkpoint of the experiment, exports
the world-coordinate surface mesh, and optionally re-renders all train
views for PSNR/SSIM/LPIPS CSVs and ``metrics/summary.json``.  The mesh comes
from two PCA-aligned grid passes, or with ``--is_uniform_grid`` from one
uniform grid over [-1, 1]^3 at ``--resolution`` (the JAX package parses
that flag and ignores it).  It runs on the CUDA card unless ``--platform
cpu`` is given.  A run whose conf expname holds ``trained`` renders from
the checkpoint's trained poses; ``--eval_cameras`` aligns those poses to the
ground truth (``get_gt_pose(scaled=True)``) with ``camera_alignment`` and
writes ``camera_accuracy.{txt,json}`` (JAX :73-120).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def find_run_dir(exps_folder: str, expname: str, timestamp: str) -> str:
    expdir = os.path.join(exps_folder, expname)
    if timestamp == "latest":
        stamps = sorted(os.listdir(expdir))
        if not stamps:
            raise FileNotFoundError(f"no runs in {expdir}")
        return os.path.join(expdir, stamps[-1])
    return os.path.join(expdir, timestamp)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--conf", required=True)
    p.add_argument("--expname", default="")
    p.add_argument("--exps_folder", default="exps")
    p.add_argument("--evals_folder", default="evals")
    p.add_argument("--scan_id", type=int, default=-1)
    p.add_argument("--timestamp", default="latest")
    p.add_argument("--checkpoint", default="latest")
    p.add_argument("--resolution", type=int, default=400)
    p.add_argument("--eval_rendering", action="store_true")
    p.add_argument("--eval_cameras", action="store_true")
    p.add_argument("--is_uniform_grid", action="store_true",
                   help="mesh one uniform grid over [-1, 1]^3 instead of two PCA-aligned passes")
    p.add_argument("--data_root", default=None)
    p.add_argument("--platform", default=None,
                   help="torch device to evaluate on (default: the CUDA card; 'cpu')")
    p.add_argument("--views", type=int, nargs="+", default=None,
                   help="render only these view ids (default: all); use the "
                        "same subset on both sides of a comparison")
    args = p.parse_args(argv)

    from .. import resolve_device
    from ..config.hocon import parse_file
    from ..models.renderer import IDRNetwork
    from ..train import checkpoints as ckpt
    from ..geometry.cameras import quat_to_rot
    from .evaluator import Evaluator, camera_alignment
    from .surface import export_surface

    device = resolve_device(args.platform)
    conf = parse_file(args.conf)
    scan_id = args.scan_id if args.scan_id != -1 else conf.get_int("dataset.scan_id", -1)
    # non-empty --expname REPLACES the conf expname (matching
    # train.exp_runner; deviation from the reference's append semantics)
    expname = args.expname or conf.get_string("train.expname")
    if args.expname and args.expname != conf.get_string("train.expname"):
        print(f"[expname] '--expname {args.expname}' REPLACES the conf "
              f"expname '{conf.get_string('train.expname')}'")
    if scan_id != -1:
        expname += f"_{scan_id}"

    run_dir = find_run_dir(args.exps_folder, expname, args.timestamp)
    model = IDRNetwork(conf.get_config("model"), device=device)
    loaded = ckpt.load_checkpoint(os.path.join(run_dir, "checkpoints"), args.checkpoint, model)
    epoch = loaded["epoch"]
    pose_vecs = loaded.get("pose_vecs")

    trained = "trained" in conf.get_string("train.expname")
    ev = Evaluator(conf, model, data_root=args.data_root, scan_id=scan_id,
                   pose_vecs=pose_vecs if trained else None)

    eval_dir = os.path.join(args.evals_folder, expname)
    os.makedirs(eval_dir, exist_ok=True)

    mesh_path = os.path.join(eval_dir, f"surface_world_coordinates_{epoch}.ply")
    t0 = time.perf_counter()
    if args.is_uniform_grid:
        export_surface(mesh_path, model.implicit_network.sdf, resolution=args.resolution,
                       transform=ev.dataset.get_scale_mat(), device=device)
    else:
        ev.export_mesh(mesh_path, epoch=epoch, resolution=args.resolution)
    mesh_s = time.perf_counter() - t0
    print(f"mesh -> {mesh_path} ({mesh_s:.1f} s)")

    camera_accuracy = None
    if args.eval_cameras and pose_vecs is None:
        print("camera accuracy: the checkpoint holds no trained cameras; nothing to align")
    elif args.eval_cameras:
        gt_pose = ev.dataset.get_gt_pose(scaled=True)
        pred_R = quat_to_rot(pose_vecs[:, :4]).numpy()
        camera_accuracy = camera_alignment(pred_R, gt_pose[:, :3, :3],
                                           pose_vecs[:, 4:].numpy(), gt_pose[:, :3, 3])
        line = (f"camera accuracy: rot mean {camera_accuracy['rot_err_mean']:.3f}deg "
                f"median {camera_accuracy['rot_err_median']:.3f}deg; "
                f"t mean {camera_accuracy['t_err_mean']:.4f} "
                f"median {camera_accuracy['t_err_median']:.4f}")
        print(line)
        with open(os.path.join(eval_dir, "camera_accuracy.txt"), "w") as f:
            f.write(line + "\n")
        with open(os.path.join(eval_dir, "camera_accuracy.json"), "w") as f:
            json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in camera_accuracy.items()}, f, indent=1)

    metrics = None
    if args.eval_rendering:
        t0 = time.perf_counter()
        metrics = ev.eval_rendering(eval_dir, views=args.views)
        render_s = time.perf_counter() - t0
        print(f"rendering: PSNR {metrics['psnr_mean']:.2f} "
              f"SSIM {metrics['ssim_mean']:.4f} LPIPS {metrics['lpips_mean']:.4f} "
              f"({render_s:.1f} s)")
        # machine-readable roll-up matching the head-to-head harness
        summary = {k: v for k, v in metrics.items()
                   if isinstance(v, (int, float, str, list))}
        summary.update({"epoch": epoch, "lpips_weights": metrics["lpips_weights"],
                        "views": args.views or "all", "mesh_s": mesh_s,
                        "render_s": render_s})
        with open(os.path.join(eval_dir, "metrics", "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return {"mesh": mesh_path, "eval_dir": eval_dir, "epoch": epoch, "metrics": metrics,
            "camera_accuracy": camera_accuracy}


if __name__ == "__main__":
    main(sys.argv[1:])
