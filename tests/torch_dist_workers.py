"""Rank functions for the port's multi-process tests
(tests/test_torch_sharding.py, tests/test_torch_compile_cache.py).  Each
runs in a fresh process started by ``parallel.multihost.spawn``, so this
module imports torch and the port only, never JAX.
"""

import os
import time

import numpy as np
import torch

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse
from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.parallel.sharding import make_mesh
from hashmodnffbanks_idr_tpu_torch.train.trainer import (build_train_step, make_optimizer,
                                                         sparse_adam_init)
from hashmodnffbanks_idr_tpu_torch.utils import compile_cache

ALPHA = 50.0
LOSS_CFG = IDRLossConfig(eikonal_weight=0.1, mask_weight=200.0, alpha=ALPHA)


def run_step(model, scene, case, mesh=None, min_table_rows=8):
    """One train step of ``case`` (``img_idx``, ``pixel_idx``, and
    ``draws`` or a generator ``seed``; ``pose_vecs`` for trainable
    cameras; ``alpha``, ALPHA when absent) on ``model``, sharded over
    ``mesh`` when given.  Returns the losses, the parameters and their
    gradients after the step (a sharded table's gradient as this rank's
    rows, its Adam moments None before its first update), the camera
    state, and the step's count of skipped updates."""
    dev = next(model.parameters()).device
    opt = make_optimizer(model)
    pose_vecs = cam_opt = None
    if case.get("pose_vecs") is not None:
        pose_vecs = torch.tensor(case["pose_vecs"], device=dev, requires_grad=True)
        cam_opt = sparse_adam_init(pose_vecs)
    step = build_train_step(model, LOSS_CFG, opt, pose_vecs=pose_vecs, cam_opt=cam_opt,
                            mesh=mesh, min_table_rows=min_table_rows)
    gen = None
    if case.get("draws") is None:
        gen = torch.Generator(device=dev).manual_seed(case["seed"])
    scene_t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}
    losses = step(scene_t, torch.as_tensor(case["img_idx"], device=dev).long(),
                  torch.as_tensor(case["pixel_idx"], device=dev).long(), gen,
                  case.get("alpha", ALPHA), draws=case.get("draws"))
    tables = getattr(step, "tables", None)
    sharded = {} if tables is None else tables.shards
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "params": {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()},
           "grads": {n: (np.zeros(p.shape, np.float32) if p.grad is None
                         else p.grad.detach().cpu().numpy().copy())
                     for n, p in model.named_parameters() if n not in sharded},
           "shards": {}, "skipped": step.skipped}
    for n, shard in sharded.items():
        st = opt.state.get(shard, {})
        out["shards"][n] = {"rows": (tables.rows[n].start, tables.rows[n].stop),
                            "value": shard.detach().cpu().numpy().copy(),
                            "grad": shard.grad.detach().cpu().numpy().copy(),
                            "full_rows": tables.full[n].shape[0]}
        for k in ("exp_avg", "exp_avg_sq"):
            out["shards"][n][k] = st[k].cpu().numpy().copy() if k in st else None
    if pose_vecs is not None:
        out["pose_vecs"] = pose_vecs.detach().cpu().numpy().copy()
        out["cam_opt"] = {k: v.cpu().numpy().copy() for k, v in cam_opt.items()}
    return out


def sharded_steps(rank, world, device, conf_text, state, scene, cases, n_model,
                  min_table_rows):
    """Every case's step on a (world / n_model) x n_model mesh, each from
    the weights ``state``."""
    mesh = make_mesh(n_model=n_model)
    out = []
    for case in cases:
        model = IDRNetwork(parse(conf_text).get_config("model"), device=device)
        model.load_state_dict(state)
        out.append(run_step(model, scene, case, mesh=mesh, min_table_rows=min_table_rows))
    return out


def stub_build_order(rank, world, device, cache, delay):
    """``compile_cache.build_once`` with a stub build that writes
    ``<cache>/stub.so``: rank 0 sleeps ``delay`` seconds first, and every
    rank reports whether the file existed when its build began."""
    compile_cache.enable_compile_cache(cache)
    lib = os.path.join(compile_cache.cache_dir(), "stub.so")

    def build():
        seen = os.path.exists(lib)
        if not seen:
            time.sleep(delay)
            with open(lib + f".{rank}.tmp", "w") as f:
                f.write(str(rank))
            os.replace(lib + f".{rank}.tmp", lib)
        return rank, seen, time.time()

    return compile_cache.build_once(build)


def sharded_runner(rank, world, device, runner_kwargs, n_model):
    """``IDRTrainRunner`` under a (world / n_model) x n_model mesh; returns
    the run directory, the parameters after the run and the step's table
    shards' row ranges."""
    from hashmodnffbanks_idr_tpu_torch.train.trainer import IDRTrainRunner

    runner = IDRTrainRunner(**runner_kwargs, device=device, mesh=make_mesh(n_model=n_model))
    runner.run()
    return {"rundir": runner.rundir,
            "params": {n: p.detach().cpu().numpy().copy()
                       for n, p in runner.model.named_parameters()},
            "rows": {n: (s.start, s.stop) for n, s in runner._step_fn.tables.rows.items()}}


def device_type(rank, world, dev):
    """The type of the device ``spawn`` gave this rank."""
    return dev.type
