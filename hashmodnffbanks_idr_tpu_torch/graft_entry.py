"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

``entry()``              -> (fn, example_args): the flagship StyleModNFFB IDR
                            model's eval forward over 256 rays, on the card.
``dryrun_multichip(n)``  -> n ranks (one per card, NCCL; gloo ranks with
                            ``device='cpu'``) on a ('data', 'model') mesh,
                            each running ONE sharded training step of four
                            configurations (the JAX dry run's four, on its
                            mesh rule).

Run from the repository root: ``python -m hashmodnffbanks_idr_tpu_torch.graft_entry
[--n N] [--platform cpu]``.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List

import numpy as np
import torch

DRYRUN_LABELS = ("toy", "toy-trained-cams", "flagship-full", "ngp15-full")


def entry(device=None):
    """The flagship forward (StyleModNFFB, full-size nets, 256 rays of a
    16x16 image seen from z=+2; JAX :37-62).  Returns ``(fn, args)``:
    ``fn(*args)`` gives (rgb_values, network_object_mask, dists)."""
    from . import resolve_device
    from .models.renderer import IDRNetwork
    from .testing import flagship_conf
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = resolve_device(device)
    model = IDRNetwork(flagship_conf(num_pixels=256).get_config("model"), device=dev, seed=0)
    n_rays = 256
    uv = np.stack(np.meshgrid(np.arange(16.0), np.arange(16.0)), -1).reshape(1, n_rays, 2)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, 2, 3] = 2.0  # camera at z=+2 looking back through the origin
    pose[0, :3, :3] = [[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]]
    intr = np.diag([40.0, 40.0, 1.0, 1.0]).astype(np.float32)[None]
    intr[0, 0, 2] = intr[0, 1, 2] = 8.0
    inputs = {"uv": uv.astype(np.float32), "intrinsics": intr, "pose": pose,
              "object_mask": np.ones((1, n_rays), dtype=bool)}
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}

    @torch.no_grad()
    def fn(model, inputs, generator):
        out = model(inputs, generator=generator, training=False)
        return out["rgb_values"], out["network_object_mask"], out["dists"]

    return fn, (model, inputs, torch.Generator(device=dev).manual_seed(1))


def _conf(label: str, n_rays: int):
    """The dry run's configuration of ``label`` (JAX :162-200): the narrow
    toy, the full-size flagship, and the full-size instant-ngp log2=15 grid
    with level-pruned guidance (prune 16/16/4).  The full-size runs take the
    exact tracer through the fused f32 kernel."""
    from .testing import flagship_conf

    if label.startswith("toy"):
        return flagship_conf(num_pixels=n_rays, small=True)
    if label == "flagship-full":
        conf = flagship_conf(num_pixels=n_rays)
    else:
        conf = flagship_conf(num_pixels=n_rays, embed_type="HashGridTcnn")
        conf.put("model.embedding_network.log2_max_hash_size", 15)
        conf.put("model.ray_tracer.prune_levels_march", 16)
        conf.put("model.ray_tracer.prune_levels_coarse", 16)
        conf.put("model.ray_tracer.prune_secant_iters", 4)
    conf.put("model.tracer_exact_fused", True)
    return conf


def dryrun_one(mesh, dev, label: str, n_rays: int, min_table_rows: int,
               require_table_sharding: bool = False,
               train_cameras: bool = False) -> Dict:
    """One sharded step of configuration ``label`` on this rank (JAX
    ``_dryrun_one``, :65-133): weights from seed 0, the same on every rank,
    a two-view 16x16 synthetic scene, the first ``n_rays`` pixels of view
    0.  Raises on a non-finite loss, and with ``require_table_sharding``
    when no table is row-sharded.  Returns the rank's record."""
    from .geometry.cameras import rot_to_quat
    from .models.loss import IDRLossConfig
    from .models.renderer import IDRNetwork
    from .ops import fused_mlp as fm
    from .testing import scene_to_device, synthetic_scene
    from .train.trainer import build_train_step, make_optimizer, sparse_adam_init

    model = IDRNetwork(_conf(label, n_rays).get_config("model"), device=dev, seed=0)
    optimizer = make_optimizer(model)
    scene_np = synthetic_scene(n_views=2, img_res=(16, 16))
    pose_vecs = cam_opt = None
    if train_cameras:
        pose = scene_np["pose"]
        vecs = np.concatenate([rot_to_quat(pose[:, :3, :3]), pose[:, :3, 3]], 1)
        pose_vecs = torch.tensor(vecs.astype(np.float32), device=dev, requires_grad=True)
        cam_opt = sparse_adam_init(pose_vecs)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), optimizer,
                            pose_vecs=pose_vecs, cam_opt=cam_opt, mesh=mesh,
                            min_table_rows=min_table_rows)
    sharded = sorted(step.tables.full)
    if require_table_sharding and not sharded:
        raise AssertionError(f"{label}: no table engaged row sharding over 'model'")
    before = {k: c["launches"] for k, c in fm.launch_counts.items()}
    losses = step(scene_to_device(scene_np, dev), torch.tensor([0], device=dev),
                  torch.arange(n_rays, device=dev), torch.Generator(device=dev).manual_seed(2),
                  50.0)
    loss = float(losses["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{label}: the sharded step produced a non-finite loss {loss}")
    if train_cameras and not torch.isfinite(pose_vecs).all():
        raise AssertionError(f"{label}: non-finite pose vecs")
    return {"label": label, "mesh": list(mesh.shape), "n_rays": n_rays, "loss": loss,
            "sharded_tables": {n: [list(step.tables.full[n].shape),
                                   list(step.tables.shards[n].shape)] for n in sharded},
            "launches": {k: c["launches"] - before[k] for k, c in fm.launch_counts.items()}}


def dryrun_rank(rank: int, world: int, dev, labels=DRYRUN_LABELS) -> List[Dict]:
    """The four runs of ``dryrun_multichip`` on this rank, one mesh for all
    (n_model = 2 when the world is even and at least 4; JAX :162)."""
    from .parallel.sharding import make_mesh
    from .utils.compile_cache import build_once, enable_compile_cache

    enable_compile_cache()
    if dev.type == "cuda":
        from .ops import fused_mlp as fm

        build_once(fm.load_library)
    n_model = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(n_data=world // n_model, n_model=n_model)
    n_data = world // n_model
    runs = {"toy": (64, 8, False, False), "toy-trained-cams": (64, 8, False, True),
            "flagship-full": (8 * n_data, 1024, False, False),
            "ngp15-full": (8 * n_data, 1024, True, False)}
    out = []
    for label in labels:
        n_rays, rows, require, cams = runs[label]
        rec = dryrun_one(mesh, dev, label, n_rays, rows, require_table_sharding=require,
                         train_cameras=cams)
        out.append(rec)
        if rank == 0:
            print(f"dryrun_multichip[{label}]: mesh {rec['mesh']} loss={rec['loss']:.5f} "
                  f"tables {rec['sharded_tables']} OK", flush=True)
    return out


def dryrun_multichip(n_devices: int, device=None, labels=DRYRUN_LABELS,
                     timeout: float = 900.0) -> List[List[Dict]]:
    """The sharded dry run (JAX :136-200) in ``n_devices`` ranks launched
    through ``torch.multiprocessing``, one per card (``device`` None or
    'cuda', NCCL) or gloo ranks on the CPU (``device='cpu'``):

    1. ``toy``: the narrow nets, both NFFB tables row-sharded
       (``min_table_rows=8``); then ``toy-trained-cams``, the same with the
       trainable-camera step (pose table + SparseAdam);
    2. ``flagship-full``: the full-size StyleModNFFB conf (8x512, 4x512);
       its 192- and 64-row tables stay replicated at 1024 rows, the rays
       split over the ranks;
    3. ``ngp15-full``: the full-size HashGridTcnn log2=15 conf with pruned
       guidance; its 168,768-row SDF table must take the row sharding at
       the default 1024 rows (on a 1x1 mesh, one shard of every row).

    Every run must end with a finite loss on every rank.  Returns each
    rank's records (``dryrun_one``)."""
    from .parallel.multihost import spawn

    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
        device = "cuda"
    return spawn(dryrun_rank, n_devices, args=(tuple(labels),), device=device,
                 timeout=timeout)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's entry forward and sharded dry run")
    p.add_argument("--n", type=int, default=None, help="ranks (default: every card)")
    p.add_argument("--platform", default=None, help="'cpu' for gloo ranks on the CPU")
    args = p.parse_args(argv)
    fn, fargs = entry(device=args.platform)
    print("entry OK:", [tuple(o.shape) for o in fn(*fargs)])
    n = args.n or (torch.cuda.device_count() if args.platform != "cpu" else 1)
    dryrun_multichip(n, device=args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
