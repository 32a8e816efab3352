"""Checkpoint store: model, Adam state, the runner's step count, the epoch,
and with trainable cameras the (V, 7) pose table and its SparseAdam state.

Counterpart of ``hashmodnffbanks_idr_tpu/train/checkpoints.py`` in the
port's own format: one ``torch.save`` file per saved epoch plus
``latest.pt``, each written to ``*.tmp`` and then ``os.replace``d (JAX
:25-36), so a run killed mid-write leaves the previous file whole.

``load_jax_checkpoint`` reads the JAX runner's ``*.msgpack`` files.

``cameras`` is ``{"pose_vecs": (V, 7) tensor, "cam_opt": {"m", "v",
"step"}}`` (``train/trainer.py:sparse_adam_init``); a load copies the saved
values into those tensors in place, on their devices.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..weights import from_jax_params, load_jax_adam_state, load_jax_camera_state

SUFFIX = ".pt"


def save_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    cameras: Optional[Dict] = None,
                    optimizer_state: Optional[Dict] = None) -> None:
    """``optimizer_state`` replaces ``optimizer.state_dict()`` (a sharded
    step's state with the tables' moments gathered whole)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    if optimizer_state is None:
        optimizer_state = optimizer.state_dict()
    payload = {"model": model.state_dict(), "optimizer": optimizer_state,
               "step": int(step), "epoch": int(epoch)}
    if cameras is not None:
        payload["pose_vecs"] = cameras["pose_vecs"].detach().cpu()
        payload["cam_opt"] = {k: v.detach().cpu() for k, v in cameras["cam_opt"].items()}
    buf = io.BytesIO()
    torch.save(payload, buf)
    data = buf.getvalue()
    for name in (f"{epoch}{SUFFIX}", f"latest{SUFFIX}"):
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(ckpt_dir, name))


def load_checkpoint(ckpt_dir: str, name: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    cameras: Optional[Dict] = None) -> Dict:
    """Restore ``model`` (and ``optimizer``, when given: the eval loads the
    model alone) in place from ``<name>.pt``, and ``cameras`` when given and
    saved (a checkpoint without cameras leaves them as they are, as the JAX
    runner does).  Returns the saved ``epoch`` and the runner's ``step``
    count, and ``pose_vecs`` (a CPU tensor) when the checkpoint has cameras."""
    payload = torch.load(os.path.join(ckpt_dir, f"{name}{SUFFIX}"), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        load_optimizer_state(optimizer, payload["optimizer"])
    if cameras is not None and "pose_vecs" in payload:
        _copy_cameras(cameras, payload["pose_vecs"], payload["cam_opt"])
    return _loaded(payload["epoch"], payload["step"], payload.get("pose_vecs"))


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict) -> None:
    """``optimizer.load_state_dict(state)`` that keeps the optimizer's own
    kind of learning rate and step count: a capturable Adam (the card's,
    ``trainer.make_optimizer``) keeps its ``capturable`` flag and its
    learning-rate tensor, which takes the saved value, and gets its step
    counts on the parameters' devices; a CPU one keeps a float rate.  So a
    checkpoint of either resumes on the other."""
    own = [{k: g[k] for k in ("lr", "capturable") if k in g} for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, kept in zip(optimizer.param_groups, own):
        saved_lr = float(group["lr"])
        group.update(kept)
        if torch.is_tensor(kept["lr"]):
            kept["lr"].fill_(saved_lr)
        else:
            group["lr"] = saved_lr
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                dev = p.device if kept.get("capturable") else torch.device("cpu")
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)


def _loaded(epoch, step, pose_vecs) -> Dict:
    out = {"epoch": int(epoch), "step": int(step)}
    if pose_vecs is not None:
        out["pose_vecs"] = pose_vecs
    return out


@torch.no_grad()
def _copy_cameras(cameras: Dict, pose_vecs: torch.Tensor, cam_opt: Dict) -> None:
    cameras["pose_vecs"].copy_(pose_vecs)
    for k, v in cam_opt.items():
        cameras["cam_opt"][k].copy_(v)


def latest_exists(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, f"latest{SUFFIX}"))


# ---------------------------------------------------------------------------
# the JAX runner's msgpack checkpoints
# ---------------------------------------------------------------------------

def _flax_array(data: bytes) -> np.ndarray:
    """flax.serialization's ndarray encoding: msgpack ``(shape, dtype name,
    C-order bytes)``."""
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # the upper half of a float32
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == 1:        # ndarray
        return _flax_array(data)
    if code == 3:        # numpy scalar, stored as a 0-d ndarray
        return _flax_array(data)[()]
    raise ValueError(f"msgpack extension type {code} is not a flax array")


def _unchunk(tree):
    """flax splits arrays over 2**30 bytes into ``__msgpack_chunked_array__``
    dicts; join them."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_jax_checkpoint(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
                        cameras: Optional[Dict] = None) -> Dict:
    """Restore ``model`` and ``optimizer`` from a JAX runner checkpoint
    (``train/checkpoints.py:save_checkpoint`` of the JAX package), and
    ``cameras`` when given and saved.

    Its tree, from ``flax.serialization.to_state_dict`` of the runner's
    state under ``optax.chain(clip_by_global_norm, adam(schedule))``:
    ``params``; ``opt_state/0`` (the clip state, empty);
    ``opt_state/1/0/{count, mu, nu}`` (Adam); ``opt_state/1/1/count`` (the
    schedule); ``epoch``; with trainable cameras ``pose_vecs`` and
    ``cam_opt/{m, v, step}``.  Returns ``epoch``, ``step`` (the schedule's
    count, which is the runner's step count) and, when saved, ``pose_vecs``."""
    import msgpack

    with open(path, "rb") as f:
        raw = _unchunk(msgpack.unpackb(f.read(), ext_hook=_flax_ext, raw=False))
    model.load_state_dict(from_jax_params(raw["params"], model))
    adam, schedule = raw["opt_state"]["1"]["0"], raw["opt_state"]["1"]["1"]
    load_jax_adam_state(adam["mu"], adam["nu"], int(adam["count"]), model, optimizer)
    pose_vecs = None
    if "pose_vecs" in raw:
        pose_vecs, cam_opt = load_jax_camera_state(raw["pose_vecs"], raw["cam_opt"])
        if cameras is not None:
            _copy_cameras(cameras, pose_vecs, cam_opt)
    return _loaded(raw["epoch"], schedule["count"], pose_vecs)
