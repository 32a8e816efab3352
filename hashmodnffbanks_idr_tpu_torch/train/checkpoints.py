"""Checkpoint store: model, Adam state, the runner's step count, the epoch.

Counterpart of ``hashmodnffbanks_idr_tpu/train/checkpoints.py`` in the
port's own format: one ``torch.save`` file per saved epoch plus
``latest.pt``, each written to ``*.tmp`` and then ``os.replace``d (JAX
:25-36), so a run killed mid-write leaves the previous file whole.

``load_jax_checkpoint`` reads the JAX runner's ``*.msgpack`` files.
"""

from __future__ import annotations

import io
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..weights import from_jax_params, load_jax_adam_state

SUFFIX = ".pt"


def save_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer, step: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step), "epoch": int(epoch)}, buf)
    data = buf.getvalue()
    for name in (f"{epoch}{SUFFIX}", f"latest{SUFFIX}"):
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(ckpt_dir, name))


def load_checkpoint(ckpt_dir: str, name: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer) -> Dict[str, int]:
    """Restore ``model`` and ``optimizer`` in place from ``<name>.pt``;
    returns the saved ``epoch`` and the runner's ``step`` count."""
    payload = torch.load(os.path.join(ckpt_dir, f"{name}{SUFFIX}"), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    return {"epoch": int(payload["epoch"]), "step": int(payload["step"])}


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


def load_jax_checkpoint(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> Dict[str, int]:
    """Restore ``model`` and ``optimizer`` from a JAX runner checkpoint
    (``train/checkpoints.py:save_checkpoint`` of the JAX package).

    Its tree, from ``flax.serialization.to_state_dict`` of the runner's
    state under ``optax.chain(clip_by_global_norm, adam(schedule))``:
    ``params``; ``opt_state/0`` (the clip state, empty);
    ``opt_state/1/0/{count, mu, nu}`` (Adam); ``opt_state/1/1/count`` (the
    schedule); ``epoch``.  Returns ``epoch`` and ``step``, the schedule's
    count, which is the runner's step count."""
    import msgpack

    with open(path, "rb") as f:
        raw = _unchunk(msgpack.unpackb(f.read(), ext_hook=_flax_ext, raw=False))
    model.load_state_dict(from_jax_params(raw["params"], model))
    adam, schedule = raw["opt_state"]["1"]["0"], raw["opt_state"]["1"]["1"]
    load_jax_adam_state(adam["mu"], adam["nu"], int(adam["count"]), model, optimizer)
    return {"epoch": int(raw["epoch"]), "step": int(schedule["count"])}
