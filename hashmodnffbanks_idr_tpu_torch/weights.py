"""Weight bridge: the JAX package's params pytree -> a port state dict.

The port's parameter names follow the JAX tree (``lin.<i>.v``,
``embed.grid.table``, ...), except that the embedders are the modules
``embedder`` / ``view_embedder``.  Linear weights ``w``/``v`` are
transposed from JAX's ``(in, out)`` to ``(out, in)``; a hash table may come
as ``(rows, C)`` or as the JAX package's ``(P, 128)`` page image.  Adam's
moment trees have the params' structure and map the same way.  The
trainable cameras' (V, 7) pose table and SparseAdam state carry over as they
are (``load_jax_camera_state``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .ops.hashgrid import as_rows

_RENAME = {"embed": "embedder", "view_embed": "view_embedder"}


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        items = ((_RENAME.get(k, k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, np.asarray(tree)
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else k)


def from_jax_params(params_np: dict, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) of ``model``'s JAX counterpart ->
    a state dict for ``model.load_state_dict``.  ``model`` supplies the
    target names and shapes.  Raises on any leaf without a counterpart, any
    parameter left unset, and any shape that does not match."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(params_np):
        if name not in target:
            raise KeyError(f"JAX leaf {name!r} has no counterpart in {type(model).__name__}")
        want = tuple(target[name].shape)
        arr = np.asarray(leaf, dtype=np.float32)
        kind = name.rsplit(".", 1)[-1]
        if kind == "table":
            arr = as_rows(arr, *want)
        elif kind in ("w", "v") and arr.ndim == 2:
            arr = arr.T
        if arr.shape != want:
            raise ValueError(f"{name}: JAX shape {arr.shape} does not fit {want}")
        out[name] = torch.tensor(arr)  # a copy: JAX's numpy views are read-only
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
    return out


def load_jax_adam_state(mu: dict, nu: dict, count: int, model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> None:
    """Set ``optimizer`` (a ``torch.optim.Adam`` over ``model``'s
    parameters) from optax's ``ScaleByAdamState``: ``exp_avg``/``exp_avg_sq``
    from the moment trees ``mu``/``nu`` (mapped like the params, so ``w``/
    ``v`` are transposed and page-image tables become rows) and every
    parameter's ``step`` from ``count``."""
    exp_avg, exp_avg_sq = from_jax_params(mu, model), from_jax_params(nu, model)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            # torch keeps a non-capturable Adam's step as a CPU float32 scalar
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }


def load_jax_camera_state(pose_vecs, cam_opt: dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX runner's trainable-camera state -> (pose table (V, 7) float32,
    SparseAdam state ``{"m", "v", "step"}`` as ``train/trainer.py:
    sparse_adam_init`` keeps it: moments float32, ``step`` a 0-d int32).
    Rows are quaternion (wxyz) + translation on both sides: no transpose."""
    pose = torch.tensor(np.asarray(pose_vecs, dtype=np.float32))
    state = {"m": torch.tensor(np.asarray(cam_opt["m"], dtype=np.float32)),
             "v": torch.tensor(np.asarray(cam_opt["v"], dtype=np.float32)),
             "step": torch.tensor(int(np.asarray(cam_opt["step"])), dtype=torch.int32)}
    for k in ("m", "v"):
        if state[k].shape != pose.shape:
            raise ValueError(f"cam_opt.{k}: shape {tuple(state[k].shape)} does not fit "
                             f"the pose table's {tuple(pose.shape)}")
    return pose, state
