"""Reference-checkpoint importer: the reference's ``.pth`` state dicts -> the
port's ``IDRNetwork`` state dict and (V, 7) pose table.

Counterpart of ``hashmodnffbanks_idr_tpu/train/torch_import.py``.  The
reference saves ``{"epoch": N, "model_state_dict": model.state_dict()}``
(idr_train.py:182-209) under ModelParameters/, and trainable cameras as
``{"epoch": N, "pose_vecs_state_dict": {"weight": (n_images, 7)}}`` under
CamParameters/.  Its model's keys (implicit_differentiable_renderer.py):

  implicit_network.lin{l}.{weight_v,weight_g,bias}   (weight-norm Linear)
  implicit_network.dencity_net.beta                 (LaplaceDensity)
  implicit_network.embed_model.embedder_obj.*       (the encoder, per type)
  rendering_network.lin{l}.{weight_v,weight_g,bias}
  rendering_network.embed_model.embedder_obj.*      (deep view encoders)

Both sides store a Linear's weight as (out, in), so nothing is transposed
here.  Encoders the reference gives no parameters (positional encoding,
SH) and the instant-ngp grid keep the model's own values, as in the JAX
importer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models import embedders as emb


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` -> {key: np.ndarray}, unwrapping
    ``model_state_dict`` / ``pose_vecs_state_dict``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "pose_vecs_state_dict"):
        if isinstance(blob, dict) and key in blob:
            blob = blob[key]
            break
    return {k: np.asarray(v.detach() if hasattr(v, "detach") else v)
            for k, v in blob.items()}


def import_pose_vecs(sd: Dict[str, np.ndarray]) -> torch.Tensor:
    """A CamParameters state dict -> the (n_images, 7) quaternion (wxyz) +
    translation table, float32."""
    return torch.tensor(np.asarray(sd["weight"], dtype=np.float32))


def _put(out: Dict[str, torch.Tensor], name: str, value: np.ndarray) -> None:
    value = torch.tensor(np.asarray(value, dtype=np.float32))
    if name not in out:
        raise KeyError(f"{name!r} is not a parameter of the model")
    want = out[name].shape
    if value.shape != want:
        if value.squeeze().shape != out[name].squeeze().shape:
            raise ValueError(f"{name}: reference shape {tuple(value.shape)} does not fit "
                             f"{tuple(want)}")
        value = value.reshape(want)  # weight_g (out, 1), beta (1,)
    out[name] = value


def _import_linear(sd, prefix: str, ours: str, out) -> None:
    if f"{ours}.v" in out:
        _put(out, f"{ours}.v", sd[f"{prefix}.weight_v"])
        _put(out, f"{ours}.g", sd[f"{prefix}.weight_g"].reshape(-1))
    else:
        _put(out, f"{ours}.w", sd[f"{prefix}.weight"])
    _put(out, f"{ours}.b", sd[f"{prefix}.bias"])


def _import_torch_hashgrid(sd, prefix: str, grid: emb.HashGridTorchEmbedder, ours: str,
                           out) -> None:
    """``levels.{l}.embedding.weight`` -> the level's rows of the table;
    ``freq_encoding.B`` -> the grid's Fourier ``B``."""
    offs = grid.spec.offsets()
    table = out[f"{ours}.table"].clone()
    for l in range(grid.spec.num_levels):
        w = torch.tensor(np.asarray(sd[f"{prefix}.levels.{l}.embedding.weight"],
                                    dtype=np.float32))
        table[offs[l]:offs[l] + len(w)] = w
    out[f"{ours}.table"] = table
    _put(out, f"{ours}.ff.B", sd[f"{prefix}.freq_encoding.B"])


def _import_embedder(sd, prefix: str, embedder: nn.Module, ours: str, out) -> None:
    if isinstance(embedder, emb.FourierFeatureEmbedder):
        _put(out, f"{ours}.B", sd[f"{prefix}.B"])
    elif isinstance(embedder, emb.HashGridTorchEmbedder):
        _import_torch_hashgrid(sd, prefix, embedder, ours, out)
    elif isinstance(embedder, emb.NFFBEmbedder):
        if isinstance(embedder.grid, emb.HashGridTorchEmbedder):
            _import_torch_hashgrid(sd, f"{prefix}.grid_enc", embedder.grid, f"{ours}.grid", out)
        for l in range(embedder.n_nffb_layers - 1):
            _import_linear(sd, f"{prefix}.ff_lin{l}", f"{ours}.ff_lin.{l}", out)
        _import_linear(sd, f"{prefix}.out_layer", f"{ours}.out_layer", out)
        if embedder.style_modulation:
            for part in ("linear_transform", "attention"):
                _import_linear(sd, f"{prefix}.StyleAttentionBlock.{part}",
                               f"{ours}.style.{part}", out)


def import_model_state(sd: Dict[str, np.ndarray], model: nn.Module) -> Dict[str, torch.Tensor]:
    """A reference IDRNetwork state dict -> a state dict for the port's
    ``model`` (an ``IDRNetwork``): its current values, with every tensor the
    reference holds put in place."""
    out = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for net in ("implicit_network", "rendering_network"):
        for l in range(len(getattr(model, net).lin)):
            _import_linear(sd, f"{net}.lin{l}", f"{net}.lin.{l}", out)
    if "implicit_network.dencity_net.beta" in sd:
        _put(out, "implicit_network.density.beta", sd["implicit_network.dencity_net.beta"])
    for net, attr in (("implicit_network", "embedder"), ("rendering_network", "view_embedder")):
        embedder = getattr(getattr(model, net), attr, None)
        if embedder is not None:
            _import_embedder(sd, f"{net}.embed_model.embedder_obj", embedder,
                             f"{net}.{attr}", out)
    return out


def import_checkpoint(path: str, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Load a ModelParameters ``.pth`` and import it for ``model``."""
    return import_model_state(load_pth(path), model)

