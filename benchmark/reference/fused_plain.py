"""The fused SDF-MLP's math in plain torch ops, for the tracer of the
reference: a frozen copy of the plain parts of the port's
``hashmodnffbanks_idr_tpu_torch/ops/fused_mlp.py`` (``supports_fusion``,
``pack_params`` without the bf16 kernel's weight image,
``fused_sdf_raw_plain``).  ``fused_sdf_raw`` always runs the plain twin:
each layer rounds its input to the weight type (bf16 for the guidance,
float32 for the exact tracer) and accumulates in float32."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .linear import Linear, softplus

N_MID = 7              # l1..l7
SKIP_AFTER_MID = 2     # the skip concat follows l3 = mid layer 2


def supports_fusion(dims: List[int], skip_in: Tuple[int, ...]) -> bool:
    """The standard IDR architecture: uniform hidden width, single skip at
    4, d_in < hidden."""
    if len(dims) != 10 or tuple(skip_in) != (4,):
        return False
    h = dims[1]
    if any(d != h for d in dims[1:-1]):
        return False
    return dims[0] < h and h % 128 == 0


@torch.no_grad()
def pack_params(lins: List[Linear], d_in: int, hidden: int,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Effective weights of the nine layers, input-major, in ``dtype``;
    biases float32; l3 zero-padded to ``hidden`` columns; the last layer's
    SDF column only."""
    def w_of(l):
        return lins[l].weight().detach().T

    mids_w, mids_b = [], []
    for l in range(1, 1 + N_MID):
        w, b = w_of(l), lins[l].b.detach()
        if w.shape[1] != hidden:
            w = torch.nn.functional.pad(w, (0, hidden - w.shape[1]))
            b = torch.nn.functional.pad(b, (0, hidden - b.shape[0]))
        mids_w.append(w.to(dtype))
        mids_b.append(b)
    w_last = w_of(1 + N_MID)
    return {
        "w_in": w_of(0).to(dtype).contiguous(),
        "b_in": lins[0].b.detach().float().contiguous(),
        "w_mid": torch.stack(mids_w).contiguous(),
        "b_mid": torch.stack(mids_b).float().contiguous(),
        "w_out": w_last[:, 0].to(dtype).contiguous(),
        "b_out": lins[1 + N_MID].b.detach()[:1].float().contiguous(),
    }


def fused_sdf_raw(x: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (N, d_in) f32 -> raw SDF (N,)."""
    d_in = x.shape[1]
    wd = packed["w_in"].dtype
    hidden = packed["w_in"].shape[1]
    skip_cols = hidden - d_in
    inv_sqrt2 = 1.0 / math.sqrt(2.0)

    def dot(h, w):
        return h.to(wd).float() @ w.float()

    h = softplus(dot(x, packed["w_in"]) + packed["b_in"])
    for l in range(packed["w_mid"].shape[0]):
        h = softplus(dot(h, packed["w_mid"][l]) + packed["b_mid"][l])
        if l == SKIP_AFTER_MID:
            tail = x.to(wd).float() * inv_sqrt2
            h = torch.cat([h[:, :skip_cols] * inv_sqrt2, tail], dim=1)
    return dot(h, packed["w_out"][:, None])[:, 0] + packed["b_out"][0]
