"""Frozen copy of the port's ``hashmodnffbanks_idr_tpu_torch/ops/linear.py`` for the
benchmark's plain reference; it imports nothing of the port (changes: the init helpers draw on the generator's device).

Linear-layer primitives: explicit weight norm, torch-style init schemes.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/linear.py``.  Weights are stored
the ``nn.Linear`` way, ``(out, in)``; the JAX package stores ``(in, out)``
(``weights.from_jax_params`` transposes).  Weight norm is kept explicit as
``{v, g, b}`` with ``W = g * v / max(||v||, 1e-12)``, the norm taken per
output unit (over the input axis) as ``torch.nn.utils.weight_norm(dim=0)``
does in the reference.

Init helpers draw from an explicit ``torch.Generator``; they follow the JAX
package's schemes, not its numbers (the two frameworks' generators differ).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: the operand rounding of a bf16 matmul with
    float32 accumulation (JAX ``preferred_element_type=f32``)."""
    return x.to(torch.bfloat16).to(torch.float32)


class Linear(nn.Module):
    """``y = x W^T + b`` with either a plain weight ``w`` or the weight-norm
    pair ``v``/``g``.  Parameters start uninitialised; use the init helpers."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool = False):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(d_out, d_in))
            self.g = nn.Parameter(torch.empty(d_out))
        else:
            self.w = nn.Parameter(torch.empty(d_out, d_in))
        self.b = nn.Parameter(torch.empty(d_out))

    def weight(self) -> torch.Tensor:
        """Effective ``(out, in)`` weight (JAX ``apply_linear``, :60-65)."""
        if self.weight_norm:
            norm = torch.linalg.vector_norm(self.v, dim=1, keepdim=True)
            return self.v * (self.g[:, None] / torch.clamp_min(norm, 1e-12))
        return self.w

    def forward(self, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        """``bf16=True`` rounds both operands to bfloat16 and accumulates in
        float32 (the tracer's mixed-precision fast path); the result is f32."""
        w = self.weight()
        if bf16:
            return bf16_round(x) @ bf16_round(w).T + self.b
        return x @ w.T + self.b

    # -- init schemes (JAX ops/linear.py:21-52) ----------------------------
    @torch.no_grad()
    def _set(self, w: torch.Tensor, b: torch.Tensor) -> "Linear":
        if self.weight_norm:
            self.v.copy_(w)
            self.g.copy_(torch.linalg.vector_norm(w, dim=1))
        else:
            self.w.copy_(w)
        self.b.copy_(b)
        return self

    def init_torch_default(self, gen: torch.Generator) -> "Linear":
        """``nn.Linear`` default: U(+-1/sqrt(in)) for weight and bias."""
        bound = 1.0 / math.sqrt(self.d_in)
        return self.init_uniform(gen, bound)

    def init_uniform(self, gen: torch.Generator, bound: float,
                     bias_bound: float | None = None) -> "Linear":
        bias_bound = bound if bias_bound is None else bias_bound
        w = (torch.rand(self.d_out, self.d_in, generator=gen, device=gen.device) * 2 - 1) * bound
        b = (torch.rand(self.d_out, generator=gen, device=gen.device) * 2 - 1) * bias_bound
        return self._set(w, b)

    def init_normal(self, gen: torch.Generator, mean: float, std: float,
                    bias: float, zero_inputs: slice | None = None) -> "Linear":
        """N(mean, std) weight, constant bias; ``zero_inputs`` zeroes those
        input columns before the weight-norm ``g`` is taken (geometric init)."""
        w = mean + std * torch.randn(self.d_out, self.d_in, generator=gen, device=gen.device)
        if zero_inputs is not None:
            w[:, zero_inputs] = 0.0
        return self._set(w, torch.full((self.d_out,), float(bias), device=gen.device))


def softplus(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """torch ``Softplus(beta)`` with its linear region for ``beta*x > 20``,
    written as the JAX package writes it (ops/linear.py:73-77)."""
    bx = beta * x
    return torch.where(bx > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(bx, max=20.0))) / beta)
