"""SDF (implicit) and rendering networks + the Laplace density clamp.

Counterpart of ``hashmodnffbanks_idr_tpu/models/networks.py``.  The SDF's
spatial gradient is ``torch.autograd.grad(..., create_graph=True)`` so the
eikonal term can differentiate it again with respect to the parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import fused_mlp as fm
from ..ops.linear import Linear, softplus
from .embedders import SHEmbedder, build_embedder


class LaplaceDensity(nn.Module):
    """``alpha * Laplace(0, beta).cdf(-sdf)``, used only inside the SDF clamp.
    The reference evaluates it under ``torch.no_grad()`` (density_net.py:20),
    so beta is a stored parameter that never receives gradient."""

    def __init__(self, beta_init: float = 0.9, beta_min: float = 1e-4):
        super().__init__()
        self.beta_min = beta_min
        self.beta = nn.Parameter(torch.tensor(beta_init))

    def forward(self, sdf):
        with torch.no_grad():
            beta = torch.abs(self.beta) + self.beta_min
            alpha = 1.0 / beta
            return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


class ImplicitNetwork(nn.Module):
    """The SDF + feature MLP (impl..._renderer.py:11-128): weight-normed
    softplus(beta=100) layers, skip concat divided by sqrt(2), and the
    SDF clamp ``tanh(raw / (2 + density))``."""

    def __init__(self, feature_vector_size: int, d_in: int, d_out: int,
                 dims: Sequence[int], geometric_init: bool = True, bias: float = 1.0,
                 skip_in: Sequence[int] = (), weight_norm: bool = True,
                 multires: int = 0, embed_type: Optional[str] = None,
                 log2_max_hash_size: int = 10, max_points_per_entry: int = 2,
                 base_resolution: int = 64, desired_resolution: Optional[int] = None,
                 bound: float = 1.0, **embed_overrides):
        super().__init__()
        dims = [d_in] + list(dims) + [d_out + feature_vector_size]
        self.embedder = None
        if embed_type and multires > 0:
            self.embedder = build_embedder(
                embed_type, input_dims=d_in, multires=multires,
                log2_max_hash_size=log2_max_hash_size,
                max_points_per_entry=max_points_per_entry,
                base_resolution=base_resolution,
                desired_resolution=desired_resolution, bound=bound, **embed_overrides)
            dims[0] = self.embedder.embeddings_dim
        self.dims = dims
        self.num_layers = len(dims)
        self.skip_in = tuple(skip_in)
        self.geometric_init = geometric_init
        self.bias = bias
        self.multires = multires
        self.lin = nn.ModuleList()
        for l in range(self.num_layers - 1):
            out_dim = dims[l + 1] - dims[0] if l + 1 in self.skip_in else dims[l + 1]
            self.lin.append(Linear(dims[l], out_dim, weight_norm=weight_norm))
        self.density = LaplaceDensity(beta_init=0.9)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        if self.embedder is not None:
            self.embedder.reset_parameters(gen)
        for l, lin in enumerate(self.lin):
            if not self.geometric_init:
                lin.init_torch_default(gen)
                continue
            # geometric sphere init (impl..._renderer.py:64-78; JAX :138-158)
            std = math.sqrt(2) / math.sqrt(lin.d_out)
            if l == self.num_layers - 2:
                lin.init_normal(gen, mean=math.sqrt(math.pi) / math.sqrt(lin.d_in),
                                std=1e-4, bias=-self.bias)
            elif self.multires > 0 and l == 0:
                lin.init_normal(gen, 0.0, std, 0.0, zero_inputs=slice(3, None))
            elif self.multires > 0 and l in self.skip_in and self.dims[0] > 3:
                lin.init_normal(gen, 0.0, std, 0.0,
                                zero_inputs=slice(lin.d_in - (self.dims[0] - 3), None))
            else:
                lin.init_normal(gen, 0.0, std, 0.0)

    def _embed(self, x, fast: bool = False):
        return x if self.embedder is None else self.embedder(x, fast=fast)

    def forward(self, x: torch.Tensor, fast: bool = False) -> torch.Tensor:
        """x (N, 3) -> (N, 1 + feature_vector_size); channel 0 is the clamped
        SDF.  ``fast=True`` is the bf16-operand path (tracer guidance only)."""
        inp = self._embed(x, fast)
        h = inp
        for l, lin in enumerate(self.lin):
            if l in self.skip_in:
                h = torch.cat([h, inp], dim=1) / math.sqrt(2)
            h = lin(h, bf16=fast)
            if l < self.num_layers - 2:
                h = softplus(h, beta=100.0)
        return self._clamp(h)

    def _clamp(self, h):
        """SDF clamp (impl..._renderer.py:106-112): tanh(raw / (2 + dens))
        with a gradient-stopped density; features pass through."""
        raw = h[..., 0]
        sdf = torch.tanh(raw / (2.0 + self.density(raw)))
        return torch.cat([sdf[..., None], h[..., 1:]], dim=-1)

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)[..., 0]

    @torch.no_grad()
    def make_fast_sdf(self, precision: str = "bf16"):
        """SDF closure for the gradient-free tracer (JAX :236-320, without
        level pruning).  For the standard 8x512 skip-4 architecture it packs
        the weights once and runs ``ops.fused_mlp.fused_sdf_raw`` (the CUDA
        kernel on a CUDA tensor, its plain twin on a CPU one); other
        architectures run the layer chain with bf16 or f32 operands.
        ``precision='f32'`` is the same math as :meth:`sdf`."""
        if precision not in ("bf16", "f32"):
            raise ValueError(precision)
        bf16 = precision == "bf16"

        if not fm.supports_fusion(self.dims, self.skip_in):
            return lambda x: self(x, fast=bf16)[..., 0]

        packed = fm.pack_params(self.lin, self.dims[0], self.dims[1],
                                dtype=torch.bfloat16 if bf16 else torch.float32)

        def sdf_fused(x):
            raw = fm.fused_sdf_raw(self._embed(x, bf16), packed)
            return torch.tanh(raw / (2.0 + self.density(raw)))

        return sdf_fused

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        """Per-point d sdf / d x, differentiable again for the second-order
        eikonal term (JAX :322-328).  Under ``torch.no_grad()`` (the eval
        render) it still takes the gradient, but keeps no graph past this
        call; the numbers are the same."""
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            y = self.sdf(x)
            (g,) = torch.autograd.grad(y, x, grad_outputs=torch.ones_like(y),
                                       create_graph=create_graph)
        return g


class RenderingNetwork(nn.Module):
    """Appearance MLP (impl..._renderer.py:130-223) in 'idr' mode.  View
    directions go through SH of degree ``multires_view`` for
    ``SHEncoder`` (built directly, not through the factory, as JAX
    models/networks.py:355-358 does), else through a deep embedder whose
    settings are hard-coded as in the reference (impl..._renderer.py:163-184)."""

    def __init__(self, feature_vector_size: int, mode: str, d_in: int, d_out: int,
                 dims: Sequence[int], weight_norm: bool = True, multires_view: int = 0,
                 viewdirs_embed_type: str = "NerfPos", **embed_overrides):
        super().__init__()
        if mode != "idr":
            raise NotImplementedError(f"rendering mode {mode!r} is not ported yet")
        dims = [d_in + feature_vector_size] + list(dims) + [d_out]
        self.view_embedder = None
        if multires_view > 0 and viewdirs_embed_type == "SHEncoder":
            self.view_embedder = SHEmbedder(3, degree=multires_view)
            dims[0] += self.view_embedder.embeddings_dim - 3
        elif multires_view > 0:
            self.view_embedder = build_embedder(
                viewdirs_embed_type, input_dims=3, multires=multires_view,
                log2_max_hash_size=multires_view - 1, max_points_per_entry=2,
                base_resolution=16, desired_resolution=512, bound=1.0, **embed_overrides)
            dims[0] += self.view_embedder.embeddings_dim - 3
        self.dims = dims
        self.num_layers = len(dims)
        self.lin = nn.ModuleList(Linear(dims[l], dims[l + 1], weight_norm=weight_norm)
                                 for l in range(self.num_layers - 1))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        if self.view_embedder is not None:
            self.view_embedder.reset_parameters(gen)
        for lin in self.lin:
            lin.init_torch_default(gen)

    def forward(self, points, normals, view_dirs, feature_vectors):
        if self.view_embedder is not None:
            view_dirs = self.view_embedder(view_dirs)
        h = torch.cat([points, view_dirs, normals, feature_vectors], dim=-1)
        for l, lin in enumerate(self.lin):
            h = lin(h)
            if l < self.num_layers - 2:
                h = torch.relu(h)
        return torch.tanh(h)
