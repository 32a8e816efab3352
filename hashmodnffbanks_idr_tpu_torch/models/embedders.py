"""Encoders of the flagship path: the pure-torch hash grid with its Fourier
aux features, the style-attention block, Neural Fourier Filter Banks, and
the spherical-harmonics view encoder.

Counterpart of ``hashmodnffbanks_idr_tpu/models/embedders.py`` for the
``FFB``, ``StyleModNFFB`` and ``SHEncoder`` presets.  Parameter names follow the JAX
params tree (``grid.table``, ``grid.ff.B``, ``ff_lin.<i>``, ``out_layer``,
``style.linear_transform``, ``style.attention``) so the weight bridge is a
rename plus transposes.

``fast=True`` is the tracer's mixed-precision path: the grid features and
their frequency encoding are carried in bfloat16, and the small matmuls
round their operands to bfloat16 with float32 accumulation; normalisation
statistics stay float32.

Still to port: the ``HashGrid``/``HashGridNGP``/``PosEnc``/
``FourierFeatures`` embedders.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import encodings as enc
from ..ops import hashgrid as hg
from ..ops.linear import Linear


class FourierFeatureEmbedder(nn.Module):
    """Random Fourier features ``[x, sin(2 pi x B), cos(2 pi x B)]``.  ``B``
    is a trained parameter: it sits in the JAX params tree that the
    optimizer updates."""

    def __init__(self, input_dims: int, num_channels: int, sigma: float,
                 include_input: bool = True):
        super().__init__()
        self.sigma = sigma
        self.include_input = include_input
        self.embeddings_dim = enc.fourier_features_dim(input_dims, num_channels, include_input)
        self.B = nn.Parameter(torch.empty(input_dims, int(num_channels)))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.B.copy_(enc.fourier_features_init(gen, *self.B.shape, self.sigma))

    def forward(self, x):
        return enc.fourier_features(x, self.B, self.include_input)


class HashGridTorchEmbedder(nn.Module):
    """'HashGrid' type, pure-torch semantics (hashGridEmbedding.py:105-155):
    output ``[ff(x) (3 + 2L), levels (L*F)]`` (JAX :117-176)."""

    def __init__(self, in_dim: int, n_levels: int, max_points_per_level: int,
                 log2_hashmap_size: int, base_resolution: int, desired_resolution: int):
        super().__init__()
        self.spec = hg.HashGridSpec(
            input_dim=in_dim, num_levels=n_levels, level_dim=max_points_per_level,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution, variant="torch",
            interpolation="floor", init_std=1e-4)
        self.ff = FourierFeatureEmbedder(
            in_dim, num_channels=n_levels,
            sigma=(math.log(desired_resolution) - math.log(base_resolution))
            / (base_resolution - 1))
        self.table = nn.Parameter(torch.empty(self.spec.padded_total_rows(),
                                              max_points_per_level))
        output_dim = n_levels * max_points_per_level + (self.ff.embeddings_dim - in_dim)
        self.embeddings_dim = in_dim + output_dim
        for name, t in zip(("_level_scales", "_level_sizes", "_level_offsets"),
                           hg.level_constants(self.spec)):
            self.register_buffer(name, t, persistent=False)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.table.copy_(hg.init_table(gen, self.spec))
        self.ff.reset_parameters(gen)

    def forward(self, x):
        grid = hg.hash_encode(x, self.table, self.spec, consts=(
            self._level_scales, self._level_sizes, self._level_offsets))
        return torch.cat([self.ff(x), grid], dim=-1)


def _instance_norm_rows(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm1d on a 2D (N, C) input: per-row normalisation over
    the feature axis (biased variance, no affine), statistics in float32."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


class StyleAttentionBlock(nn.Module):
    """StyleAttention's parameters (styleMod.py:17-44); ``NFFBEmbedder``
    applies it batched over levels.  As run by the reference, the softmax
    over the (N, 1) logits is over a singleton axis, so the weights are
    identically 1 and ``attention`` receives zero gradient; kept literal for
    parity (JAX :274-299)."""

    def __init__(self, d_in: int, feature_vector_size: int):
        super().__init__()
        self.linear_transform = Linear(feature_vector_size, feature_vector_size)
        self.attention = Linear(d_in, 1)

    def reset_parameters(self, gen: torch.Generator):
        self.linear_transform.init_torch_default(gen)
        self.attention.init_torch_default(gen)


class NFFBEmbedder(nn.Module):
    """Neural Fourier Filter Banks on the pure-torch grid, SIREN trunk,
    PositionalEncodingNET frequency encoder, shared out-layer
    (nffb3d.py:24-194; JAX :302-553 with ``grid_backend='torch'``).

    Reference quirks kept: the per-level grid output is 2F wide because the
    ``(N, L, 2F)`` reshape interleaves the Fourier-aux and hash columns (the
    first ``in_dim`` aux columns are dropped); the include-input slot is
    duplicated; the trunk width is twice the encoder's declared width;
    SIREN ``w0 = L^F - L``; the output is divided by L, not by the L-2
    levels used."""

    def __init__(self, *, in_dim: int, n_levels: int, max_points_per_level: int,
                 log2_hashmap_size: int, base_resolution: int,
                 desired_resolution: int, bound: float, style_modulation: bool):
        super().__init__()
        self.bound = bound
        self.n_levels = n_levels
        self.F = max_points_per_level
        self.style_modulation = style_modulation
        self.grid = HashGridTorchEmbedder(
            in_dim, n_levels, max_points_per_level, log2_hashmap_size,
            base_resolution, desired_resolution)
        self.level_width = 2 * max_points_per_level            # nffb3d.py:138
        declared = enc.posenc_declared_dim(max_points_per_level, n_levels, True)
        self.nffb_lin_dims = [in_dim] + [2 * declared] * (n_levels - 1)  # nffb3d.py:67-69
        self.n_nffb_layers = len(self.nffb_lin_dims)
        if self.n_nffb_layers < 3:
            raise ValueError(f"NFFB needs multires >= 3, got {n_levels}")
        self.sin_w0 = float(n_levels**max_points_per_level - n_levels)  # nffb3d.py:83
        self.out_width = self.nffb_lin_dims[-1]
        self.embeddings_dim = self.out_width + in_dim

        self.ff_lin = nn.ModuleList(
            Linear(self.nffb_lin_dims[i], self.nffb_lin_dims[i + 1])
            for i in range(self.n_nffb_layers - 1))
        self.out_layer = Linear(self.out_width, self.out_width)
        if style_modulation:
            self.style = StyleAttentionBlock(in_dim, self.out_width)

        # the frequency encoder's constant per-slot scales and sin phases:
        # slots [x, x] (include-input duplicated, frequency_enc.py:25,45-47),
        # then per band f: [sin(x f), cos(x f)], cos computed as sin(x f + pi/2)
        bands = enc.freq_bands(n_levels, n_levels - 1, True)
        scales = np.asarray([1.0, 1.0] + [b for f in bands for b in (f, f)], np.float32)
        kinds = np.asarray([0, 0] + [v for _ in bands for v in (1, 2)])
        self.register_buffer("_scales", torch.from_numpy(scales), persistent=False)
        self.register_buffer("_phase", torch.from_numpy(
            np.where(kinds == 2, np.float32(np.pi / 2), np.float32(0.0))), persistent=False)
        self.register_buffer("_identity", torch.from_numpy(kinds == 0), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.grid.reset_parameters(gen)
        for i, lin in enumerate(self.ff_lin):
            if i == 0:  # first_layer_sine_init (Sine.py:21-25)
                lin.init_uniform(gen, 1.0 / lin.d_in)
            else:       # sine_init (Sine.py:14-19)
                lin.init_uniform(gen, math.sqrt(6.0 / lin.d_in) / self.sin_w0)
        self.out_layer.init_torch_default(gen)
        if self.style_modulation:
            self.style.reset_parameters(gen)

    def _freq_encode_all(self, grid_x):
        """(N, L, w) -> (N, L, S*w): slot s holds ``scale_s * x`` for identity
        slots and ``sin(scale_s * x + phase_s)`` otherwise (JAX :457-496)."""
        n, L, w = grid_x.shape
        pre = grid_x[:, :, None, :] * self._scales.to(grid_x.dtype)[:, None]  # (N,L,S,w)
        phase = self._phase.to(grid_x.dtype)[:, None]
        emb = torch.where(self._identity[:, None], pre, torch.sin(pre + phase))
        return emb.reshape(n, L, -1)

    def forward(self, inp, fast: bool = False):
        x = inp / self.bound                                   # nffb3d.py:131
        input01 = (inp + self.bound) / (2 * self.bound)

        augmented = self.grid(input01)
        grid_x = augmented[..., inp.shape[-1]:].reshape(-1, self.n_levels, self.level_width)
        if fast:
            grid_x = grid_x.to(torch.bfloat16)

        emb_all = self._freq_encode_all(grid_x)                # (N, L, out_width)
        if self.style_modulation:
            # StyleAttention batched over levels (shared params)
            mod = self.style.linear_transform(emb_all.float(), bf16=fast)
            if fast:
                mod = mod.to(torch.bfloat16)
            weights = torch.softmax(self.style.attention(input01), dim=1)  # == 1.0
            emb_all = _instance_norm_rows(weights[:, None].to(mod.dtype) * mod)

        xs = []
        for layer, lin in enumerate(self.ff_lin):              # SIREN trunk
            x = torch.sin(self.sin_w0 * lin(x, bf16=fast))
            if layer > 0:
                xs.append(x)
        used = len(xs)

        # shared out_layer: sum_l (W e_l + b) == W (sum_l e_l) + used*b
        s = emb_all[:, :used].to(torch.float32).sum(dim=1) + sum(xs)
        acc = self.out_layer(s, bf16=fast)
        if used > 1:
            acc = acc + (used - 1) * self.out_layer.b
        acc = acc / self.n_levels                              # nffb3d.py:187,193
        return torch.cat([input01, acc], dim=-1)


class SHEmbedder(nn.Module):
    """Spherical-harmonics view-direction encoder (frequency_enc.py:70-152;
    JAX :101-110): ``degree**2`` outputs, no parameters."""

    def __init__(self, input_dims: int = 3, degree: int = 4):
        super().__init__()
        if input_dims != 3:
            raise ValueError(f"SH encodes 3-d directions, got input_dims={input_dims}")
        self.degree = degree
        self.embeddings_dim = degree**2

    def reset_parameters(self, gen: torch.Generator):
        pass

    def forward(self, x, fast: bool = False):
        return enc.spherical_harmonics(x, self.degree)


def build_embedder(embed_type: str, input_dims: int, multires: int,
                   log2_max_hash_size: int, max_points_per_entry: int,
                   base_resolution: int, desired_resolution: int, bound: float,
                   **overrides) -> nn.Module:
    """The reference factory's ``FFB``/``StyleModNFFB`` presets
    (custom_embedder_decoder.py:147-155; JAX :560-592) and ``SHEncoder``
    with its preset degree 4 (JAX :637-638)."""
    if embed_type == "SHEncoder":
        return SHEmbedder(input_dims, degree=overrides.get("degree", 4))
    if embed_type not in ("FFB", "StyleModNFFB"):
        raise NotImplementedError(f"embedder {embed_type!r} is not ported yet")
    if overrides.get("grid_interpolation") not in (None, "floor"):
        raise NotImplementedError("only floor grid interpolation is ported")
    return NFFBEmbedder(
        in_dim=input_dims, n_levels=multires, max_points_per_level=max_points_per_entry,
        log2_hashmap_size=log2_max_hash_size, base_resolution=base_resolution,
        desired_resolution=desired_resolution, bound=bound,
        style_modulation=(embed_type == "StyleModNFFB"))
