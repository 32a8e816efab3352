"""The encoder family and its factory: positional encoding, random Fourier
features, the pure-torch and the instant-ngp hash grids, the style-attention
block, Neural Fourier Filter Banks on either grid, and spherical harmonics.

Counterpart of ``hashmodnffbanks_idr_tpu/models/embedders.py``; ``build_embedder``
takes every ``embed_type`` the JAX factory takes, with its presets and
overrides.  Parameter names follow the JAX params tree (``grid.table``,
``grid.ff.B``, ``ff_lin.<i>``, ``out_layer``, ``style.linear_transform``,
``style.attention``, ``table``, ``B``) so the weight bridge is a rename plus
transposes.

Every embedder's ``forward`` takes ``fast``: the tracer's mixed-precision
path.  The NFFB grid features and their frequency encoding are then carried
in bfloat16 and its small matmuls round their operands to bfloat16 with
float32 accumulation (normalisation statistics stay float32); a hash grid
rounds its looked-up values to bfloat16 where the JAX package's page path
does.  Encoders without a grid ignore it, as the JAX package's ``_embed``
does for those whose ``apply`` takes no ``fast``.  ``tv_loss(x)`` is the grid
total variation, or None for encoders without a grid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import encodings as enc
from ..ops import hashgrid as hg
from ..ops import nffb_encode
from ..ops.linear import Linear


class PosEncEmbedder(nn.Module):
    """'NerfPos' preset (custom_embedder_decoder.py:74-81; JAX :64-79):
    ``[x, x, sin/cos bands]`` with ``num_freqs = multires`` bands up to
    ``2^max_freq_log2``; the declared width sizes the first layer."""

    def __init__(self, input_dims: int, num_freqs: int, max_freq_log2: float):
        super().__init__()
        self.num_freqs = num_freqs
        self.max_freq_log2 = max_freq_log2
        self.embeddings_dim = enc.posenc_declared_dim(input_dims, num_freqs, True)

    def reset_parameters(self, gen: torch.Generator):
        pass

    def forward(self, x, fast: bool = False):
        return enc.positional_encoding(x, self.num_freqs, self.max_freq_log2)

    def tv_loss(self, x):
        return None


class FourierFeatureEmbedder(nn.Module):
    """Random Fourier features ``[x, sin(2 pi x B), cos(2 pi x B)]`` (JAX
    :82-98).  ``B`` is a trained parameter: it sits in the JAX params tree
    that the optimizer updates."""

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

    def forward(self, x, fast: bool = False):
        return enc.fourier_features(x, self.B, self.include_input)

    def tv_loss(self, x):
        return None


class _GridEmbedder(nn.Module):
    """A hash table ``table`` of ``spec`` with the spec's per-level constants
    kept as buffers (one host-to-device copy at build time)."""

    def _init_grid(self, spec: hg.HashGridSpec):
        self.spec = spec
        self.table = nn.Parameter(torch.empty(spec.padded_total_rows(), spec.level_dim))
        for name, t in zip(hg.GridConstants._fields, hg.level_constants(spec)):
            self.register_buffer(f"_grid_{name}", t, persistent=False)

    def _consts(self) -> hg.GridConstants:
        return hg.GridConstants(*(getattr(self, f"_grid_{name}")
                                  for name in hg.GridConstants._fields))


class HashGridTorchEmbedder(_GridEmbedder):
    """'HashGrid' type, pure-torch semantics (hashGridEmbedding.py:105-155;
    JAX :117-176): output ``[ff(x) (3 + 2L), levels (L*F)]`` (the factory
    and NFFB always include the input).  ``interpolation='floor'`` is the
    reference's degenerate floor-corner lookup, 'linear' the corrected
    trilinear one."""

    def __init__(self, in_dim: int, n_levels: int, max_points_per_level: int,
                 log2_hashmap_size: int, base_resolution: int, desired_resolution: int,
                 interpolation: str = "floor"):
        super().__init__()
        self._init_grid(hg.HashGridSpec(
            input_dim=in_dim, num_levels=n_levels, level_dim=max_points_per_level,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution, variant="torch",
            interpolation=interpolation, init_std=1e-4))
        self.ff = FourierFeatureEmbedder(
            in_dim, num_channels=n_levels,
            sigma=(math.log(desired_resolution) - math.log(base_resolution))
            / (base_resolution - 1))
        output_dim = n_levels * max_points_per_level + (self.ff.embeddings_dim - in_dim)
        self.embeddings_dim = in_dim + output_dim

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.table.copy_(hg.init_table(gen, self.spec))
        self.ff.reset_parameters(gen)

    def forward(self, x, fast: bool = False):
        grid = hg.hash_encode(x, self.table, self.spec, zero_oob=False, inference=fast,
                              consts=self._consts())
        return torch.cat([self.ff(x), grid], dim=-1)

    def tv_loss(self, x):
        return hg.total_variation_loss(x, self.table, self.spec, self._consts())


class HashGridNGPEmbedder(_GridEmbedder):
    """instant-ngp-semantics grid behind 'HashGridTcnn' and 'HashGridCUDA'
    (JAX :178-261).  ``input_range='raw'`` feeds x unmapped (the Tcnn
    wrapper, hashGridEncoderTcnn.py:89-93); 'unit' maps [-size, size] to
    [0, 1] and zeroes out-of-bound samples (hashgridencoder.py:126-142).
    Output ``[head (D), levels (L*F)]``, ``head`` being the (mapped) input
    (the factory and NFFB always include it).  Every preset of the factory
    sets ``per_level_scale`` 2 (read when ``desired_resolution`` is None)
    and draws the table from U(+-1e-4)."""

    def __init__(self, in_dim: int, n_levels: int, max_points_per_level: int,
                 log2_hashmap_size: int, base_resolution: int,
                 desired_resolution: Optional[int], input_range: str = "raw",
                 size: float = 0.5, gridtype: str = "hash", interpolation: str = "linear",
                 align_corners: bool = False):
        super().__init__()
        if input_range not in ("raw", "unit"):
            raise ValueError(f"input_range={input_range!r}")
        self.input_range = input_range
        self.size = size
        self._init_grid(hg.HashGridSpec(
            input_dim=in_dim, num_levels=n_levels, level_dim=max_points_per_level,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            per_level_scale=2.0, desired_resolution=desired_resolution, variant="ngp",
            gridtype=gridtype, interpolation=interpolation, align_corners=align_corners,
            init_std=1e-4))
        self.embeddings_dim = n_levels * max_points_per_level + in_dim

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.table.copy_(hg.init_table(gen, self.spec))

    def forward(self, x, fast: bool = False, max_level: Optional[int] = None,
                fill: Optional[torch.Tensor] = None, floor_interp: bool = False):
        """``max_level``/``fill``: the level-pruned guidance encode (the
        ``max_level`` coarsest levels, the rest ``fill``); ``floor_interp``:
        the floor corner only.  Both serve approximate tracer guidance."""
        spec = self.spec
        if floor_interp and spec.interpolation != "floor":
            spec = dataclasses.replace(spec, interpolation="floor")
        if max_level is not None and max_level >= spec.num_levels:
            max_level = None
        head = (x + self.size) / (2 * self.size) if self.input_range == "unit" else x
        grid = hg.hash_encode(head, self.table, spec, zero_oob=self.input_range == "unit",
                              inference=fast, max_level=max_level, fill=fill,
                              consts=self._consts())
        return torch.cat([head, grid], dim=-1)

    def level_fill(self) -> torch.Tensor:
        """Per-level mean features (L, C), the fill of pruned levels."""
        return hg.level_means(self.table, self.spec)

    def tv_loss(self, x):
        if self.input_range == "unit":
            x = torch.clamp((x + self.size) / (2 * self.size), 0.0, 1.0)
        return hg.total_variation_loss(x, self.table, self.spec, self._consts())


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
    """Neural Fourier Filter Banks, SIREN trunk, PositionalEncodingNET
    frequency encoder, shared out-layer (nffb3d.py:24-194; JAX :302-553).

    ``grid_backend='torch'`` ('FFB'/'StyleModNFFB'): the pure-torch grid; its
    per-level output is 2F wide because the ``(N, L, 2F)`` reshape interleaves
    the Fourier-aux and hash columns (the first ``in_dim`` aux columns are
    dropped), and the trunk width is twice the encoder's declared width.
    ``grid_backend='ngp'`` ('FFBTcnn', FFB_encoder.py:23-255): the ngp grid,
    per-level width F, no doubling.  Quirks kept: the include-input slot is
    duplicated; SIREN ``w0 = L^F - L``; the output is divided by L, not by
    the L-2 levels used.

    A gradient-free query on a CUDA tensor (the tracer's, eval's) runs as one
    kernel (``ops/nffb_encode.py``) where ``fused_encode``: the torch grid
    with floor interpolation or the ngp grid with linear (trilinear)
    interpolation, at a shape the kernel is built for.  Everything else,
    autograd and the CPU included, runs the plain forward below, the
    kernel's plain twin."""

    def __init__(self, *, in_dim: int, n_levels: int, max_points_per_level: int,
                 log2_hashmap_size: int, base_resolution: int,
                 desired_resolution: int, bound: float, style_modulation: bool,
                 grid_backend: str = "torch", grid_interpolation: Optional[str] = None):
        super().__init__()
        self.bound = bound
        self.grid_backend = grid_backend
        self.n_levels = n_levels
        self.F = max_points_per_level
        self.style_modulation = style_modulation
        if grid_backend == "torch":
            self.grid = HashGridTorchEmbedder(
                in_dim, n_levels, max_points_per_level, log2_hashmap_size,
                base_resolution, desired_resolution,
                interpolation=grid_interpolation or "floor")
            self.level_width = 2 * max_points_per_level        # nffb3d.py:138
        elif grid_backend == "ngp":
            self.grid = HashGridNGPEmbedder(
                in_dim, n_levels, max_points_per_level, log2_hashmap_size,
                base_resolution, desired_resolution, input_range="raw",
                interpolation=grid_interpolation or "linear")
            self.level_width = max_points_per_level            # FFB_encoder.py:146
        else:
            raise ValueError(f"grid_backend={grid_backend!r}")
        declared = enc.posenc_declared_dim(max_points_per_level, n_levels, True)
        mult = 2 if grid_backend == "torch" else 1  # nffb3d.py:67-69 vs FFB_encoder.py:74-77
        self.nffb_lin_dims = [in_dim] + [mult * declared] * (n_levels - 1)
        self.n_nffb_layers = len(self.nffb_lin_dims)
        if self.n_nffb_layers < 3:
            raise ValueError(f"NFFB needs multires >= 3, got {n_levels}")
        self.sin_w0 = float(n_levels**max_points_per_level - n_levels)  # nffb3d.py:83
        self.out_width = self.nffb_lin_dims[-1]
        self.embeddings_dim = self.out_width + in_dim
        self.fused_encode = nffb_encode.supports(self)

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

    def tv_loss(self, inp):
        return self.grid.tv_loss((inp + self.bound) / (2 * self.bound))  # nffb3d.py:132

    def takes_kernel(self, inp) -> bool:
        """Whether ``forward(inp)`` runs the encode kernel: a CUDA input,
        no autograd, and a module the kernel is built for."""
        return self.fused_encode and inp.is_cuda and not torch.is_grad_enabled()

    def forward(self, inp, fast: bool = False):
        if self.takes_kernel(inp):
            return nffb_encode.encode(self, inp.contiguous(), fast)
        x = inp / self.bound                                   # nffb3d.py:131
        input01 = (inp + self.bound) / (2 * self.bound)

        augmented = self.grid(input01, fast=fast)
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

    def tv_loss(self, x):
        return None


def build_embedder(embed_type: str, input_dims: int, multires: int,
                   log2_max_hash_size: int, max_points_per_entry: int,
                   base_resolution: int, desired_resolution: Optional[int], bound: float,
                   network_dims: Optional[Sequence[int]] = None, **overrides) -> nn.Module:
    """``embed_type`` -> the configured encoder with the reference factory's
    presets (custom_embedder_decoder.py:13-164; JAX :560-639).
    ``network_dims`` (the MLP's widths) is read by 'FourierFeatures' only,
    whose channel count is ``network_dims[0]``."""
    if embed_type == "HashGrid":
        return HashGridTorchEmbedder(
            input_dims, multires, max_points_per_entry, log2_max_hash_size,
            base_resolution, desired_resolution,
            interpolation=overrides.get("interpolation", "floor"))
    if embed_type in ("FFB", "StyleModNFFB"):
        return NFFBEmbedder(
            in_dim=input_dims, n_levels=multires, max_points_per_level=max_points_per_entry,
            log2_hashmap_size=log2_max_hash_size, base_resolution=base_resolution,
            desired_resolution=desired_resolution, bound=bound,
            style_modulation=(embed_type == "StyleModNFFB"), grid_backend="torch",
            grid_interpolation=overrides.get("grid_interpolation"))
    if embed_type == "FFBTcnn":
        return NFFBEmbedder(
            in_dim=input_dims, n_levels=multires, max_points_per_level=max_points_per_entry,
            log2_hashmap_size=log2_max_hash_size, base_resolution=base_resolution,
            desired_resolution=desired_resolution, bound=bound,
            style_modulation=overrides.get("style_modulation", True),  # 'FFB_TCNN' preset
            grid_backend="ngp", grid_interpolation=overrides.get("grid_interpolation"))
    if embed_type == "NerfPos":
        return PosEncEmbedder(input_dims, num_freqs=multires, max_freq_log2=log2_max_hash_size)
    if embed_type == "FourierFeatures":
        if network_dims is None:
            raise ValueError("FourierFeatures takes its channel count from network_dims[0]")
        return FourierFeatureEmbedder(input_dims, num_channels=list(network_dims)[0],
                                      sigma=1.0, include_input=True)
    if embed_type in ("HashGridTcnn", "HashGridCUDA", "MultiResHashEncoderCUDA"):
        unit = embed_type != "HashGridTcnn"
        return HashGridNGPEmbedder(
            input_dims, multires, max_points_per_entry, log2_max_hash_size,
            base_resolution, desired_resolution, input_range="unit" if unit else "raw",
            size=overrides.get("size", 0.5) if unit else 0.5,
            gridtype=overrides.get("gridtype", "hash"),
            interpolation=overrides.get("interpolation", "linear"),
            align_corners=overrides.get("align_corners", False) if unit else False)
    if embed_type == "SHEncoder":
        return SHEmbedder(input_dims, degree=overrides.get("degree", 4))
    raise ValueError(f"Not a valid embedding model type: {embed_type!r}")
