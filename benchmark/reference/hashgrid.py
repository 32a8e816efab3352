"""Frozen copy of the port's ``hashmodnffbanks_idr_tpu_torch/ops/hashgrid.py`` for the
benchmark's plain reference; it imports nothing of the port (changes: the table drawn on the generator's device).

Multi-resolution hash-grid encoding.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/hashgrid.py`` for both of its
variants:

  * ``variant='ngp'``: instant-ngp semantics (hashencoder.cu:125-200 of the
    reference): ``scale = 2^(l S) H - 1``, ``pos = x scale + 0.5`` unless
    ``align_corners``, dense stride indexing where the level grid fits, the
    XOR-prime hash otherwise, level sizes rounded to 8; ``gridtype='tiled'``
    stride-indexes every level and wraps by the modulo; ``linear``,
    ``smoothstep`` or ``floor`` interpolation; ``zero_oob`` zeroes inputs
    outside [0, 1].
  * ``variant='torch'``: the reference's pure-PyTorch grid
    (hashGridEmbedding.py:81-102): resolution floor(base s^l), the XOR-prime
    hash modulo the level size, and by default its degenerate ``floor``
    interpolation (only the floor corner).

All levels live in one ``(rows, C)`` table with static per-level offsets;
the lookup is one index gather of every level's corners, weighted and
summed.  The JAX package's one-hot and page-image lookups (:308-412) are TPU
layouts and have no counterpart here.  The encode is differentiable to
second order in the table (the gather) and in ``x`` (through the
interpolation weights), which the eikonal term needs.

Index arithmetic wraps at 32 bits where the JAX package's does (uint32
casts of int32 floors, the dense stride product and sum, the modulo): it is
done in int64 and masked to 32 bits.  ``inference=True`` rounds the looked-up
values to bfloat16 exactly where the JAX package gathers from a bfloat16
page image: when the largest level has more than 1024 rows and ``128 % C ==
0`` (:481-483, :497-513).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# instant-ngp / hashencoder.cu:75 primes (index 0 is intentionally 1).
NGP_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
# pure-torch path primes (hashGridEmbedding.py:14).
TORCH_PRIMES = (1, 3, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)

# the JAX package serves a spec from its bfloat16 page image (when
# ``inference``) above this many rows in the largest level (:301, :481)
PAGE_MIN_ROWS = 1024

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static description of a multi-resolution hash grid (numpy only; a copy
    of the JAX spec, :51-167)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: Optional[int] = None
    variant: str = "ngp"          # 'ngp' | 'torch'
    gridtype: str = "hash"        # 'hash' | 'tiled'
    interpolation: str = "linear"  # 'linear' | 'smoothstep' | 'floor'
    align_corners: bool = False
    init_std: float = 1e-4

    def __post_init__(self):
        if self.variant not in ("ngp", "torch"):
            raise ValueError(f"variant={self.variant!r}")
        if self.gridtype not in ("hash", "tiled"):
            raise ValueError(f"gridtype={self.gridtype!r}")
        if self.interpolation not in ("linear", "smoothstep", "floor"):
            raise ValueError(f"interpolation={self.interpolation!r}")

    def scale_factor(self) -> float:
        if self.desired_resolution is not None:
            if self.variant == "torch":
                # hashGridEmbedding.py:126
                return math.exp(
                    (math.log(self.desired_resolution) - math.log(self.base_resolution))
                    / (self.num_levels - 1))
            # hashgridencoder.py:86
            return float(np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                                 / (self.num_levels - 1)))
        return self.per_level_scale

    def level_resolutions(self) -> np.ndarray:
        s = self.scale_factor()
        if self.variant == "torch":
            return np.array([int(math.floor(self.base_resolution * s**l))
                             for l in range(self.num_levels)], dtype=np.int64)
        # ngp: the resolution of the offset table (hashgridencoder.py:104)
        return np.array([int(np.ceil(self.base_resolution * s**l))
                         for l in range(self.num_levels)], dtype=np.int64)

    def level_scales(self) -> np.ndarray:
        """The continuous position scale of each level."""
        if self.variant == "torch":
            return self.level_resolutions().astype(np.float64)
        # hashencoder.cu:155  scale = exp2f(level*S)*H - 1
        S = np.log2(self.scale_factor())
        return np.exp2(np.arange(self.num_levels) * S) * self.base_resolution - 1.0

    def level_grid_resolutions(self) -> np.ndarray:
        """Grid resolution of the corner indexing: ceil(scale) + 1 for 'ngp'
        (hashencoder.cu:156), the level resolution for 'torch'."""
        if self.variant == "torch":
            return self.level_resolutions()
        return np.ceil(self.level_scales()).astype(np.int64) + 1

    def level_sizes(self) -> np.ndarray:
        max_params = 2**self.log2_hashmap_size
        sizes = []
        for res in self.level_resolutions():
            if self.variant == "torch":
                sizes.append(min(int(res)**self.input_dim, max_params))  # hashGridEmbedding.py:132
            else:
                n = min(max_params, (int(res) + 1) ** self.input_dim)  # hashgridencoder.py:105
                sizes.append(int(np.ceil(n / 8) * 8))
        return np.array(sizes, dtype=np.int64)

    def offsets(self) -> np.ndarray:
        off = np.zeros(self.num_levels + 1, dtype=np.int64)
        off[1:] = np.cumsum(self.level_sizes())
        return off

    def total_rows(self) -> int:
        return int(self.offsets()[-1])

    def padded_total_rows(self) -> int:
        """total_rows rounded up so rows*level_dim is a multiple of 128: the
        JAX package allocates its tables at this size (the tail rows are
        never indexed), and the port keeps the same shape so weights load
        one to one."""
        n = self.total_rows()
        if 128 % self.level_dim != 0:
            return n
        rows_per_page = 128 // self.level_dim
        return int(-(-n // rows_per_page) * rows_per_page)

    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def dense_mask(self) -> np.ndarray:
        """Per level: True when the full grid fits (dense stride indexing;
        hashencoder.cu:88-101).  The torch variant always hashes."""
        if self.variant == "torch":
            return np.zeros(self.num_levels, dtype=bool)
        res = self.level_grid_resolutions()
        return ((res + 1) ** self.input_dim) <= self.level_sizes()

    def rounds_inference(self) -> bool:
        """Whether ``inference=True`` rounds the looked-up values to bfloat16:
        where the JAX package takes its page path (:481-483)."""
        return (int(self.level_sizes().max()) > PAGE_MIN_ROWS
                and 128 % self.level_dim == 0)

    def truncated(self, num_levels: int) -> "HashGridSpec":
        """The spec of the ``num_levels`` coarsest levels, with the resolved
        growth factor frozen (JAX :476-480): ``scale_factor`` derives it from
        ``num_levels`` when ``desired_resolution`` is set, so a plain
        truncation would re-spread base..desired over fewer levels."""
        return dataclasses.replace(self, num_levels=num_levels,
                                   per_level_scale=self.scale_factor(),
                                   desired_resolution=None)


def init_table(gen: torch.Generator, spec: HashGridSpec) -> torch.Tensor:
    """U(-std, std) ``(padded_total_rows, C)`` table (hashgridencoder.py:119-121,
    hashGridEmbedding.py:69-71)."""
    u = torch.rand(spec.padded_total_rows(), spec.level_dim, generator=gen,
                   device=gen.device)
    return (u * 2 - 1) * spec.init_std


def as_rows(table: np.ndarray, rows: int, level_dim: int) -> np.ndarray:
    """A JAX table in either layout -> ``(rows, level_dim)``.

    The JAX package stores large tables as a ``(P, 128)`` page image whose
    flat element order is the row-major ``(rows, C)`` table and whose page
    count is rounded up to 8 (ops/hashgrid.py:170-221); the tail is dropped.
    Small tables are ``(rows, C)`` already."""
    table = np.asarray(table)
    if table.shape == (rows, level_dim):
        return table
    if table.ndim == 2 and table.shape[1] == 128 and level_dim != 128:
        flat = table.reshape(-1)
        if flat.shape[0] < rows * level_dim:
            raise ValueError(f"page image {table.shape} holds fewer than "
                             f"{rows}x{level_dim} values")
        return flat[: rows * level_dim].reshape(rows, level_dim)
    raise ValueError(f"table of shape {table.shape} is neither ({rows}, {level_dim}) "
                     f"nor a (P, 128) page image")


def _mul_u32(c: torch.Tensor, m) -> torch.Tensor:
    """``(c * m) mod 2^32`` for int64 ``c`` in [0, 2^32) and ``m`` in [0, 2^32)
    (an int or an int64 tensor), without int64 overflow: ``m`` is split into
    16-bit halves."""
    lo, hi = m & 0xFFFF, (m >> 16) & 0xFFFF
    return (c * lo + (((c * hi) & 0xFFFF) << 16)) & _U32


def _hash_u32(coords: torch.Tensor, primes) -> torch.Tensor:
    """XOR-prime spatial hash on uint32 wraparound arithmetic
    (JAX ``_hash_u32``, :236-248), done in int64 masked to 32 bits.
    Negative coordinates wrap as a uint32 cast of int32 would."""
    c = coords & _U32
    result = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    for d in range(coords.shape[-1]):
        result = result ^ _mul_u32(c[..., d], primes[d] & _U32)
    return result


def _corner_bits(D: int) -> np.ndarray:
    """(2^D, D) binary corner offsets; corner 0 is the floor corner and
    corner ``1 << d`` its +1 neighbour along d."""
    idx = np.arange(1 << D, dtype=np.int64)[:, None]
    return (idx >> np.arange(D, dtype=np.int64)[None, :]) & 1


class GridConstants(NamedTuple):
    """Per-level tensors of a spec, and its corner offsets, on one device.
    Each is a host-to-device copy that waits for the device, so a caller on
    the hot path builds them once (the embedders keep them as buffers).  The
    constants of level l depend on l only, so ``head(K)`` is the constants
    of ``truncated(K)``."""

    scales: torch.Tensor   # (L,) float32 position scale
    sizes: torch.Tensor    # (L,) int64 level rows
    offsets: torch.Tensor  # (L,) int64 first row of each level
    dense: torch.Tensor    # (L,) bool stride-indexed (every level when tiled)
    strides: torch.Tensor  # (L, D) int64 dense stride of each axis, mod 2^32
    corners: torch.Tensor  # (2^D, D) int64 corner offsets (``_corner_bits``)

    def head(self, k: int) -> "GridConstants":
        return GridConstants(*(t[:k] for t in self[:-1]), self.corners)


def level_constants(spec: HashGridSpec, device=None) -> GridConstants:
    dense = spec.dense_mask()
    if spec.gridtype == "tiled":
        dense = np.ones_like(dense)  # tiled: always stride-index, wrap by modulo
    # dense stride index: sum_d corner_d * stride_base^d (hashencoder.cu:88-95)
    base = spec.level_grid_resolutions() + (1 if spec.variant == "ngp" else 0)
    strides = np.stack([base.astype(np.int64) ** d for d in range(spec.input_dim)], axis=-1)
    return GridConstants(
        torch.as_tensor(spec.level_scales(), dtype=torch.float32, device=device),
        torch.as_tensor(spec.level_sizes(), device=device),
        torch.as_tensor(spec.offsets()[:-1], device=device),
        torch.as_tensor(dense, device=device),
        torch.as_tensor(strides & _U32, device=device),
        torch.as_tensor(_corner_bits(spec.input_dim), device=device))


def _level_rows(spec: HashGridSpec, consts: GridConstants, corners: torch.Tensor) -> torch.Tensor:
    """corners (N, L, K, D) int64 -> table rows (N, L, K) (JAX ``_level_indices``,
    :251-277): the dense stride index or the hash, in uint32 arithmetic,
    modulo the level size, plus the level offset."""
    idx = _hash_u32(corners, NGP_PRIMES if spec.variant == "ngp" else TORCH_PRIMES)
    if spec.gridtype == "tiled" or spec.dense_mask().any():
        c = corners & _U32
        dense_idx = sum(_mul_u32(c[..., d], consts.strides[None, :, None, d])
                        for d in range(spec.input_dim)) & _U32
        idx = torch.where(consts.dense[None, :, None], dense_idx, idx)
    return idx % consts.sizes[None, :, None] + consts.offsets[None, :, None]


def _positions(spec: HashGridSpec, consts: GridConstants, x: torch.Tensor):
    """x (N, D) -> (floor corner int64 (N, L, D), frac (N, L, D)) (JAX :280-288)."""
    pos = x[:, None, :] * consts.scales.to(x.dtype)[None, :, None]
    if spec.variant == "ngp" and not spec.align_corners:
        pos = pos + 0.5  # hashencoder.cu:163
    floor = torch.floor(pos)
    # JAX: astype(int32); the floor carries no gradient
    return floor.detach().to(torch.int32).to(torch.int64), pos - floor


def _interp_weights(spec: HashGridSpec, consts: GridConstants,
                    frac: torch.Tensor) -> torch.Tensor:
    """frac (N, L, D) -> corner weights (N, L, 2^D) (JAX :291-305)."""
    bits = consts.corners.bool()
    f = frac * frac * (3.0 - 2.0 * frac) if spec.interpolation == "smoothstep" else frac
    w = torch.where(bits[None, None], f[:, :, None, :], 1.0 - f[:, :, None, :])
    if w.device.type == "cpu":
        return w.prod(dim=-1)
    # on the card the factors one at a time: the backward of ``prod`` looks
    # for zero factors on the host (``nonzero``), which a CUDA graph of the
    # train step cannot hold
    out = w[..., 0]
    for d in range(1, w.shape[-1]):
        out = out * w[..., d]
    return out


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _oob(x: torch.Tensor) -> torch.Tensor:
    return ((x < 0.0) | (x > 1.0)).any(dim=-1)


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec, *,
                zero_oob: bool = True, inference: bool = False,
                max_level: Optional[int] = None, fill: Optional[torch.Tensor] = None,
                consts: Optional[GridConstants] = None) -> torch.Tensor:
    """Encode x (N, D) -> (N, L*C) (JAX :442-551).

    ``zero_oob`` zeroes the ngp variant's output for inputs outside [0, 1].
    ``inference`` rounds looked-up values to bfloat16 where the JAX package
    does (``HashGridSpec.rounds_inference``).  ``max_level=K`` encodes the K
    coarsest levels only and fills levels >= K with ``fill[K:]`` (``fill``
    is (L, C), usually ``level_means``; zeros when None), zeroed out of
    bounds as the encode is.  ``consts`` are ``level_constants(spec)`` on
    x's device, built here when not given."""
    N = x.shape[0]
    L, C = spec.num_levels, spec.level_dim
    if consts is None:
        consts = level_constants(spec, x.device)

    if max_level is not None and max_level < L:
        K = int(max_level)
        out_k = hash_encode(x, table, spec.truncated(K), zero_oob=zero_oob,
                            inference=inference, consts=consts.head(K))
        if fill is None:
            return torch.cat([out_k, out_k.new_zeros(N, (L - K) * C)], dim=-1)
        fill_v = fill[K:].reshape(1, (L - K) * C).to(out_k.dtype).expand(N, -1)
        if zero_oob and spec.variant == "ngp":
            fill_v = torch.where(_oob(x)[:, None], 0.0, fill_v)
        return torch.cat([out_k, fill_v], dim=-1)

    round_bf16 = inference and spec.rounds_inference()
    corner, frac = _positions(spec, consts, x)
    if spec.interpolation == "floor":
        # the reference's degenerate interpolation: the floor corner only
        rows = _level_rows(spec, consts, corner[:, :, None, :])          # (N, L, 1)
        out = table.index_select(0, rows.reshape(-1)).reshape(N, L, C)
        if round_bf16:
            out = _bf16(out)
    else:
        rows = _level_rows(spec, consts, corner[:, :, None, :] + consts.corners[None, None])  # (N, L, 2^D)
        vals = table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, C)
        if round_bf16:
            vals = _bf16(vals)
        w = _interp_weights(spec, consts, frac).to(vals.dtype)
        out = (vals * w[..., None]).sum(dim=2)

    if zero_oob and spec.variant == "ngp":
        # hashencoder.cu:131-147: inputs outside [0, 1] produce zeros
        out = torch.where(_oob(x)[:, None, None], 0.0, out)
    return out.reshape(N, L * C)


def level_means(table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Per-level mean feature (L, C) over each level's own rows (JAX
    :415-439): the fill of pruned levels in guidance queries."""
    offsets, sizes = spec.offsets(), spec.level_sizes()
    return torch.stack([table[int(o): int(o) + int(s)].mean(dim=0)
                        for o, s in zip(offsets[:-1], sizes)])


def total_variation_loss(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                         consts: Optional[GridConstants] = None) -> torch.Tensor:
    """Grid total variation at the cells of x (JAX :554-586): the mean over
    points, levels and axes of the squared difference between each cell's
    floor corner and its +1 neighbour, summed over features."""
    N, D = x.shape
    if consts is None:
        consts = level_constants(spec, x.device)
    corner, _ = _positions(spec, consts, x)
    rows = _level_rows(spec, consts, corner[:, :, None, :] + consts.corners[None, None])
    vals = table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, spec.level_dim)
    tv = sum(((vals[:, :, 1 << d] - vals[:, :, 0]) ** 2).sum() for d in range(D))
    return tv / (N * spec.num_levels * D)
