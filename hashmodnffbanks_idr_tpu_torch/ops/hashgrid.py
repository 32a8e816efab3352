"""Multi-resolution hash-grid encoding, pure-torch semantics.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/hashgrid.py`` for the variant
the flagship NFFB grid uses: ``variant='torch'`` with
``interpolation='floor'`` (hashGridEmbedding.py:81-102 of the reference:
per-level resolution floor(base*s^l), XOR-prime hash modulo the level size,
and the degenerate ``xf = x - x.float()`` interpolation that keeps only the
floor corner).

All levels live in one ``(rows, C)`` table with static per-level offsets;
the lookup is one index gather.  The JAX package's one-hot and page-image
lookups (:308-412) are TPU layouts and have no counterpart here.  The floor
makes the encoding piecewise constant in ``x`` (zero spatial gradient, as in
JAX), while the gather stays differentiable in the table to any order, which
the second-order eikonal term needs.

Still to port: the ``ngp`` variant, level pruning and the TV loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# pure-torch path primes (hashGridEmbedding.py:14).
TORCH_PRIMES = (1, 3, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static description of a multi-resolution hash grid (numpy only)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: Optional[int] = None
    variant: str = "torch"
    interpolation: str = "floor"
    init_std: float = 1e-4

    def __post_init__(self):
        if (self.variant, self.interpolation) != ("torch", "floor"):
            raise NotImplementedError(
                "only variant='torch' with interpolation='floor' is ported")

    def scale_factor(self) -> float:
        if self.desired_resolution is not None:
            # hashGridEmbedding.py:126
            return math.exp(
                (math.log(self.desired_resolution) - math.log(self.base_resolution))
                / (self.num_levels - 1))
        return self.per_level_scale

    def level_resolutions(self) -> np.ndarray:
        s = self.scale_factor()
        return np.array(
            [int(math.floor(self.base_resolution * s**l)) for l in range(self.num_levels)],
            dtype=np.int64)

    def level_scales(self) -> np.ndarray:
        return self.level_resolutions().astype(np.float64)

    def level_sizes(self) -> np.ndarray:
        max_params = 2**self.log2_hashmap_size
        return np.array([min(int(r)**self.input_dim, max_params)  # hashGridEmbedding.py:132
                         for r in self.level_resolutions()], dtype=np.int64)

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


def init_table(gen: torch.Generator, spec: HashGridSpec) -> torch.Tensor:
    """U(-std, std) ``(padded_total_rows, C)`` table (hashGridEmbedding.py:69-71)."""
    u = torch.rand(spec.padded_total_rows(), spec.level_dim, generator=gen)
    return (u * 2 - 1) * spec.init_std


def as_rows(table: np.ndarray, rows: int, level_dim: int) -> np.ndarray:
    """A JAX table in either layout -> ``(rows, level_dim)``.

    The JAX package stores large tables as a ``(P, 128)`` page image whose
    flat element order is the row-major ``(rows, C)`` table
    (ops/hashgrid.py:170-221); small ones as ``(rows, C)`` already."""
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


def _mul_u32(c: torch.Tensor, prime: int) -> torch.Tensor:
    """``(c * prime) mod 2^32`` for int64 ``c`` in [0, 2^32), without int64
    overflow: split the prime into 16-bit halves."""
    lo, hi = prime & 0xFFFF, (prime >> 16) & 0xFFFF
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


def level_constants(spec: HashGridSpec, device=None):
    """Per-level (scales f32, sizes, offsets) tensors of ``level_rows``.  Each
    is a host-to-device copy that waits for the device, so a caller on the
    hot path builds them once (``HashGridTorchEmbedder`` keeps them as
    buffers)."""
    return (torch.as_tensor(spec.level_scales(), dtype=torch.float32, device=device),
            torch.as_tensor(spec.level_sizes(), device=device),
            torch.as_tensor(spec.offsets()[:-1], device=device))


def level_rows(x: torch.Tensor, consts) -> torch.Tensor:
    """x (N, D) -> floor-corner row index per level, (N, L) int64."""
    scales, sizes, offsets = consts
    pos = x[:, None, :] * scales.to(x.dtype)[None, :, None]
    corner = torch.floor(pos).to(torch.int32).to(torch.int64)  # JAX: astype(int32)
    idx = _hash_u32(corner, TORCH_PRIMES)
    return idx % sizes[None, :] + offsets[None, :]


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                consts=None) -> torch.Tensor:
    """Encode x (N, D) -> (N, L*C): each level's floor-corner feature.

    Matches the JAX ``hash_encode(..., zero_oob=False)`` for the torch/floor
    spec; inputs outside [0, 1] hash like any other coordinate.  ``consts``
    are ``level_constants(spec)`` on x's device, built here when not given."""
    if consts is None:
        consts = level_constants(spec, x.device)
    rows = level_rows(x.detach(), consts)                      # (N, L)
    out = table.index_select(0, rows.reshape(-1))              # (N*L, C)
    return out.reshape(x.shape[0], spec.output_dim())
