"""Frozen copy of the port's ``hashmodnffbanks_idr_tpu_torch/ops/encodings.py`` for the
benchmark's plain reference; it imports nothing of the port (changes: the Fourier projection drawn on the generator's device).

Frequency-space input encodings.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/encodings.py``: the NeRF
positional encoding with the reference's include-input quirk and its
*declared* width (which sizes the NFFB trunk), the classic IDR view-direction
embedding, random Fourier features, and the real spherical harmonics of the
view directions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def freq_bands(num_freqs: int, max_freq_log2: float, log_sampling: bool = True) -> np.ndarray:
    if log_sampling:
        return 2.0 ** np.linspace(0.0, max_freq_log2, num_freqs)
    return np.linspace(2.0**0.0, 2.0**max_freq_log2, num_freqs)


def positional_encoding(x: torch.Tensor, num_freqs: int, max_freq_log2: float,
                        include_input: bool = True) -> torch.Tensor:
    """[..., d] -> [..., d*2*num_freqs + (2*d if include_input)] (JAX :36-74):
    ``[x, x, sin(f0 x), cos(f0 x), sin(f1 x), ...]``.  The identity map is a
    member of the reference's embed-fn list and the input is concatenated
    again (frequency_enc.py:24-25,45-47), hence ``x`` twice.  The log-spaced
    bands (``freq_bands``) are made on x's device: a host copy would wait
    for the device on every call."""
    bands = torch.linspace(0.0, max_freq_log2, num_freqs, dtype=torch.float64,
                           device=x.device).exp2().to(x.dtype)
    xf = x[..., None, :] * bands[:, None]                       # (..., F, d)
    flat = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, d)
    flat = flat.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        return torch.cat([x, x, flat], dim=-1)
    return flat


def posenc_declared_dim(input_dims: int, num_freqs: int, include_input: bool) -> int:
    """The reference's *declared* embeddings_dim (frequency_enc.py:13-16,25):
    ``d*(1 + 2*num_freqs)`` plus ``d`` again when include_input.  It differs
    from the actual output width (``posenc_actual_dim``) when the runtime input
    width differs from ``input_dims``; NFFB sizes its trunk with this number."""
    out_dim = input_dims * (1 + 2 * num_freqs)
    return out_dim + input_dims if include_input else out_dim


def posenc_actual_dim(input_dims: int, num_freqs: int, include_input: bool) -> int:
    return input_dims * 2 * num_freqs + (2 * input_dims if include_input else 0)


def get_embedder_dims(multires: int) -> int:
    """The reference's get_embedder() out_dim (frequency_enc.py:156-168; JAX
    :77-79): the declared width of ``nerf_embed``, 3 less than its output."""
    return 3 * (1 + 2 * multires)


def nerf_embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """The classic IDR view-direction embedding (frequency_enc.py:156-168; JAX
    :82-86): ``positional_encoding`` with ``multires`` bands up to
    2^(multires-1), input included."""
    return positional_encoding(x, num_freqs=multires, max_freq_log2=multires - 1,
                               include_input=True)


def fourier_features_init(gen: torch.Generator, input_dims: int, num_channels: int,
                          sigma: float) -> torch.Tensor:
    """Gaussian projection ``B`` (input_dims, num_channels) * sigma
    (frequency_enc.py:59)."""
    return torch.randn(input_dims, int(num_channels), generator=gen, device=gen.device) * sigma


def fourier_features(x: torch.Tensor, B: torch.Tensor, include_input: bool = True) -> torch.Tensor:
    """``[x?, sin(2 pi x B), cos(2 pi x B)]``."""
    xp = (2.0 * math.pi) * (x @ B.to(x.dtype))
    out = torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1)
    if include_input:
        return torch.cat([x, out], dim=-1)
    return out


def fourier_features_dim(input_dims: int, num_channels: int, include_input: bool) -> int:
    """The reference declares 2C+3 whatever input_dims is (frequency_enc.py:60)."""
    return 2 * int(num_channels) + 3 if include_input else 2 * int(num_channels)


# real spherical harmonics constants (JAX ops/encodings.py:117-126)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396]
_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435]
_C4 = [2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761]


def spherical_harmonics(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[..., 3] unit directions -> [..., degree**2] real SH basis values, in
    the JAX package's component order (ops/encodings.py:129-159)."""
    if not 1 <= degree <= 5:
        raise ValueError(f"SH degree must be in 1..5, got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    comps = [torch.full_like(x, _C0)]
    if degree > 1:
        comps += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            _C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz, _C2[4] * (xx - yy),
        ]
    if degree > 3:
        comps += [
            _C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree > 4:
        comps += [
            _C4[0] * xy * (xx - yy), _C4[1] * yz * (3 * xx - yy),
            _C4[2] * xy * (7 * zz - 1), _C4[3] * yz * (7 * zz - 3),
            _C4[4] * (zz * (35 * zz - 30) + 3), _C4[5] * xz * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1), _C4[7] * xz * (xx - 3 * yy),
            _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)
