"""Frequency-space input encodings.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/encodings.py`` for what the
flagship path uses: the log-spaced frequency bands, the positional
encoding's *declared* width (which sizes the NFFB trunk), and random Fourier
features.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def freq_bands(num_freqs: int, max_freq_log2: float, log_sampling: bool = True) -> np.ndarray:
    if log_sampling:
        return 2.0 ** np.linspace(0.0, max_freq_log2, num_freqs)
    return np.linspace(2.0**0.0, 2.0**max_freq_log2, num_freqs)


def posenc_declared_dim(input_dims: int, num_freqs: int, include_input: bool) -> int:
    """The reference's *declared* embeddings_dim (frequency_enc.py:13-16,25):
    ``d*(1 + 2*num_freqs)`` plus ``d`` again when include_input.  It differs
    from the actual output width (``posenc_actual_dim``) when the runtime input
    width differs from ``input_dims``; NFFB sizes its trunk with this number."""
    out_dim = input_dims * (1 + 2 * num_freqs)
    return out_dim + input_dims if include_input else out_dim


def posenc_actual_dim(input_dims: int, num_freqs: int, include_input: bool) -> int:
    return input_dims * 2 * num_freqs + (2 * input_dims if include_input else 0)


def fourier_features_init(gen: torch.Generator, input_dims: int, num_channels: int,
                          sigma: float) -> torch.Tensor:
    """Gaussian projection ``B`` (input_dims, num_channels) * sigma
    (frequency_enc.py:59)."""
    return torch.randn(input_dims, int(num_channels), generator=gen) * sigma


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
