"""Style-transfer helper functions + AdaIN-based style modulation.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/style.py`` (the reference's
style_function.py:1-92: AdaIN, CORAL transfer, Gram/style loss) and its
``StyleModulation`` (styleMod.py:52-81), which the reference defines but
does not wire into NFFB; neither package puts it on the training path.
Its two linears bridge from JAX with ``weights.from_jax_params``.
"""

from __future__ import annotations

import torch
from torch import nn

from .linear import Linear


def _mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-(batch, channel) statistics over all trailing dims, with torch
    ``.var``'s default *unbiased* estimator, as the reference's
    calc_mean_std (style_function.py:5-13; JAX :15-26)."""
    flat = feat.reshape(feat.shape[0], feat.shape[1], -1)
    n = flat.shape[-1]
    mean = flat.mean(dim=-1)
    var = ((flat - mean[..., None]) ** 2).sum(dim=-1) / max(n - 1, 1)
    shape = feat.shape[:2] + (1,) * (feat.dim() - 2)
    return mean.reshape(shape), torch.sqrt(var + eps).reshape(shape)


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN (style_function.py:16-24): normalise the content's statistics,
    re-scale with the style's.  content/style: (N, C, *spatial)."""
    c_mean, c_std = _mean_std(content)
    s_mean, s_std = _mean_std(style)
    return (content - c_mean) / c_std * s_std + s_mean


def coral(source: torch.Tensor, target: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """CORAL colour/feature transfer (style_function.py:42-68): whiten the
    source feature covariance, re-colour with the target's.  (C, N) layout;
    eigenvalues clamped at ``eps`` before the square roots (JAX :51-54)."""

    def center(x):
        mean = x.mean(dim=1, keepdim=True)
        return x - mean, mean

    src_c, _ = center(source)
    tgt_c, tgt_mean = center(target)
    eye_s = torch.eye(source.shape[0], dtype=source.dtype, device=source.device)
    eye_t = torch.eye(target.shape[0], dtype=target.dtype, device=target.device)
    cov_s = src_c @ src_c.T / src_c.shape[1] + eps * eye_s
    cov_t = tgt_c @ tgt_c.T / tgt_c.shape[1] + eps * eye_t

    def sqrt_inv(m):
        vals, vecs = torch.linalg.eigh(m)
        vals = torch.clamp_min(vals, eps)
        return (vecs @ torch.diag(vals ** -0.5) @ vecs.T,
                vecs @ torch.diag(vals ** 0.5) @ vecs.T)

    w_s, _ = sqrt_inv(cov_s)
    _, c_t = sqrt_inv(cov_t)
    return c_t @ (w_s @ src_c) + tgt_mean


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(C, L) -> (C, C) normalised Gram matrix (style_function.py:71-78)."""
    return feat @ feat.T / feat.shape[-1]


def style_loss(feat: torch.Tensor, target_feat: torch.Tensor) -> torch.Tensor:
    """Gram-matrix style loss (style_function.py:81-92)."""
    return ((gram_matrix(feat) - gram_matrix(target_feat)) ** 2).mean()


class StyleModulation(nn.Module):
    """AdaIN-variant modulation (styleMod.py:52-81; JAX :68-102):
    parameterised like StyleAttention, it applies AdaIN of the content's
    statistics onto the style features before the attention-weighted
    projection.  The attention weights carry no gradient (JAX :98)."""

    def __init__(self, multires_levels: int = 3, feature_vector_size: int = 28):
        super().__init__()
        self.L = multires_levels
        self.fvs = feature_vector_size
        self.linear_transform = Linear(self.fvs, self.fvs)
        self.attention = Linear(self.fvs, 1)

    def reset_parameters(self, gen: torch.Generator) -> "StyleModulation":
        """``nn.Linear``'s default init for both linears (JAX :80-87)."""
        self.linear_transform.init_torch_default(gen)
        self.attention.init_torch_default(gen)
        return self

    def forward(self, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        content_features = content.reshape(-1, 3, content.shape[1])
        style_features = style.reshape(style.shape[1], self.L, self.fvs)
        style_features = adaptive_instance_normalization(content_features, style_features)
        style_features = style_features.squeeze()
        modulated = self.linear_transform(style_features)
        attn = torch.softmax(self.attention(content_features).detach(), dim=1)
        weighted = attn * modulated
        norm = weighted / torch.clamp_min(
            torch.linalg.vector_norm(weighted, dim=1, keepdim=True), 1e-12)
        return norm.squeeze(0) if norm.shape[0] == 1 else norm
