"""Utility decoder MLP + sphere pre-training.

Counterpart of ``hashmodnffbanks_idr_tpu/models/decoder.py`` (the
reference's Decoder / pre_train_sphere, custom_embedder_decoder.py:169-204):
a small MLP, relu between layers and tanh after the last, fitted to a
sphere SDF by MSE before the main optimization.  Parameters are
``lin.<i>.w``/``lin.<i>.b`` so ``weights.from_jax_params`` maps the JAX
package's ``{"lin": [{w, b}, ...]}`` onto it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.linear import Linear


class Decoder(nn.Module):
    def __init__(self, input_dims: int, internal_dims: Sequence[int],
                 output_dims: int, embed_fn: Optional[Callable] = None):
        super().__init__()
        self.embed_fn = embed_fn
        self.dims = [input_dims] + list(internal_dims) + [output_dims]
        self.lin = nn.ModuleList(Linear(self.dims[i], self.dims[i + 1])
                                 for i in range(len(self.dims) - 1))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "Decoder":
        """``nn.Linear``'s default init, U(+-1/sqrt(in)), drawn from ``gen``."""
        for lin in self.lin:
            lin.init_torch_default(gen)
        return self

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        if self.embed_fn is not None:
            p = self.embed_fn(p)
        h = p
        n = len(self.lin)
        for i, lin in enumerate(self.lin):
            h = lin(h)
            h = torch.tanh(h) if i == n - 1 else torch.relu(h)
        return h


def pre_train_sphere(decoder: Decoder, generator: torch.Generator, iters: int = 1000,
                     radius: float = 0.3, lr: float = 1e-4) -> float:
    """Fit ``decoder[..., 0]`` in place to the SDF of a radius-``radius``
    sphere (custom_embedder_decoder.py:190-204), on 1024 points a step drawn
    uniformly in [-0.5, 0.5]^3 from ``generator`` (on the decoder's device).
    Returns the last step's loss."""
    opt = torch.optim.Adam(decoder.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    device = next(decoder.parameters()).device
    loss = None
    for _ in range(iters):
        pts = torch.rand((1024, 3), generator=generator, device=device) - 0.5
        ref = torch.linalg.vector_norm(pts, dim=-1) - radius
        loss = torch.mean((decoder(pts)[..., 0] - ref) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return float(loss.detach())
