"""PyTorch/CUDA port of ``hashmodnffbanks_idr_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout module
by module (``ops/``, ``models/``, ``geometry/``, ``train/`` ...) so each
counterpart is found under the same path.  It imports ``torch`` and numpy
only.  Plain tensor code is PyTorch; the JAX package's one Pallas kernel
(the fused SDF MLP) is a hand-written CUDA kernel in ``ops/csrc/``.

Entry points take ``device=None``, meaning the CUDA card, and raise when no
card is present unless the caller asks for the CPU explicitly.
"""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """``None`` -> ``cuda``; raises when CUDA is asked for but absent.

    On CUDA it also turns TF32 off for matmuls and cuDNN: the 'exact' tracer
    and every parity tolerance assume full float32 products (TF32 keeps ~3
    decimal digits).
    """
    import torch  # here, so that a worker importing a numpy-only module skips torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
