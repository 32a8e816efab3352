"""LPIPS (AlexNet variant) in PyTorch.

Counterpart of ``hashmodnffbanks_idr_tpu/models/lpips.py``, the forward of
the `lpips` pip package with ``net='alex'`` that the reference's
metrics.py:47-54 calls:

    scale input -> AlexNet conv features (taps after relu1..relu5)
    -> channel-unit-normalize -> squared diff -> per-layer 1x1 non-negative
    linear head -> spatial mean -> sum over the 5 layers

The trunk is ``F.conv2d`` + ``F.relu`` + ``F.max_pool2d(3, 2)``: plain
PyTorch, as the JAX package leaves it to XLA.  Weights come from, in order:

1. Official checkpoints, when present: set ``HMNFFB_LPIPS_WEIGHTS`` to a
   directory containing ``alexnet.pth`` (torchvision AlexNet state dict) and
   ``lpips_alex.pth`` (the lpips package's linear-head state dict).
2. A deterministic seeded He-init fallback drawn from the same numpy stream
   as the JAX package's, so both packages hold identical weights.  Its
   values are NOT comparable to published LPIPS numbers; results are tagged
   with :func:`weights_source`.

It runs on the device it is given and nowhere else: an error on the card is
raised, not retried on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# torchvision AlexNet `features` trunk: (out_ch, kernel, stride, pad); a tap
# is taken after each conv's ReLU. MaxPool(3,2) sits after taps 1 and 2.
_CONVS: List[Tuple[int, int, int, int]] = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # conv indices followed by MaxPool(kernel=3, stride=2)

# lpips.ScalingLayer constants (inputs in [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)


def init_fallback_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic He-init AlexNet convs + uniform non-negative heads (the
    JAX package's draws, in its order)."""
    rng = np.random.default_rng(seed)
    w: Dict[str, np.ndarray] = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_CONVS):
        fan_in = in_ch * k * k
        w[f"conv{i}_w"] = rng.normal(
            0.0, np.sqrt(2.0 / fan_in), (out_ch, in_ch, k, k)).astype(np.float32)
        w[f"conv{i}_b"] = np.zeros((out_ch,), dtype=np.float32)
        # uniform head == plain mean over channels of the normalized sq-diff
        w[f"lin{i}_w"] = np.full((out_ch,), 1.0 / out_ch, dtype=np.float32)
        in_ch = out_ch
    return w


def load_torch_lpips(weights_dir: str) -> Dict[str, np.ndarray]:
    """Import official weights: torchvision `alexnet.pth` + lpips
    `lpips_alex.pth` state dicts (CPU load, no network)."""
    alex = torch.load(os.path.join(weights_dir, "alexnet.pth"),
                      map_location="cpu", weights_only=True)
    lin = torch.load(os.path.join(weights_dir, "lpips_alex.pth"),
                     map_location="cpu", weights_only=True)
    w: Dict[str, np.ndarray] = {}
    # torchvision features indices of the 5 convs: 0, 3, 6, 8, 10
    for i, fi in enumerate([0, 3, 6, 8, 10]):
        w[f"conv{i}_w"] = alex[f"features.{fi}.weight"].numpy()
        w[f"conv{i}_b"] = alex[f"features.{fi}.bias"].numpy()
    for i in range(5):
        # lpips keys: lin{i}.model.1.weight, shape (1, C, 1, 1)
        key = f"lin{i}.model.1.weight"
        if key not in lin:  # older checkpoints: lins.{i}....
            key = f"lins.{i}.model.1.weight"
        w[f"lin{i}_w"] = np.clip(lin[key].numpy().reshape(-1), 0.0, None)
    return w


_WEIGHTS_CACHE: Dict[str, object] = {}


def get_weights() -> Tuple[Dict[str, np.ndarray], str]:
    """(weights, source) where source is 'official' or 'fallback'."""
    if "w" not in _WEIGHTS_CACHE:
        wdir = os.environ.get("HMNFFB_LPIPS_WEIGHTS", "")
        if wdir and os.path.exists(os.path.join(wdir, "alexnet.pth")):
            _WEIGHTS_CACHE["w"] = load_torch_lpips(wdir)
            _WEIGHTS_CACHE["src"] = "official"
        else:
            _WEIGHTS_CACHE["w"] = init_fallback_weights()
            _WEIGHTS_CACHE["src"] = "fallback"
    return _WEIGHTS_CACHE["w"], _WEIGHTS_CACHE["src"]  # type: ignore


def weights_source() -> str:
    return get_weights()[1]


def _forward_taps(weights: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """x: (N, 3, H, W) scaled input -> list of 5 post-ReLU feature maps."""
    taps = []
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"],
                            stride=stride, padding=pad))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (norm + eps)


@torch.no_grad()
def lpips_tensor(weights: Dict[str, torch.Tensor], a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """(N,) LPIPS distances between (N, 3, H, W) images in [-1, 1]."""
    shift = torch.as_tensor(_SHIFT, device=a.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=a.device)[None, :, None, None]
    ta = _forward_taps(weights, (a - shift) / scale)
    tb = _forward_taps(weights, (b - shift) / scale)
    total = torch.zeros((a.shape[0],), dtype=torch.float32, device=a.device)
    for i, (fa, fb) in enumerate(zip(ta, tb)):
        d = (_unit_normalize(fa) - _unit_normalize(fb)) ** 2
        head = weights[f"lin{i}_w"][None, :, None, None]
        total = total + torch.mean(torch.sum(d * head, dim=1), dim=(1, 2))
    return total


def _trunk_fits(size: int) -> bool:
    """Whether a side of ``size`` pixels leaves every max-pool a non-empty
    window (the JAX forward's VALID pools yield an empty map otherwise)."""
    for i, (_, k, stride, pad) in enumerate(_CONVS):
        size = (size + 2 * pad - k) // stride + 1
        if i in _POOL_AFTER:
            if size < 3:
                return False
            size = (size - 3) // 2 + 1
    return True


def lpips(img: np.ndarray, gt: np.ndarray, device=None) -> float:
    """LPIPS distance between two (H, W, 3) images in [-1, 1], computed on
    ``device`` (None -> the CUDA card).  Below 16 pixels a side it raises,
    as the JAX package does; from 16 up to where the trunk's pools fit (31)
    it is NaN, the JAX forward's mean over an empty feature map."""
    device = resolve_device(device)
    weights, _ = get_weights()
    if img.shape[0] < 16 or img.shape[1] < 16:
        raise ValueError(f"image too small for AlexNet LPIPS: {img.shape}")
    if not (_trunk_fits(img.shape[0]) and _trunk_fits(img.shape[1])):
        return float("nan")
    w = {k: torch.as_tensor(v, device=device) for k, v in weights.items()}
    a = torch.as_tensor(np.transpose(img.astype(np.float32), (2, 0, 1))[None], device=device)
    b = torch.as_tensor(np.transpose(gt.astype(np.float32), (2, 0, 1))[None], device=device)
    return float(lpips_tensor(w, a, b)[0])
