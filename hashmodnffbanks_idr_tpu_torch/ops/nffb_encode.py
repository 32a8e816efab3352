"""NFFB's gradient-free encode as one CUDA kernel.

``csrc/nffb_encode.cu`` computes ``NFFBEmbedder.forward`` (models/embedders.py)
for the pure-torch grid with floor interpolation in one launch a call, in
float32 (``fast=False``) or with the bf16 guidance path's rounding
(``fast=True``).  It replaces no Pallas kernel: the JAX package leaves this
encoder to XLA's fusion, while eager torch runs it as about 110 small
kernels a call, and the tracer calls it some 45 times a step.  The module
decides when to launch it (``NFFBEmbedder.forward``: no autograd, a CUDA
input, a shape of ``SHAPES``); its plain forward is the kernel's plain twin.

The kernel reads the module's parameters and buffers in place by pointer,
so nothing is packed and nothing goes stale while training moves them.
``encode`` checks the input and every tensor before it loads the library;
the library is built with ``nvcc`` for ``sm_90a`` into the build cache
(``utils/compile_cache.py``) on first use and loaded with ctypes.  Each
launch adds to ``fused_mlp.launch_counts["nffb_encode_f32"]`` or
``["nffb_encode_bf16"]`` (launches and points), which CUDA graphs fold as
they fold the fused MLP's.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import torch

from ..utils.compile_cache import build_library
from . import fused_mlp as fm

# (in_dim, levels, features a level, out width) the kernel is built for:
# every torch-grid NFFB of the repo's confs (the points encoder, the view
# directions' encoder)
SHAPES = frozenset({(3, 6, 2, 56), (3, 4, 2, 40)})
VARIANTS = {False: "nffb_encode_f32", True: "nffb_encode_bf16"}

_CSRC = Path(__file__).resolve().parent / "csrc" / "nffb_encode.cu"
_lib = None


def load_library() -> ctypes.CDLL:
    """Build ``csrc/nffb_encode.cu`` (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library(_CSRC, "nffb_encode")))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    # levels, width, style, bf16, x, n, bound, tensors, out, stream
    lib.nffb_encode.argtypes = [c_int, c_int, c_int, c_int, ptr, c_int, ctypes.c_double,
                                ctypes.POINTER(ptr), ptr, ptr]
    lib.nffb_encode.restype = c_int
    _lib = lib
    return lib


def check_input(x: torch.Tensor, in_dim: int) -> None:
    """Raise ValueError unless ``x`` is what the kernel takes: a contiguous
    float32 (N, in_dim) tensor on a CUDA device."""
    if x.dtype != torch.float32:
        raise ValueError(f"x has dtype {x.dtype}, expected torch.float32")
    if x.dim() != 2 or x.shape[1] != in_dim:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (N, {in_dim})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not x.is_cuda:
        raise ValueError(f"x is on {x.device}; the kernel takes a CUDA tensor")
    if x.shape[0] >= 2**31:
        raise ValueError(f"x has {x.shape[0]} rows, more than the kernel's 2^31 - 1")


def tensors(module) -> List[Optional[torch.Tensor]]:
    """The module's tensors in the order the C entry takes them: the grid's
    table, its Fourier projection ``B``, scales, sizes and offsets (int64),
    the slots' scales and phases, the style transform (None, None without
    style), each ``ff_lin`` layer's weight and bias, ``out_layer``'s; every
    one but the sizes and offsets float32."""
    grid = module.grid
    style = ([module.style.linear_transform.w, module.style.linear_transform.b]
             if module.style_modulation else [None, None])
    out = [grid.table, grid.ff.B, grid._grid_scales, grid._grid_sizes, grid._grid_offsets,
           module._scales, module._phase, *style]
    for lin in module.ff_lin:
        out += [lin.w, lin.b]
    return out + [module.out_layer.w, module.out_layer.b]


INT64_TENSORS = (3, 4)  # the grid's sizes and offsets, in ``tensors``' order


def _check_tensor(t: torch.Tensor, want: torch.dtype, device: torch.device) -> None:
    if t.device != device or t.dtype != want:
        raise ValueError(f"a tensor of the encoder is {t.dtype} on {t.device}, expected "
                         f"{want} on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("the encoder's tensors must be contiguous and 16-byte aligned")


def encode(module, x: torch.Tensor, fast: bool) -> torch.Tensor:
    """``module.forward(x, fast)`` for a gradient-free CUDA query: x (N, 3)
    float32 -> (N, 3 + out_width), ``[input01, acc]``, in one launch on
    torch's current stream."""
    in_dim = module.grid.spec.input_dim
    check_input(x, in_dim)
    shape = (in_dim, module.n_levels, module.F, module.out_width)
    if shape not in SHAPES:
        raise ValueError(f"the kernel is not built for NFFB (in, L, F, width) = {shape}")
    ts = tensors(module)
    for i, t in enumerate(ts):
        if t is not None:
            _check_tensor(t, torch.int64 if i in INT64_TENSORS else torch.float32, x.device)
    n = x.shape[0]
    out = torch.empty(n, in_dim + module.out_width, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = load_library()
    pointers = (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr() for t in ts])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nffb_encode(module.n_levels, module.out_width, int(module.style_modulation),
                              int(fast), x.data_ptr(), n, float(module.bound), pointers,
                              out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nffb_encode launch failed: CUDA error {err}")
    counts = fm.launch_counts[VARIANTS[bool(fast)]]
    counts["launches"] += 1
    counts["points"] += n
    return out
