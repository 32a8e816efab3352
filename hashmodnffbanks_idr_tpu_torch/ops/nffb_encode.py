"""NFFB's gradient-free encode as one CUDA kernel.

``csrc/nffb_encode.cu`` computes ``NFFBEmbedder.forward`` (models/embedders.py)
in one launch a call, on either grid: the pure-torch grid with its floor
corner ('FFB', 'StyleModNFFB'; ``nffb_encode_kernel<TorchGrid, ...>``) or
the instant-ngp grid with trilinear interpolation ('FFBTcnn';
``nffb_encode_kernel<NgpGrid, ...>``), in float32 (``fast=False``) or with
the bf16 guidance path's rounding (``fast=True``).  It replaces no Pallas kernel: the JAX package leaves this
encoder to XLA's fusion, while eager torch runs it as about 110 small
kernels a call (more on the ngp grid, whose trilinear gather is a chain of
its own), and the tracer calls it some 45 times a step.  The module decides
when to launch it (``NFFBEmbedder.forward``: no autograd, a CUDA input, a
grid and shape of ``SHAPES``); its plain forward is the kernel's plain twin.

The kernel reads the module's parameters and buffers in place by pointer,
so nothing is packed and nothing goes stale while training moves them.
``encode`` checks the input and every tensor before it loads the library;
the library is built with ``nvcc`` for ``sm_90a`` into the build cache
(``utils/compile_cache.py``) on first use and loaded with ctypes.  Each
launch adds to ``fused_mlp.launch_counts`` under its grid's and precision's
name (``VARIANTS``: ``nffb_encode_f32``/``_bf16`` on the torch grid,
``nffb_ngp_encode_f32``/``_bf16`` on the ngp grid; launches and points),
which CUDA graphs fold as they fold the fused MLP's.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import torch

from ..utils.compile_cache import build_library
from . import fused_mlp as fm

# (in_dim, levels, features a level, out width) the kernel is built for, by
# grid: every NFFB of the repo's confs (the points encoder, the view
# directions' encoder), on the torch grid ('FFB', 'StyleModNFFB') and on the
# ngp grid ('FFBTcnn', whose level width is F where the torch grid's is 2F)
SHAPES = {"torch": frozenset({(3, 6, 2, 56), (3, 4, 2, 40)}),
          "ngp": frozenset({(3, 6, 2, 28), (3, 4, 2, 20)})}
# the interpolation each grid's kernel computes
INTERPOLATION = {"torch": "floor", "ngp": "linear"}
# the launch counters, by grid and precision (``fast``)
VARIANTS = {"torch": {False: "nffb_encode_f32", True: "nffb_encode_bf16"},
            "ngp": {False: "nffb_ngp_encode_f32", True: "nffb_ngp_encode_bf16"}}
# the C entry's ``grid`` argument (``enum Grid`` of the source)
GRID_KIND = {"torch": 0, "ngp": 1}

_CSRC = Path(__file__).resolve().parent / "csrc" / "nffb_encode.cu"
_lib = None


def load_library() -> ctypes.CDLL:
    """Build ``csrc/nffb_encode.cu`` (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library(_CSRC, "nffb_encode")))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    # grid, levels, width, style, bf16, round_corners, x, n, bound, tensors,
    # out, stream
    lib.nffb_encode.argtypes = [c_int, c_int, c_int, c_int, c_int, c_int, ptr, c_int,
                                ctypes.c_double, ctypes.POINTER(ptr), ptr, ptr]
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


def shape(module):
    """(grid, (in_dim, levels, features a level, out width)) of an NFFB
    module, as ``SHAPES`` keys them."""
    return module.grid_backend, (module.grid.spec.input_dim, module.n_levels, module.F,
                                 module.out_width)


def supports(module) -> bool:
    """Whether the kernel is built for ``module``: its grid, interpolation
    and shape, and on the ngp grid a cell's corner at +0.5 (no
    ``align_corners``) and levels whose rows fit 32 bits."""
    grid, dims = shape(module)
    spec = module.grid.spec
    if dims not in SHAPES[grid] or spec.interpolation != INTERPOLATION[grid]:
        return False
    return grid == "torch" or (not spec.align_corners and int(spec.level_sizes().max()) < 2**32)


def tensors(module) -> List[Optional[torch.Tensor]]:
    """The module's tensors in the order the C entry takes them: the grid's
    table, its Fourier projection ``B`` (None on the ngp grid), scales,
    sizes and offsets (int64), the slots' scales and phases, the style
    transform (None, None without style), each ``ff_lin`` layer's weight and
    bias, ``out_layer``'s, and on the ngp grid its dense strides (int64) and
    dense flags (bool); every other one float32."""
    grid = module.grid
    style = ([module.style.linear_transform.w, module.style.linear_transform.b]
             if module.style_modulation else [None, None])
    ff = grid.ff.B if module.grid_backend == "torch" else None
    out = [grid.table, ff, grid._grid_scales, grid._grid_sizes, grid._grid_offsets,
           module._scales, module._phase, *style]
    for lin in module.ff_lin:
        out += [lin.w, lin.b]
    out += [module.out_layer.w, module.out_layer.b]
    if module.grid_backend == "ngp":
        out += [grid._grid_strides, grid._grid_dense]
    return out


def dtypes(module) -> List[torch.dtype]:
    """The dtype the C entry takes at each index of ``tensors(module)``."""
    want = [torch.float32] * len(tensors(module))
    want[3] = want[4] = torch.int64        # the grid's sizes and offsets
    if module.grid_backend == "ngp":
        want[-2], want[-1] = torch.int64, torch.bool   # its strides and dense flags
    return want


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
    grid, dims = shape(module)
    if not supports(module):
        spec = module.grid.spec
        raise ValueError(f"the kernel is not built for NFFB on the {grid} grid with "
                         f"(in, L, F, width) = {dims}, {spec.interpolation} interpolation")
    in_dim = dims[0]
    check_input(x, in_dim)
    ts = tensors(module)
    for t, want in zip(ts, dtypes(module)):
        if t is not None:
            _check_tensor(t, want, x.device)
    n = x.shape[0]
    out = torch.empty(n, in_dim + module.out_width, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = load_library()
    pointers = (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr() for t in ts])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rounds = bool(fast) and grid == "ngp" and module.grid.spec.rounds_inference()
        err = lib.nffb_encode(GRID_KIND[grid], module.n_levels, module.out_width,
                              int(module.style_modulation), int(fast), int(rounds),
                              x.data_ptr(), n, float(module.bound), pointers, out.data_ptr(),
                              stream)
    if err != 0:
        raise RuntimeError(f"nffb_encode launch failed on the {grid} grid: CUDA error {err}")
    counts = fm.launch_counts[VARIANTS[grid][bool(fast)]]
    counts["launches"] += 1
    counts["points"] += n
    return out
