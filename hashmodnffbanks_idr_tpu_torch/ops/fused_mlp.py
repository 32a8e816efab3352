"""Fused SDF-MLP forward for the gradient-free sphere tracer.

Counterpart of ``hashmodnffbanks_idr_tpu/ops/fused_mlp.py``, whose Pallas
``_kernel`` this module's CUDA kernel (``csrc/fused_mlp.cu``) replaces.  It
computes the raw SDF channel of the IDR MLP (dims 8x512, skip at layer 4),
forward only, for N embedded points:

  l0: d_in->512, l1..l2: 512->512, l3: 512->(512-d_in),
  concat(input)/sqrt(2) written into the tail lanes after l3,
  l4..l7: 512->512, softplus(beta=100) after every hidden layer,
  l8: only the SDF column (a 512-long dot per point).

Two precisions, one kernel each: float32 weights (the 'exact' tracer; tensor
cores in split-TF32 on ``wgmma``, three TF32 products per float32 product,
which keeps float32 accuracy) and bfloat16 weights with float32
accumulation (the 'mixed'/'fast' tracer's guidance queries; bf16
``mma.sync``).  Both stream the weights through a ``cp.async`` ring.
Biases, softplus and the skip scaling stay float32.  Both kernels run each
64-point tile on a thread-block cluster of C CTAs (f32: 2 or 4; bf16: 1, 2
or 4), each computing 512/C columns of every layer and sharing the
activations through distributed shared memory; ``cluster_size`` chooses C
from N and each C's measured cost.

``fused_sdf_raw`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``fused_sdf_raw_plain``, the same math in
plain torch ops.  The kernel is built with ``nvcc`` for ``sm_90a`` into
the build cache (``utils/compile_cache.py``: ``build/`` at the repository
root unless ``HMNFFB_COMPILE_CACHE`` names another) on first use and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..utils.compile_cache import build_library, library_path
from .linear import Linear, softplus

N_MID = 7              # l1..l7
SKIP_AFTER_MID = 2     # the skip concat follows l3 = mid layer 2
KERNEL_HIDDEN = 512    # the CUDA kernel's compiled width
# the CUDA kernel's compiled first-layer depths: a launch takes the smallest
# that covers d_in (rows past d_in are zero); d_in < 512, as the skip after l3
# fills columns >= 512 - d_in (JAX supports_fusion, :47-54)
KERNEL_DEPTHS = (64, 128, 256, 512)
# points per tile of both kernels; the cluster sizes (CTAs that share one
# tile) of either
TILE = 64
CLUSTER_SIZES = (1, 2, 4)
# Each variant's time of one full wave of clusters of C (slots[C] / C tiles,
# one CTA an SM), in ms, by the cluster sizes it compiles: the cost
# ``cluster_size`` weighs.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
# with scripts/bench_fused_mlp_f32.py (``--dtype bf16``: 132, 66 and 30
# tiles at C = 1, 2, 4; f32: 66 and 30 tiles at C = 2, 4; the f32 kernel
# holds a partial and a float accumulator a column, which at C = 1 would
# not fit the registers).
WAVE_MS = {"fused_sdf_raw_f32": {2: 0.300, 4: 0.200},
           "fused_sdf_raw_bf16": {1: 0.146, 2: 0.098, 4: 0.089}}

_CSRC = Path(__file__).resolve().parent / "csrc" / "fused_mlp.cu"

# Kernel launches and points, per variant, counted by the wrapper only where
# it launches the CUDA kernel (chip_smoke.py reads them to show that the
# main path went through the kernel); the launches also by cluster size
# (``cluster_<C>``).  A launch recorded into a CUDA graph counts when the
# graph runs instead: ``utils/graphs.py`` adds a program's straight-line
# launches at each launch of it, and its loops' launches from the iteration
# totals the device keeps, folded in before every read here
# (``fold_device_counts``).
launch_counts: Dict[str, Dict[str, int]] = {
    name: {"launches": 0, "points": 0, **{f"cluster_{c}": 0 for c in CLUSTER_SIZES}}
    for name in WAVE_MS
}
# what adds in the launches only the device has counted (``utils/graphs.py``
# registers its fold)
device_folds: List[Callable[[], None]] = []


def fold_device_counts() -> None:
    """Add in the launches that only the device has counted, with one host
    read (a synchronisation) where there are any.  The readers below call
    it first."""
    for fold in device_folds:
        fold()


def reset_launch_counts() -> None:
    fold_device_counts()
    for c in launch_counts.values():
        for k in c:
            c[k] = 0


def snapshot_launch_counts() -> Dict[str, Dict[str, int]]:
    fold_device_counts()
    return {name: dict(c) for name, c in launch_counts.items()}


def launch_counts_since(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """What was counted since ``snapshot_launch_counts`` gave ``before``."""
    fold_device_counts()
    return {name: {k: v - before[name][k] for k, v in c.items()}
            for name, c in launch_counts.items()}


def add_launch_counts(delta: Dict[str, Dict[str, int]], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (``launch_counts_since``'s) to the counts:
    what a CUDA graph recorded, each time it runs (``utils/graphs.py``)."""
    for name, c in delta.items():
        for k, v in c.items():
            launch_counts[name][k] += times * v


def supports_fusion(dims: List[int], skip_in: Tuple[int, ...]) -> bool:
    """The standard IDR architecture: uniform hidden width, single skip at 4,
    d_in < hidden (JAX :47-54).  The CUDA kernel itself is compiled for
    hidden 512, which takes every d_in < 512; ``fused_sdf_raw`` raises on a
    CUDA tensor outside that."""
    if len(dims) != 10 or tuple(skip_in) != (4,):
        return False
    h = dims[1]
    if any(d != h for d in dims[1:-1]):
        return False
    return dims[0] < h and h % 128 == 0


@torch.no_grad()
def pack_params(lins: List[Linear], d_in: int, hidden: int,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Effective weights of the nine layers in the kernel's layout
    (JAX :57-96, without its 128-lane padding):

      w_in  (d_in, hidden)          b_in  (hidden,)
      w_mid (7, hidden, hidden)     b_mid (7, hidden)    # l3 zero-padded
      w_out (hidden,)               b_out (1,)           # SDF column only

    Weights are stored input-major (``h @ w``) in ``dtype``; biases float32."""
    def w_of(l):
        return lins[l].weight().detach().T  # (in, out)

    mids_w, mids_b = [], []
    for l in range(1, 1 + N_MID):
        w, b = w_of(l), lins[l].b.detach()
        if w.shape[1] != hidden:  # l3: hidden -> hidden - d_in; pad tail columns
            w = torch.nn.functional.pad(w, (0, hidden - w.shape[1]))
            b = torch.nn.functional.pad(b, (0, hidden - b.shape[0]))
        mids_w.append(w)
        mids_b.append(b)
    w_last = w_of(1 + N_MID)
    return {
        "w_in": w_of(0).to(dtype).contiguous(),
        "b_in": lins[0].b.detach().float().contiguous(),
        "w_mid": torch.stack(mids_w).to(dtype).contiguous(),
        "b_mid": torch.stack(mids_b).float().contiguous(),
        "w_out": w_last[:, 0].to(dtype).contiguous(),
        "b_out": lins[1 + N_MID].b.detach()[:1].float().contiguous(),
    }


def fused_sdf_raw_plain(x: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's math in plain torch ops: x (N, d_in) f32 -> raw SDF (N,).
    Each layer rounds its input to the weight type and accumulates in
    float32, as the kernel (and the Pallas kernel) does."""
    wd = packed["w_in"].dtype
    d_in = x.shape[1]
    hidden = packed["w_in"].shape[1]
    skip_cols = hidden - d_in
    inv_sqrt2 = 1.0 / math.sqrt(2.0)

    def dot(h, w):
        return h.to(wd).float() @ w.float()

    h = softplus(dot(x, packed["w_in"]) + packed["b_in"])
    for l in range(packed["w_mid"].shape[0]):
        h = softplus(dot(h, packed["w_mid"][l]) + packed["b_mid"][l])
        if l == SKIP_AFTER_MID:
            tail = x.to(wd).float() * inv_sqrt2
            h = torch.cat([h[:, :skip_cols] * inv_sqrt2, tail], dim=1)
    return dot(h, packed["w_out"][:, None])[:, 0] + packed["b_out"][0]


def fused_sdf_raw(x_embedded: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x_embedded (N, d_in) float32 -> raw SDF channel (N,) before the
    Laplace clamp.  No gradient: the tracer runs under ``no_grad``."""
    if x_embedded.requires_grad:
        raise ValueError("fused_sdf_raw has no gradient; call it under torch.no_grad()")
    if x_embedded.device.type == "cpu":
        return fused_sdf_raw_plain(x_embedded, packed)
    with torch.no_grad():
        return _launch(x_embedded, packed)


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------

_lib = None


def _lib_path() -> Path:
    """The built library of the current source (one per source content)."""
    return library_path(_CSRC, "fused_mlp")


def ptxas_report() -> Path:
    """Where the build of the current source left ``-Xptxas -v``'s report
    (registers, spills and shared memory of each kernel)."""
    return _lib_path().with_suffix(".ptxas.txt")


def load_library() -> ctypes.CDLL:
    """Build ``csrc/fused_mlp.cu`` (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    out = build_library(_CSRC, "fused_mlp")
    lib = ctypes.CDLL(str(out))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    for name in WAVE_MS:
        # x, n, d_in, k0, cluster, w_in, b_in, w_mid, b_mid, w_out, b_out, out, stream
        getattr(lib, name).argtypes = [ptr, c_int, c_int, c_int, c_int] + [ptr] * 8
        getattr(lib, f"{name}_slots").argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
        getattr(lib, name).restype = getattr(lib, f"{name}_slots").restype = c_int
    _lib = lib
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def cluster_sizes(variant: str) -> Tuple[int, ...]:
    """The cluster sizes ``variant``'s kernel compiles, smallest first."""
    return tuple(sorted(WAVE_MS[variant]))


def kernel_depth(d_in: int) -> int:
    """The compiled first-layer depth a launch with ``d_in`` inputs takes:
    the smallest of ``KERNEL_DEPTHS`` that covers it."""
    if not 0 < d_in < KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel takes 0 < d_in < {KERNEL_HIDDEN}; got d_in={d_in}")
    return next(k for k in KERNEL_DEPTHS if k >= d_in)


def cluster_size(n: int, slots: Dict[int, int], wave_ms: Dict[int, float]) -> int:
    """A kernel's cluster size C for ``n`` points: of the sizes in
    ``wave_ms`` that the card seats, the one of least modelled time, the
    waves of clusters ``ceil(tiles C / slots[C])`` (``tiles = ceil(n /
    TILE)``) times the measured time of one wave, ``wave_ms[C]`` (to 1e-9
    ms); a tie goes to the smaller C.  ``slots[C]`` is C times the clusters
    of size C that can run at once (the card's occupancy query,
    ``cluster_slots``); ``wave_ms`` is the variant's ``WAVE_MS``."""
    tiles = -(-n // TILE)
    cost = {c: -(-tiles * c // slots[c]) * wave_ms[c] for c in sorted(wave_ms) if slots[c] > 0}
    return min(cost, key=lambda c: (round(cost[c], 9), c))


_slots: Dict[Tuple[str, int, int], Dict[int, int]] = {}


def cluster_slots(variant: str, k0: int, device: torch.device) -> Dict[int, int]:
    """C -> C x the clusters of C CTAs of ``variant``'s kernel at depth ``k0``
    that can run at once on ``device``, for each C the kernel compiles,
    queried once per (variant, device, K0) with
    ``cudaOccupancyMaxActiveClusters``."""
    with torch.cuda.device(device):
        key = (variant, torch.cuda.current_device(), k0)
        if key not in _slots:
            query = getattr(load_library(), f"{variant}_slots")
            slots = {}
            for c in cluster_sizes(variant):
                got = ctypes.c_int(0)
                err = query(k0, c, ctypes.byref(got))
                if err != 0:
                    raise RuntimeError(f"occupancy query of {variant} (K0={k0}, cluster {c}) "
                                       f"failed: CUDA error {err}")
                slots[c] = got.value
            _slots[key] = slots
    return _slots[key]


def _launch(x: torch.Tensor, packed: Dict[str, torch.Tensor],
            cluster: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel of ``packed``'s weight type on ``x``.  ``cluster``
    forces the cluster size, one of ``cluster_sizes(variant)`` (the card's
    checks hold every C against the smallest); by default ``cluster_size``
    chooses it from N."""
    n, d_in = x.shape
    wd = packed["w_in"].dtype
    if wd == torch.float32:
        variant = "fused_sdf_raw_f32"
    elif wd == torch.bfloat16:
        variant = "fused_sdf_raw_bf16"
    else:
        raise ValueError(f"packed weights of dtype {wd} are not supported")
    hidden = packed["w_in"].shape[1]
    if hidden != KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel is compiled for hidden={KERNEL_HIDDEN}; "
                         f"got hidden={hidden}")
    k0 = kernel_depth(d_in)
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x_embedded must be a contiguous float32 (N, d_in) tensor")
    _check(packed["w_in"], "w_in", (d_in, hidden), wd, dev)
    _check(packed["b_in"], "b_in", (hidden,), torch.float32, dev)
    _check(packed["w_mid"], "w_mid", (N_MID, hidden, hidden), wd, dev)
    _check(packed["b_mid"], "b_mid", (N_MID, hidden), torch.float32, dev)
    _check(packed["w_out"], "w_out", (hidden,), wd, dev)
    _check(packed["b_out"], "b_out", (1,), torch.float32, dev)
    if cluster is not None and cluster not in cluster_sizes(variant):
        raise ValueError(f"{variant}: cluster must be one of {cluster_sizes(variant)}; "
                         f"got {cluster}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    pointers = [packed[k].data_ptr() for k in ("w_in", "b_in", "w_mid", "b_mid", "w_out",
                                               "b_out")]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster is None:
            cluster = cluster_size(n, cluster_slots(variant, k0, dev), WAVE_MS[variant])
        err = getattr(lib, variant)(x.data_ptr(), n, d_in, k0, cluster, *pointers,
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{variant} launch failed (cluster {cluster}): CUDA error {err}")
    launch_counts[variant]["launches"] += 1
    launch_counts[variant]["points"] += n
    launch_counts[variant][f"cluster_{cluster}"] += 1
    return out
