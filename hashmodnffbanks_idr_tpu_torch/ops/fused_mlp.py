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
``wgmma``, its weights copied by the Tensor Memory Accelerator from the
pre-tiled ``w_img`` that ``pack_params`` adds; the f32 kernel streams its
weights through a ``cp.async`` ring).  Biases, softplus and the skip
scaling stay float32.  Both kernels run each tile of
points on a thread-block cluster of C CTAs, each computing 512/C columns of
every layer and sharing the activations through distributed shared memory:
f32 64-point tiles on clusters of 2 or 4; bf16 64-point tiles on one CTA
and 128-point tiles on clusters of 4 (``TILES``).  ``cluster_size``
chooses the configuration from N and each one's measured cost.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
# Each variant's configurations, by cluster size C (the CTAs that share one
# tile): the points a tile at each C it compiles, which the kernel fixes by
# C (csrc/fused_mlp.cu) and ``cluster_size``'s cost reads.  The f32 kernel
# holds a partial and a float accumulator a column, which at C = 1 would not
# fit the registers.  The bf16 kernel's two consumer warpgroups own 64 rows each of a
# 128-point tile at C = 4, so that each weight byte read from L2 serves 128
# points; at C = 1 that would take 256 accumulators a thread, so its tile is
# 64 points there; its C = 2 (a 128-point tile), whose waves end where C =
# 1's do and run slower on the H100, is not compiled (csrc/fused_mlp.cu).
TILES = {"fused_sdf_raw_f32": {2: 64, 4: 64},
         "fused_sdf_raw_bf16": {1: 64, 4: 128}}
CLUSTER_SIZES = (1, 2, 4)
# Each variant's time of one full wave of clusters at each configuration
# (slots[C] / C tiles, one CTA an SM), in ms: the cost ``cluster_size``
# weighs.  Measured on an NVIDIA H100 80GB HBM3 at 700 W with
# scripts/bench_fused_mlp_f32.py (``--dtype bf16``: 132 tiles of 64 points
# at C = 1, 30 tiles of 128 at C = 4; f32: 66 and 30 tiles of 64 at C = 2,
# 4).
WAVE_MS = {"fused_sdf_raw_f32": {2: 0.300, 4: 0.200},
           "fused_sdf_raw_bf16": {1: 0.077, 4: 0.074}}

_CSRC = Path(__file__).resolve().parent / "csrc" / "fused_mlp.cu"

# Kernel launches and points, per variant, counted by the wrapper only where
# it launches the CUDA kernel (chip_smoke.py reads them to show that the
# main path went through the kernel); the launches also by configuration
# (``cluster_<C>``: clusters of C, on tiles of ``TILES[variant][C]``).  A
# launch recorded into a CUDA graph counts when the graph runs instead:
# ``utils/graphs.py`` adds a program's straight-line launches at each launch
# of it, and its loops' launches from the iteration totals the device
# keeps, folded in before every read here (``fold_device_counts``).
launch_counts: Dict[str, Dict[str, int]] = {
    name: {"launches": 0, "points": 0, **{f"cluster_{c}": 0 for c in CLUSTER_SIZES}}
    for name in WAVE_MS
}
# the NFFB encode kernel's (ops/nffb_encode.py), by grid and precision,
# counted the same way
launch_counts.update({name: {"launches": 0, "points": 0}
                      for name in ("nffb_encode_f32", "nffb_encode_bf16",
                                   "nffb_ngp_encode_f32", "nffb_ngp_encode_bf16")})
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


def kernel_takes(dims: List[int], skip_in: Tuple[int, ...], device) -> bool:
    """Whether the CUDA kernel launches for an SDF network of widths ``dims``
    and skip ``skip_in`` whose parameters are on ``device``: a CUDA device,
    the architecture of ``supports_fusion`` at the compiled hidden width
    (every d_in under it has a compiled depth, ``kernel_depth``)."""
    return (torch.device(device).type == "cuda" and supports_fusion(dims, skip_in)
            and dims[1] == KERNEL_HIDDEN)


@torch.no_grad()
def pack_params(lins: List[Linear], d_in: int, hidden: int,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Effective weights of the nine layers in the kernel's layout
    (JAX :57-96, without its 128-lane padding):

      w_in  (d_in, hidden)          b_in  (hidden,)
      w_mid (7, hidden, hidden)     b_mid (7, hidden)    # l3 zero-padded
      w_out (hidden,)               b_out (1,)           # SDF column only

    Weights are stored input-major (``h @ w``) in ``dtype``; biases float32.
    bf16 weights on a CUDA device at the kernel's shape take the bf16
    kernel's weight stream, ``w_img`` (``stream_image``), in place of
    ``w_in`` and ``w_mid``; ``plain_pack`` reads them back."""
    def w_of(l):
        return lins[l].weight().detach().T  # (in, out)

    mids_w, mids_b = [], []
    for l in range(1, 1 + N_MID):
        w, b = w_of(l), lins[l].b.detach()
        if w.shape[1] != hidden:  # l3: hidden -> hidden - d_in; pad tail columns
            w = torch.nn.functional.pad(w, (0, hidden - w.shape[1]))
            b = torch.nn.functional.pad(b, (0, hidden - b.shape[0]))
        mids_w.append(w.to(dtype))
        mids_b.append(b)
    w_last = w_of(1 + N_MID)
    packed = {
        "b_in": lins[0].b.detach().float().contiguous(),
        "b_mid": torch.stack(mids_b).float().contiguous(),
        "w_out": w_last[:, 0].to(dtype).contiguous(),
        "b_out": lins[1 + N_MID].b.detach()[:1].float().contiguous(),
    }
    w_in = w_of(0).to(dtype)
    if (dtype == torch.bfloat16 and lins[0].b.is_cuda and hidden == KERNEL_HIDDEN
            and 0 < d_in < KERNEL_HIDDEN):
        packed["w_img"] = stream_image(w_in, mids_w)
    else:
        packed["w_in"] = w_in.contiguous()
        packed["w_mid"] = torch.stack(mids_w).contiguous()
    return packed


def stream_image(w_in: torch.Tensor, w_mid: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bf16 kernel's weight stream, as it copies it into shared memory:
    l0's rows zero-padded to its compiled depth K0 (``kernel_depth``), then
    l1..l7's (``w_mid``: the seven (hidden, hidden) weights, or their
    stack), as core matrices of 8 rows k x 8 columns n (128 bytes, n
    fastest), ordered by 8-row group, then 8-column group: (K0 + 7 hidden)
    / 8 x hidden / 8 x 8 x 8, element (k, n) of the stream at [k // 8, n //
    8, k % 8, n % 8].  A CTA's chunk of columns is one run of bytes per
    8-row group (csrc/fused_mlp.cu, bf16k::copy_chunk)."""
    d_in, hidden = w_in.shape
    k0 = kernel_depth(d_in)
    w = torch.cat([torch.nn.functional.pad(w_in, (0, 0, 0, k0 - d_in)), *w_mid])
    return w.view(w.shape[0] // 8, 8, hidden // 8, 8).transpose(1, 2).contiguous()


def plain_pack(packed: Dict[str, torch.Tensor], d_in: int) -> Dict[str, torch.Tensor]:
    """``packed`` with its weights as ``w_in`` and ``w_mid``, the plain
    twin's form: as it is where it holds them, else read back from the bf16
    kernel's stream ``w_img`` (``stream_image``) for a first layer of
    ``d_in`` inputs."""
    if "w_mid" in packed:
        return packed
    img = packed["w_img"]
    hidden = img.shape[1] * 8
    w = img.transpose(1, 2).reshape(-1, hidden)
    rest = {k: v for k, v in packed.items() if k != "w_img"}
    return {**rest, "w_in": w[:d_in],
            "w_mid": w[w.shape[0] - N_MID * hidden:].view(N_MID, hidden, hidden)}


def fused_sdf_raw_plain(x: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's math in plain torch ops: x (N, d_in) f32 -> raw SDF (N,).
    Each layer rounds its input to the weight type and accumulates in
    float32, as the kernel (and the Pallas kernel) does."""
    d_in = x.shape[1]
    packed = plain_pack(packed, d_in)
    wd = packed["w_in"].dtype
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
# each variant's tensors, in the order its C entry takes them
POINTERS = {"fused_sdf_raw_f32": ("w_in", "b_in", "w_mid", "b_mid", "w_out", "b_out"),
            "fused_sdf_raw_bf16": ("w_img", "b_in", "b_mid", "w_out", "b_out")}


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
        # x, n, d_in, k0, cluster, the tensors (POINTERS), out, stream
        getattr(lib, name).argtypes = [ptr, c_int, c_int, c_int, c_int] + [ptr] * (
            len(POINTERS[name]) + 2)
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


def cluster_size(n: int, slots: Dict[int, int], wave_ms: Dict[int, float],
                 tiles: Dict[int, int]) -> int:
    """A kernel's configuration for ``n`` points, as its cluster size C (on
    tiles of ``tiles[C]`` points): of the sizes in ``wave_ms`` that the
    card seats, the one of least modelled time, the waves of clusters
    ``ceil(ceil(n / tiles[C]) C / slots[C])`` times the measured time of one
    wave, ``wave_ms[C]`` (to 1e-9 ms); a tie goes to the smaller C.
    ``slots[C]`` is C times the clusters of size C that can run at once
    (the card's occupancy query, ``cluster_slots``); ``wave_ms`` and
    ``tiles`` are the variant's ``WAVE_MS`` and ``TILES``."""
    cost = {c: -(-(-(-n // tiles[c])) * c // slots[c]) * wave_ms[c]
            for c in sorted(wave_ms) if slots[c] > 0}
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
    forces the configuration by its cluster size, one of
    ``cluster_sizes(variant)``, on that size's tile (``TILES``; the card's
    checks hold every C against the smallest); by default ``cluster_size``
    chooses it from N."""
    n, d_in = x.shape
    wd = packed["w_out"].dtype
    if wd == torch.float32:
        variant = "fused_sdf_raw_f32"
    elif wd == torch.bfloat16:
        variant = "fused_sdf_raw_bf16"
    else:
        raise ValueError(f"packed weights of dtype {wd} are not supported")
    hidden = packed["b_in"].shape[0]
    if hidden != KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel is compiled for hidden={KERNEL_HIDDEN}; "
                         f"got hidden={hidden}")
    k0 = kernel_depth(d_in)
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x_embedded must be a contiguous float32 (N, d_in) tensor")
    shapes = {"w_in": (d_in, hidden), "b_in": (hidden,), "w_mid": (N_MID, hidden, hidden),
              "b_mid": (N_MID, hidden), "w_out": (hidden,), "b_out": (1,),
              "w_img": ((k0 + N_MID * hidden) // 8, hidden // 8, 8, 8)}
    for k in POINTERS[variant]:
        if k not in packed:
            raise ValueError(f"{variant} takes packed[{k!r}] (pack_params on the device)")
        _check(packed[k], k, shapes[k], wd if k.startswith("w") else torch.float32, dev)
    if cluster is not None and cluster not in cluster_sizes(variant):
        raise ValueError(f"{variant}: cluster must be one of {cluster_sizes(variant)}; "
                         f"got {cluster}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    pointers = [packed[k].data_ptr() for k in POINTERS[variant]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster is None:
            cluster = cluster_size(n, cluster_slots(variant, k0, dev), WAVE_MS[variant],
                                   TILES[variant])
        err = getattr(lib, variant)(x.data_ptr(), n, d_in, k0, cluster, *pointers,
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{variant} launch failed (cluster {cluster}): CUDA error {err}")
    launch_counts[variant]["launches"] += 1
    launch_counts[variant]["points"] += n
    launch_counts[variant][f"cluster_{cluster}"] += 1
    return out
