#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``hashmodnffbanks_idr_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It prints the versions of the CUDA toolkit and the CUDA driver, builds the CUDA
sources of ``hashmodnffbanks_idr_tpu_torch/ops/csrc`` (``fused_mlp.cu`` and
``graph_loops.cu``, one ``nvcc`` each, started together) into ``build/``,
holds each kernel variant against its plain PyTorch twin at
the flagship widths, and at every configuration it compiles (the CTAs C
that share a tile and the tile's points: f32 64-point tiles at C = 2 and
4; bf16 a 64-point tile at C = 1 and a 128-point tile at C = 4)
against the twin and bit for bit against its smallest C (N = 1, 63, 64,
65, 127, 128, 129, 2048, 2049, 4096, 4113), times each C at each timed
call and
prints the C that ``fused_mlp.cluster_size`` takes there with the card's
slots (it fails where that C is over 10% slower than the fastest forced
one), checks small train steps on the card against the
same steps on the CPU (the flagship in exact+fused, the instant-ngp log2=15
preset unfused and in ``mixed``, through the bf16 kernel: loss within 1%,
hit masks on 98% of the rays), launches each variant 100 times at each
compiled first-layer depth and each C on one input of 4113 points and
requires the same bits every time (``deterministic`` in the kernels line),
holds the f32 kernel at each depth and C against its twin at N = 256,
2048, 4096, 24576, 49152 and 69632,
holds ``set_while`` (a CUDA graph's while-node condition set on the device)
against the loop that reads its predicate on the host and times an
iteration of each (``[set_while]``), then drives
the flagship StyleModNFFB training step
(2048 rays, 1200x1600 synthetic two-view scene, random weights from a seed)
in four tracer configurations, and FFB_TCNN's (``benchmark/configs/
idr-ffbtcnn-log2-15.conf``, NFFB on the instant-ngp grid) in ``mixed``,
and times them.  Before them the ``[encode]`` phase holds the NFFB encode
kernel on both grids (the flagship's and FFB_TCNN's points and view
encoders) against the plain forward in both precisions and times it
beside its bound.  Every train step on the card,
there and in every phase after, is the step launched as one CUDA graph a
step, its tracer loops conditional while-nodes (``build_train_step``'s
default on the card; each runner's step must be one, captured once).  The
``[graph]`` phase holds it against the eager step (``graphed=False``) in
five cells (the flagship's four and ngp log2=15 mixed), in turns: step 1's
loss terms and hit masks bit-identical, then with deterministic index ops
10 steps bit-identical (loss terms, masks, parameters) with the fused
kernels' launches and each loop's iterations (the device totals) counted
as the eager step counts them, one graph launch a step and no host
synchronisation inside it (sync-debug mode "error"), a NaN step skipped on
the device; it prints each variant's ms/step, the capture's seconds, the
loop totals and the eager step's host syncs a step.  Then it runs the user's path:
the port's ``dummy_cli`` writes the dummy scene, ``exp_runner`` trains the
repo's ``dummy_stylemodnffb.conf`` (with the ``mixed`` tracer) for 30 epochs
and resumes it to epoch 32, and a DTU-size scan (49 distinct views) is
decoded through ``SceneDataset`` in worker processes and again serially,
the two held equal view by view (``scripts/time_scene_decode.py`` times
the decode in threads as well).  Then the eval path: the port's ``dtu_shaped``
generates the anchor scene on the card, ``exp_runner`` trains the repo's
``headtohead_ours_400_f32.conf`` for 20 epochs with plots every 10,
``run_eval`` and ``dtu_chamfer`` score it, and one view is rendered
unfused, through the f32 kernel and through the bf16 kernel (``mixed``)
and compared, and each kernel is held against its plain twin on the
largest call that render gave it.  The ``[ngp]`` phase holds both kernels
against their plain twins at every encoder's first-layer depth (d_in 9, 15,
27, 59, 102, and 198 and 510 for the K0 256 and 512 builds, at N=4096,
timed), checks a 256-ray HashGridTcnn step on the
card against the CPU, times the instant-ngp presets' step (log2=15 in
exact+fused and mixed, log2=19 in mixed, the K=3 pruned variant in both;
each cell must launch its kernel), holds each kernel on the largest call
those steps gave it, and trains the repo's ``dtu_shaped_hashgridtcnn.conf``
and ``dtu_shaped_posenc.conf`` for 30 epochs each through ``exp_runner``
on the eval phase's scene (the loss must fall by a fifth, the bf16 kernel
run every epoch).  The ``[cameras]`` phase, on the same scene, holds a
256-ray trainable-camera step of ``headtohead_ours_trained_cameras_400.conf``
on the card (through the f32 kernel) against the CPU, trains that conf
through ``exp_runner --train_cameras`` for 30 epochs and resumes it to 32
(the pose table and its SparseAdam state restored bit for bit), aligns the
trained cameras with ``run_eval --eval_cameras``, and runs
``preprocess_cameras`` with its voxel carves on the card (votes equal to
the CPU's).  Last, ``[parallel]``: one rank per card over NCCL (a 1x1 mesh
on a one-card machine) runs ``graft_entry.dryrun_multichip``'s four sharded
configurations, then the flagship step (2048 rays, exact+fused) sharded and
unsharded from the same weights and draws (loss terms within 1e-6
relative, parameters within 5e-4 / 2e-6, the f32 kernel launched on every
rank and held against its plain twin on the largest call the sharded step
gave it, a parameter checksum equal across ranks), times 10 steps of each,
and trains the dummy conf (mixed) through ``IDRTrainRunner(mesh=...)``.  It
fails if ``-Xptxas -v`` reports a spill in either kernel at any
compiled first-layer depth and cluster size.  The kernels line gives each
kernel's configurations (``cluster`` and ``ms_by_cluster`` by N, ``slots``,
``tiles`` by C, ``launches_by_cluster`` on its first main-path cell,
exact+fused or mixed, whose march calls of 4096 points must run on the
rule's configuration).  The step and runner records give the launches a
step by configuration (``<tile>x<C>``).  Every
runner record reports the steps whose update the train step skipped
(``skipped_steps``).  Any failed check
raises and the script exits non-zero.  The second-to-last line is the kernels' JSON
record (the two fused variants and ``set_while``), the last line
``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package, and exits non-zero
without a result when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit): f32 on the
# CUDA cores, tf32 and bf16 on the tensor cores
from hashmodnffbanks_idr_tpu_torch.ops import graph_loops as gl
from hashmodnffbanks_idr_tpu_torch.utils import graphs
from hashmodnffbanks_idr_tpu_torch.utils.compile_cache import nvcc
from hashmodnffbanks_idr_tpu_torch.utils.profiling import H100_PEAK_BYTES_PER_S as PEAK_BYTES_PER_S
from hashmodnffbanks_idr_tpu_torch.utils.profiling import H100_PEAK_FLOPS as PEAK_FLOPS
from hashmodnffbanks_idr_tpu_torch.utils.profiling import host_syncs

TOL_F32 = 1e-5     # GPU expf/log1pf and the summation order differ from the CPU
TOL_BF16 = 3e-2    # bf16 operands (tests/test_fused_mlp.py:36-40)
# per variant: weight type, tolerance, and the peak and the number of
# products per product that bound it (f32 runs three TF32 products: split-TF32)
VARIANTS = (("fused_sdf_raw_f32", torch.float32, TOL_F32, "tf32", 3),
            ("fused_sdf_raw_bf16", torch.bfloat16, TOL_BF16, "bf16", 1))
N_RAYS = 2048
IMG_RES = (1200, 1600)
ALPHA = 50.0
# the edges of both kernels' 64-point tile, and the kernel's batch sizes on
# the main path at 2048 rays: secant (2048), march and line search
# (2 x 2048), exact sweep coarse/fine probes (12 and 24 per ray), mixed sweep
# coarse probes (34 per ray)
TILE = 64
CHECK_N = (1, TILE - 1, TILE, TILE + 1, 513, 2048, 4096, 24576, 49152, 69632)
# each variant's largest calls on the main path, the last where its time is
# reported (f32: the flagship's exact sweep, 49152, and the ngp cells',
# 69632; bf16: the mixed march, 4096, the fast sweep, 49152, and the mixed
# sweep's coarse probes, 69632); it is also timed at the small calls (the
# camera step's 256 rays, secant, march), which fill few SMs
TIME_N = {"fused_sdf_raw_f32": (69632, 49152), "fused_sdf_raw_bf16": (4096, 49152, 69632)}
TIME_SMALL_N = (256, 2048, 4096)
# at every timed call the rule's cluster size may be at most this much
# slower than the fastest forced one of the same run
RULE_SLACK = 1.10
# each variant at every configuration it compiles (fm.cluster_sizes: f32 2
# and 4, bf16 1 and 4, on the tiles of fm.TILES), forced, against the
# plain twin and bit for bit against its smallest C on the same input: the
# edges of the 64- and 128-point tiles, the secant's and the march's sizes
# and one past them, and the determinism input
CLUSTER_CHECK_N = (1, TILE - 1, TILE, TILE + 1, 2 * TILE - 1, 2 * TILE, 2 * TILE + 1, 2048,
                   2049, 4096, 4113)
# each variant's kernel in the ``-Xptxas -v`` report, by its namespace in the
# mangled name (csrc/fused_mlp.cu: f32::, bf16k::), and the cluster sizes C,
# the template argument after K0 of its instantiations (each C one tile:
# fm.TILES)
PTXAS_ENTRY = {"fused_sdf_raw_f32": ("3f3216fused_sdf_kernel", (2, 4)),
               "fused_sdf_raw_bf16": ("5bf16k16fused_sdf_kernel", (1, 4))}
# the runner phase: the repo's dummy check (read in place, not imported)
DUMMY_CONF = Path(__file__).resolve().parent / "hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf"
RUNNER_EPOCHS = 30
DTU_RES = (1200, 1600)
# the eval phase: the 400-epoch anchor's conf and scene shape (8 views of
# 240x320, scan 0, GT mesh at 320), cut to 20 epochs with plots every 10
ANCHOR_CONF = DUMMY_CONF.parent / "headtohead_ours_400_f32.conf"
EVAL_EPOCHS, EVAL_PLOT_FREQ = 20, 10
# each eval-render variant against the unfused f32 render of the same view
# and checkpoint: (label, tracer_fast, tracer_exact_fused, kernel, least
# share of equal hit-mask pixels, |dPSNR| bound in dB).  The f32 kernel's
# bounds sit near its measured 100% / 2e-6 dB, so a kernel that ran at bf16
# precision (mixed reads 99.988% / 0.017 dB) fails them
EVAL_VARIANTS = (("exact+fused", "exact", True, "fused_sdf_raw_f32", 0.999, 1e-3),
                 ("mixed", "mixed", False, "fused_sdf_raw_bf16", 0.98, 1.5))
KERNEL_TOL = {"fused_sdf_raw_f32": TOL_F32, "fused_sdf_raw_bf16": TOL_BF16}
# each variant's design, as the kernels line names it (csrc/fused_mlp.cu)
KERNEL_DESIGN = {
    "fused_sdf_raw_f32": "split-TF32 wgmma.mma_async m64nNk8 (N = 512/C/2), A from registers "
                         "split once a warpgroup, B as TF32 hi and lo split once a chunk by "
                         "a producer warpgroup into a K-major shared layout, a fresh "
                         "partial sum folded every 32 k; a 64-point tile on a cluster of 2 "
                         "or 4 CTAs over DSMEM; cp.async weight ring",
    "fused_sdf_raw_bf16": "bf16 wgmma.mma_async m64nNk16, A (the bf16 tile, K-major) and B "
                          "(the weights, MN-major) from shared memory through descriptors, "
                          "float accumulators; two consumer warpgroups, each 64 rows of a "
                          "128-point tile on a cluster of 4 CTAs (one weight stream for 128 "
                          "points) or half the columns of a 64-point tile on one CTA; "
                          "a producer warpgroup's ring of bulk copies (TMA) from a pre-tiled "
                          "weight image; DSMEM stores"}
# the [ngp] phase.  Each encoder's first-layer depth, from the flagship conf
# with that SDF encoder: FourierFeatures 9, HashGridTcnn 15, HashGrid 27,
# StyleModNFFB 59, NerfPos at multires 16 (dtu_shaped_posenc.conf) 102.  No
# conf gives a depth past 128; NerfPos at multires 32 (198) and 84 (510)
# holds the kernels compiled for K0 256 and 512
CHECK_D_IN = {9: ("FourierFeatures", {}), 15: ("HashGridTcnn", {}), 27: ("HashGrid", {}),
              59: ("StyleModNFFB", {}), 102: ("NerfPos", {"model.implicit_network.multires": 16}),
              198: ("NerfPos", {"model.implicit_network.multires": 32}),
              510: ("NerfPos", {"model.implicit_network.multires": 84})}
DEPTH_N = 4096
# each variant at each compiled depth, launched this many times on one input
# of this many points (65 blocks, the last one ragged): bit-identical outputs
DETERMINISM_LAUNCHES = 100
DETERMINISM_N = 4113
# the f32 kernel at each compiled depth and cluster size against its plain
# twin at the main path's sizes: the camera step's 256 rays, the secant's
# 2048, the march's 4096, the exact sweep's probes, the ngp cells' largest
F32_HELD_N = (256, 2048, 4096, 24576, 49152, 69632)
# the bench.py ngp presets (testing.NGP_PRESETS) at 2048 rays: (preset,
# label, tracer_fast, tracer_exact_fused, the kernel the cell must launch)
NGP_CELLS = (("ngp_log2_15", "exact+fused", "exact", True, "fused_sdf_raw_f32"),
             ("ngp_log2_15", "mixed", "mixed", False, "fused_sdf_raw_bf16"),
             ("ngp_log2_19", "mixed", "mixed", False, "fused_sdf_raw_bf16"),
             ("ngp_log2_15_k3", "exact+fused", "exact", True, "fused_sdf_raw_f32"),
             ("ngp_log2_15_k3", "mixed", "mixed", False, "fused_sdf_raw_bf16"))
# the repo's hash-grid and positional-encoding confs, read in place, trained
# on the eval phase's scene (only img_res and data_dir overridden).  An
# epoch logs the loss of its last step, which swings by +-50% from epoch to
# epoch at these confs' learning rate (1e-4), so the loss must fall
# as a median: the median of the last 5 epochs' losses below
# NGP_RUNNER_FALL x the median of the first 5.  In 10 epochs the fall is
# within that noise; by 30 the median has roughly halved
NGP_RUNNER_CONFS = ("dtu_shaped_hashgridtcnn.conf", "dtu_shaped_posenc.conf")
NGP_RUNNER_EPOCHS = 30
NGP_RUNNER_WINDOW = 5
NGP_RUNNER_FALL = 0.8
# the [cameras] phase: the repo's trained-camera conf, read in place, on the
# eval phase's scene (its dataset block names that scene).  A 256-ray step
# at full width with the exact tracer through the f32 kernel, on the card
# and on the CPU from the same weights, poses and draws: each loss term
# within CAM_LOSS_RTOL, hit masks >= CAM_MASK_AGREE, the pose gradient
# and SparseAdam's first moment within CAM_GRAD_TOL of their largest entry,
# and after the step the poses within CAM_POSE_TOL wherever |g| exceeds
# twice the gradient's tolerance (SparseAdam's first step moves a component
# by lr_cam * g / (|g| + eps), about lr_cam * sign(g), so only where |g| is
# within the tolerance may the two sides' steps differ, by up to 2 lr_cam).
# Read on an NVIDIA H100 80GB HBM3 at 700 W: loss 2.2e-7, masks 100%,
# gradient 4.9e-7, poses bit-equal
TRAINED_CONF = DUMMY_CONF.parent / "headtohead_ours_trained_cameras_400.conf"
CAM_STEP_RAYS = 256
CAM_LOSS_RTOL, CAM_MASK_AGREE, CAM_GRAD_TOL, CAM_POSE_TOL = 1e-5, 1.0, 1e-4, 1e-6
CAM_EPOCHS = 30
# the [parallel] phase: one rank per card over NCCL (a 1x1 mesh on a one-card
# machine).  ``graft_entry.dryrun_multichip`` runs its four sharded
# configurations; then each rank takes the flagship step (2048 rays,
# exact+fused) under the mesh and again unsharded from the same weights and
# draws: loss terms within PAR_LOSS_RTOL of each other, every parameter after
# the step within PAR_PARAM_RTOL / PAR_PARAM_ATOL (the JAX sharding
# equivalence test's bounds, tests/test_sharding_equivalence.py:104-106);
# PAR_STEPS steps of each are timed, alternating; then the dummy conf (mixed) trains
# PAR_RUNNER_EPOCHS epochs through ``IDRTrainRunner(mesh=...)``
PAR_LOSS_RTOL, PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-6, 5e-4, 2e-6
PAR_WARMUP, PAR_STEPS = 2, 10
PAR_RUNNER_EPOCHS = 3
# the [graph] phase: the step replayed from CUDA graphs against the eager
# step in five cells (label, ngp preset or None for the flagship,
# tracer_fast, tracer_exact_fused, the kernel it must launch); GRAPH_TIMED
# steps of each as they run by default, GRAPH_HELD with deterministic index
# ops, held bit for bit
GRAPH_CELLS = (("exact+fused", None, "exact", True, "fused_sdf_raw_f32"),
               ("mixed", None, "mixed", False, "fused_sdf_raw_bf16"),
               ("fast", None, "fast", False, "fused_sdf_raw_bf16"),
               ("exact (unfused)", None, "exact", False, None),
               ("ngp log2=15 mixed", "ngp_log2_15", "mixed", False, "fused_sdf_raw_bf16"))
GRAPH_TIMED, GRAPH_HELD = 11, 10


# the set_while kernel (ops/csrc/graph_loops.cu) in a while-node against its
# plain twin, the loop that reads its predicate on the host: (limit,
# max_iters) of a counting loop that ends on its predicate, is cut by its
# cap, runs no body, has cap 0; then SET_WHILE_TIMED iterations timed
SET_WHILE_CASES = ((5, 10), (5, 3), (0, 10), (5, 0))
SET_WHILE_TIMED = 10000
# bytes one set_while moves: the predicate and the counter read, the total
# read and written
SET_WHILE_BYTES = 1 + 8 + 8 + 8


def by_config(counts, name: str, per: int) -> dict:
    """A variant's launches by configuration (``<tile>x<C>``), over ``per``
    (steps)."""
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm

    return {f"{fm.TILES[name][c]}x{c}": counts[name][f"cluster_{c}"] / per
            for c in fm.cluster_sizes(name)}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; warm L2, as in the tracer's repeated calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sdf_mlp_cost(n: int, d_in: int, hidden: int, itemsize: int):
    """FLOPs and bytes (each input read once, the output written once) of
    the raw-SDF chain for n points."""
    skip_w = hidden - d_in
    macs = d_in * hidden + 6 * hidden * hidden + hidden * skip_w + hidden
    weights = (d_in * hidden + 6 * hidden * hidden + hidden * skip_w + hidden) * itemsize
    biases = (8 * hidden + 1) * 4
    return 2 * n * macs, n * d_in * 4 + weights + biases + n * 4


def library_chain(x, packed):
    """The same nine-layer chain as cuBLAS GEMMs in the weight type with
    torch's own softplus: the yardstick (the port never calls it).
    ``packed`` in the plain twin's form (``fused_mlp.plain_pack``)."""
    import torch.nn.functional as F

    wd = packed["w_in"].dtype
    skip_cols = packed["w_in"].shape[1] - x.shape[1]
    xw = x.to(wd)
    h = F.softplus(torch.addmm(packed["b_in"].to(wd), xw, packed["w_in"]), 100.0, 20.0)
    for l in range(packed["w_mid"].shape[0]):
        h = F.softplus(torch.addmm(packed["b_mid"][l].to(wd), h, packed["w_mid"][l]), 100.0, 20.0)
        if l == 2:
            h = torch.cat([h[:, :skip_cols], xw], dim=1) * (1.0 / math.sqrt(2.0))
    return torch.addmm(packed["b_out"].to(wd), h, packed["w_out"][:, None])[:, 0]


@torch.no_grad()
def hold_against_plain(fm, name, x, packed, where="") -> float:
    """One kernel call against its plain twin on the same inputs: max abs
    error within the variant's tolerance, and for bf16 the same sign where
    |sdf| > 5e-2.  Returns the error."""
    tol = KERNEL_TOL[name]
    got = fm.fused_sdf_raw(x, packed)
    want = fm.fused_sdf_raw_plain(x, packed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[kernel] {name} N={x.shape[0]}{where}: max_abs_err={err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name} N={x.shape[0]}{where}: max abs err {err} > {tol}")
    if packed["w_out"].dtype == torch.bfloat16:
        big = want.abs() > 5e-2
        if not bool((torch.sign(got[big]) == torch.sign(want[big])).all()):
            raise AssertionError(f"{name} N={x.shape[0]}{where}: sign disagreement "
                                 "where |sdf|>5e-2")
    return err


@torch.no_grad()
def hold_clusters(fm, name, x, packed, where="") -> dict:
    """Kernel ``name`` at every cluster size it compiles, forced, on one
    input: each within the variant's tolerance of the plain twin (bf16:
    with the signs agreeing where |sdf| > 5e-2) and equal to the launch at
    its smallest C bit for bit (every C keeps each column's k order and
    fold grouping).  Returns the error by C."""
    tol = KERNEL_TOL[name]
    want = fm.fused_sdf_raw_plain(x, packed)
    big = want.abs() > 5e-2
    sizes = fm.cluster_sizes(name)
    got = {c: fm._launch(x, packed, cluster=c) for c in sizes}
    torch.cuda.synchronize()
    errs = {}
    for c, out in got.items():
        errs[c] = float((out - want).abs().max())
        same = torch.equal(out.view(torch.int32), got[sizes[0]].view(torch.int32))
        signs = bool((torch.sign(out[big]) == torch.sign(want[big])).all())
        where_c = f"{name} C={c} N={x.shape[0]}{where}"
        print(f"[cluster] {where_c}: max_abs_err={errs[c]:.3e} (tol {tol:g}), "
              f"{'bit-identical to' if same else 'DIFFERS from'} C={sizes[0]}")
        if not errs[c] <= tol:
            raise AssertionError(f"{where_c}: max abs err {errs[c]}")
        if not signs:
            raise AssertionError(f"{where_c}: sign disagreement where |sdf|>5e-2")
        if not same:
            raise AssertionError(f"{where_c}: differs from C={sizes[0]}")
    return errs


@torch.no_grad()
def phase_kernels(dev, fm, model):
    """Each variant against its plain twin at the tracer's batch sizes and
    at every cluster size it compiles against the plain twin and its
    smallest C (``CLUSTER_CHECK_N``); each timed at its small calls and its largest,
    with the cluster size the rule chose, its slots, and each cluster size
    forced: the rule's C may be at most ``RULE_SLACK`` slower than the
    fastest forced C."""
    net = model.implicit_network
    d_in, hidden = net.dims[0], net.dims[1]
    k0 = fm.kernel_depth(d_in)
    gen = torch.Generator(device=dev).manual_seed(1)
    records = {}
    for name, dtype, _, peak_key, products in VARIANTS:
        packed = fm.pack_params(net.lin, d_in, hidden, dtype=dtype)
        max_err = 0.0
        for n in CHECK_N:
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            x = net._embed(pts).contiguous()
            max_err = max(max_err, hold_against_plain(fm, name, x, packed))
        cluster_err = {c: 0.0 for c in fm.cluster_sizes(name)}
        for n in CLUSTER_CHECK_N:
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            errs = hold_clusters(fm, name, net._embed(pts).contiguous(), packed)
            cluster_err = {c: max(cluster_err[c], e) for c, e in errs.items()}
        max_err = max([max_err] + list(cluster_err.values()))
        slots = fm.cluster_slots(name, k0, dev)
        layers = fm.plain_pack(packed, d_in)
        timed = []
        for n in dict.fromkeys(TIME_SMALL_N + TIME_N[name]):
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            x = net._embed(pts).contiguous()
            ms = cuda_ms(lambda: fm.fused_sdf_raw(x, packed))
            plain_ms = cuda_ms(lambda: fm.fused_sdf_raw_plain(x, layers))
            library_ms = cuda_ms(lambda: library_chain(x, layers))
            flops, nbytes = sdf_mlp_cost(n, d_in, hidden, packed["w_out"].element_size())
            t_ops = products * flops / PEAK_FLOPS[peak_key] * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            rec = {"n": n, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "achieved_tflops": flops / (ms * 1e-3) / 1e12}
            if dtype == torch.float32:
                rec["bound_fp32_cores_ms"] = max(flops / PEAK_FLOPS["f32"] * 1e3, t_bytes)
            rec["slots"] = slots
            rec["cluster"] = fm.cluster_size(n, slots, fm.WAVE_MS[name], fm.TILES[name])
            rec["tile"] = fm.TILES[name][rec["cluster"]]
            rec["ms_by_cluster"] = {c: cuda_ms(lambda: fm._launch(x, packed, cluster=c))
                                    for c in fm.cluster_sizes(name)}
            fastest = min(rec["ms_by_cluster"].values())
            rec["rule_over_fastest"] = rec["ms_by_cluster"][rec["cluster"]] / fastest
            print(f"[kernel] {name} N={n}: " + json.dumps(rec))
            if rec["rule_over_fastest"] > RULE_SLACK:
                raise AssertionError(f"{name} N={n}: the rule's C={rec['cluster']} takes "
                                     f"{rec['rule_over_fastest']:.3f}x the fastest forced C "
                                     f"({rec['ms_by_cluster']})")
            timed.append(rec)
        records[name] = dict(timed[-1], max_abs_err=max_err, other_calls=timed[:-1])
        records[name]["cluster_check"] = {"n": list(CLUSTER_CHECK_N), "tol": KERNEL_TOL[name],
                                          "max_abs_err_by_cluster": cluster_err,
                                          "bit_identical_to_smallest_c": True}
    fm.reset_launch_counts()
    return records


# the NFFB encode kernel (ops/nffb_encode.py): the main path's call sizes
# (secant 2048, march and line search 4096, sweep probes 24576 / 49152,
# mixed coarse probes 69632), its tolerances (float32 1e-5 in every column;
# bf16 99.9% of the elements within one bf16 ulp of the plain path, whose
# sums run in another order) and the sizes it is timed at
ENCODE_CHECK_N = (1, 31, 32, 33, 2048, 4096, 24576, 49152, 69632)
ENCODE_TIME_N = (4096, 24576, 69632)
ENCODE_TOL_F32 = 1e-5
ENCODE_BF16_WITHIN_ULP = 0.999


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` call, ``reps`` calls captured in a CUDA
    graph and replayed (as the train step runs them: no host work between
    launches), the least of 5 replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return min(times)


def encode_cost(enc, n: int):
    """FLOPs (2 a multiply-add, the used levels only), sines and bytes (each
    point read once, its output written once, the weights once) of the
    torch-grid encode kernel's n points."""
    w, L = enc.out_width, enc.n_levels
    used = L - 2
    macs = (used * w * w if enc.style_modulation else 0) + 3 * w + (L - 2) * w * w + w * w
    sines = 2 * L + used * (2 * L) * 4 + (L - 1) * w
    weights = sum(p.numel() for p in enc.parameters()) * 4
    return 2 * n * macs, n * sines, n * (3 + 3 + w) * 4 + weights


def encode_bound_ms(enc, n: int) -> dict:
    """The encode kernel's least time for one launch of n points and what
    sets it: on the torch grid ``encode_cost`` at the FP32 FMA peak or the
    bytes; on the ngp grid the benchmark's yardstick
    (``benchmark/harness/nffb_ngp_encode.py``: the used levels' trilinear
    weights, the style transform, trunk and out layer at the FP32 FMA peak,
    or the points' bytes with the weights and the used levels' rows)."""
    if enc.grid_backend == "torch":
        flops, sines, nbytes = encode_cost(enc, n)
        t_ops, t_bytes = flops / PEAK_FLOPS["f32"] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes", "sines": sines}
    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmark"))
    from harness import nffb_ngp_encode

    spec = enc.grid.spec
    return {"bound_ms": 1e3 * nffb_ngp_encode.bound_s(
        n, 1, enc.n_levels, enc.F, spec.log2_hashmap_size, spec.base_resolution,
        spec.desired_resolution, enc.style_modulation)}


def ffbtcnn_conf():
    """The FFB_TCNN configuration's conf as the benchmark freezes it (FFBTcnn
    points and view encoders on the instant-ngp grid, 2^15 rows a level)."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file

    return parse_file(str(Path(__file__).resolve().parent / "benchmark" / "configs"
                          / "idr-ffbtcnn-log2-15.conf"))


@torch.no_grad()
def phase_nffb_encode(dev, fm, models: dict) -> dict:
    """The NFFB encode kernel against the module's plain forward on each
    model's points encoder and view-direction encoder (the flagship's
    StyleModNFFB on the torch grid, FFB_TCNN's FFBTcnn on the ngp grid), in
    both precisions, at ``ENCODE_CHECK_N`` (inputs in [-0.6, 0.6]^3, which
    the points' bound 0.45 maps outside [0, 1]); timed through a CUDA graph
    at ``ENCODE_TIME_N`` beside the plain forward so replayed and the bound
    (``encode_bound_ms``)."""
    from hashmodnffbanks_idr_tpu_torch.ops import nffb_encode

    gen = torch.Generator(device=dev).manual_seed(2)
    records = {}
    for label, model in models.items():
        for role, enc in (("points", model.implicit_network.embedder),
                          ("views", model.rendering_network.view_embedder)):
            if not getattr(enc, "fused_encode", False):
                raise AssertionError(f"the {label} {role} encoder does not take the kernel")
            for fast in (False, True):
                variant = nffb_encode.VARIANTS[enc.grid_backend][fast]
                max_err, within = 0.0, 1.0
                for n in ENCODE_CHECK_N:
                    x = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
                    fm.reset_launch_counts()
                    got = enc(x, fast=fast)
                    enc.fused_encode = False
                    want = enc(x, fast=fast)
                    enc.fused_encode = True
                    torch.cuda.synchronize()
                    if fm.launch_counts[variant] != {"launches": 1, "points": n}:
                        raise AssertionError(f"{variant} {role} N={n}: "
                                             f"{fm.launch_counts[variant]}")
                    err = (got - want).abs()
                    max_err = max(max_err, float(err.max()))
                    if fast:
                        ref = want.to(torch.bfloat16).float()
                        ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(
                            ref.abs().clamp_min(torch.finfo(torch.float32).tiny))[1] - 8)
                        within = min(within, float((err <= ulp).float().mean()))
                print(f"[encode] {variant} {label} {role}: max_abs_err={max_err:.3e}"
                      + (f", within one bf16 ulp {within:.6f}" if fast else ""))
                if (not fast and not max_err <= ENCODE_TOL_F32) or within < ENCODE_BF16_WITHIN_ULP:
                    raise AssertionError(f"{variant} {role}: max abs err {max_err}, "
                                         f"within one ulp {within}")
                timed = []
                for n in ENCODE_TIME_N:
                    x = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
                    ms = graph_ms(lambda: enc(x, fast=fast))
                    enc.fused_encode = False
                    plain_ms = graph_ms(lambda: enc(x, fast=fast), reps=5)
                    enc.fused_encode = True
                    timed.append({"n": n, "ms": ms, "plain_ms": plain_ms,
                                  **encode_bound_ms(enc, n)})
                records[f"{variant}.{role}"] = {"max_abs_err": max_err, "timed": timed,
                                                **({"within_one_ulp": within} if fast else {})}
                print(f"[encode] {variant} {label} {role}: " + json.dumps(timed))
    fm.reset_launch_counts()
    return records


def counting_loop(dev, limit: int, max_iters: int):
    """A loop state and a function that runs ``x = 0; while x < limit (at
    most max_iters times): x += 1`` on ``while_loop``."""
    st = {"x": torch.zeros((), dtype=torch.int64, device=dev),
          "limit": torch.tensor(limit, device=dev)}

    def body(s, _):
        s["x"].add_(1)

    def run():
        st["x"].zero_()
        graphs.while_loop(lambda s: s["x"] < s["limit"], body, st, max_iters)

    return st, run


def captured(dev, run) -> "graphs.Program":
    """``run`` captured and assembled into one executable graph."""
    with graphs.capture_program(stream=graphs.side_stream(dev)) as program:
        run()
    program.instantiate()
    return program


@torch.no_grad()
def phase_set_while(dev) -> dict:
    """``set_while`` (a while-node's condition set on the device) against
    its plain twin (``while_loop`` eagerly, the predicate read on the host)
    on the same loops, ``SET_WHILE_CASES``: x and the iterations (the
    device total folded in) equal.  Then the time of one iteration of
    a loop of SET_WHILE_TIMED, launched as one graph and run eagerly: x +=
    1, the counter's add and the predicate, and in the graph the
    predicate's copy, set_while and the node's re-evaluation; in the eager
    loop a host read an iteration."""
    max_err = 0
    for limit, max_iters in SET_WHILE_CASES:
        out = {}
        for graphed in (False, True):
            st, run = counting_loop(dev, limit, max_iters)
            graphs.loop_iterations.clear()
            if graphed:
                program = captured(dev, run)
                program.replay()
                graphs.fold_device_counts()
            else:
                run()
            out[graphed] = (int(st["x"]), graphs.loop_iterations.get("body", 0))
        err = max(abs(a - b) for a, b in zip(out[True], out[False]))
        print(f"[set_while] limit={limit} max_iters={max_iters}: x and iterations graphed "
              f"{out[True]} eager {out[False]}")
        if err or out[False][1] != min(limit, max_iters):
            raise AssertionError(f"set_while: limit {limit} max_iters {max_iters}: graphed "
                                 f"{out[True]}, eager {out[False]}")
        max_err = max(max_err, err)
    n = SET_WHILE_TIMED
    st, run = counting_loop(dev, n, n)
    program = captured(dev, run)
    ms = cuda_ms(program.replay, iters=5, warmup=1) / n
    plain_ms = cuda_ms(run, iters=2, warmup=1) / n
    if int(st["x"]) != n:
        raise AssertionError(f"set_while: the timed loop counted to {int(st['x'])}, not {n}")
    rec = {"ms": ms, "plain_ms": plain_ms, "iterations_timed": n, "max_abs_err": max_err,
           "bound_ms": SET_WHILE_BYTES / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None, "cases": [list(c) for c in SET_WHILE_CASES]}
    print(f"[set_while] {json.dumps(rec)}")
    return rec


def phase_reference(dev, fm, conf=None, label="exact+fused", expect="fused_sdf_raw_f32"):
    """One small step on the card against the same step on the CPU (plain
    twin), same weights and draws: loss within 1% and hit masks on 98% of
    the rays agree, and the card launched ``expect`` (None: no kernel).  By
    default the flagship in exact+fused; ``conf`` (a 256-ray conf) replaces
    it.  Returns the record."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, scene_to_device,
                                                       synthetic_scene)
    from hashmodnffbanks_idr_tpu_torch.train.trainer import loss_fn

    n_rays = 256
    if conf is None:
        conf = flagship_conf(num_pixels=n_rays)
        conf.put("model.tracer_exact_fused", True)
    scene_np = synthetic_scene(n_views=2, img_res=(64, 64), seed=0)
    g = torch.Generator().manual_seed(5)
    pix = torch.randperm(64 * 64, generator=g)[:n_rays]
    outs = {}
    for device in (dev, torch.device("cpu")):
        model = IDRNetwork(conf.get_config("model"), device=device, seed=0)
        cfg = model.ray_tracer
        with torch.no_grad():
            guidance = model._tracer_sdfs()[1]
        stride = sweep_stride(cfg, bool(guidance and guidance.get("coarse")),
                              on_cuda=device.type == "cuda")
        g = torch.Generator().manual_seed(6)
        draws = {"coarse": torch.rand((cfg.n_steps - 1) // stride + 1, generator=g),
                 "fine": torch.rand(3 * (stride - 1), generator=g),
                 "eik": torch.rand(n_rays // 2, 3, generator=g) * 2 - 1}
        captured = {}
        model.register_forward_hook(lambda m, a, o: captured.update(o))
        losses = loss_fn(model, IDRLossConfig(0.1, 200.0, ALPHA), scene_to_device(scene_np, device),
                         torch.tensor([0], device=device), pix.to(device), None, ALPHA,
                         draws=draws)
        outs[device.type] = (float(losses["loss"].detach()),
                             captured["network_object_mask"].cpu())
    (l_gpu, m_gpu), (l_cpu, m_cpu) = outs["cuda"], outs["cpu"]
    agree = float((m_gpu == m_cpu).float().mean())
    launches = {k: c["launches"] for k, c in fm.snapshot_launch_counts().items()}
    rec = {"label": label, "rays": n_rays, "loss_cuda": l_gpu, "loss_cpu": l_cpu,
           "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu), "hits_cuda": int(m_gpu.sum()),
           "hits_cpu": int(m_cpu.sum()), "mask_agreement": agree, "launches": launches}
    print(f"[reference] {json.dumps(rec)}")
    if not (math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)):
        raise AssertionError(f"loss on the card {l_gpu} vs CPU {l_cpu}")
    if agree < 0.98:
        raise AssertionError(f"hit masks agree on {agree:.3f} of rays")
    if expect is not None and launches[expect] == 0:
        raise AssertionError(f"{label}: the step on the card launched no {expect}")
    fm.reset_launch_counts()
    return rec


@torch.no_grad()
def time_tracer(model, scene, img_idx, pixel_idx, gen, reps: int = 3) -> float:
    """Host time of the gradient-free tracer alone on one step's rays (the
    step's first stage, run the way ``IDRNetwork.forward`` runs it)."""
    from hashmodnffbanks_idr_tpu_torch.geometry.cameras import get_camera_params
    from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import ray_trace

    uv = scene["uv"][pixel_idx][None]
    mask = scene["mask"][img_idx][:, pixel_idx].reshape(-1)
    dirs, cam = get_camera_params(uv, scene["pose"][img_idx], scene["intrinsics"][img_idx])
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sdf, guidance = model._tracer_sdfs()
        ray_trace(model.ray_tracer, sdf, cam, mask, dirs, generator=gen, sdf_guidance=guidance)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_step(dev, fm, scene, label, mode, fused, warmup, steps, expect=None, conf=None,
               tag="step"):
    """A training step through the port's entry points, the flagship's by
    default (``conf`` replaces it); counts reset just before the timed steps
    and read just after."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf
    from hashmodnffbanks_idr_tpu_torch.train.trainer import (GraphedTrainStep, build_train_step,
                                                             make_optimizer)
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    conf = flagship_conf(num_pixels=N_RAYS) if conf is None else conf
    conf.put("model.tracer_fast", mode)
    conf.put("model.tracer_exact_fused", fused)
    model = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), make_optimizer(model))
    if not isinstance(step, GraphedTrainStep):
        raise AssertionError(f"{label}: the step on the card is not the graphed step")
    gen = torch.Generator(device=dev).manual_seed(1)
    img_idx = torch.tensor([0], device=dev)
    total = IMG_RES[0] * IMG_RES[1]
    before = [p.detach().clone() for p in model.parameters()]

    for _ in range(warmup):
        step(scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, ALPHA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    gl.launch_counts["set_while"] = 0
    graphs.loop_iterations.clear()
    launched = step.program.launches
    times, per_step, losses = [], [], None
    for _ in range(steps):
        seen = fm.snapshot_launch_counts()
        t0 = time.perf_counter()
        losses = step(scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, ALPHA)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: c["launches"] for k, c in fm.launch_counts_since(seen).items()})
    counts = fm.snapshot_launch_counts()
    set_while = gl.launch_counts["set_while"]
    iterations = dict(graphs.loop_iterations)
    graph_launches = step.program.launches - launched
    tracer_ms = time_tracer(model, scene, img_idx, sample_pixels(gen, total, N_RAYS), gen)

    loss = float(losses["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{label}: loss {loss}")
    if not any(bool((p.detach() != b).any()) for p, b in zip(model.parameters(), before)):
        raise AssertionError(f"{label}: no parameter changed")
    if expect is not None and not all(s[expect] > 0 for s in per_step):
        raise AssertionError(f"{label}: {expect} was not launched in every step: {per_step}")
    if step.captures != 1 or step.skipped:
        raise AssertionError(f"{label}: {step.captures} captures, {step.skipped} skipped steps")
    if graph_launches != steps or not set_while:
        raise AssertionError(f"{label}: {graph_launches} graph launches in {steps} steps, "
                             f"set_while ran {set_while} times")
    ms = statistics.median(times)
    rec = {"label": label, "graphed": True, "capture_s": step.capture_s,
           "graphs": step.program.graphs(), "steps": steps, "ms_per_step_median": ms,
           "ms_per_step_min": min(times), "ms_per_step_max": max(times),
           "rays_per_s": N_RAYS / (ms * 1e-3), "tracer_ms_median": tracer_ms, "loss": loss,
           "launches_per_step": {k: v["launches"] / steps for k, v in counts.items()},
           "points_per_step": {k: v["points"] / steps for k, v in counts.items()},
           "f32_launches_per_step_by_config": by_config(counts, "fused_sdf_raw_f32", steps),
           "bf16_launches_per_step_by_config": by_config(counts, "fused_sdf_raw_bf16", steps),
           "max_memory_allocated_mib": torch.cuda.max_memory_allocated() / 2**20,
           "graph_launches_per_step": graph_launches / steps,
           "loop_iterations_per_step": {k: v / steps for k, v in iterations.items()},
           "set_while_per_step": set_while / steps}
    print(f"[{tag}] {json.dumps(rec)}")
    fm.reset_launch_counts()
    counts["set_while"] = {"launches": set_while}
    return counts


def graph_pair_run(dev, fm, scene, conf, steps: int, count_syncs: bool = False) -> dict:
    """The step graphed and eager from the same weights (seed 0) and
    generators (seed 1), ``steps`` steps each, in turns (graphed first on
    odd steps): per step and variant the loss terms, hit masks, wall ms,
    the fused kernels' launches, each loop's iterations (``graphs.
    loop_iterations``: the eager loop's host count, the graph's device
    totals) and the graph's launches; then each variant's parameters and
    the graphed step's captures.  With ``count_syncs`` every step after the
    first counts the host's synchronisations: the eager step under the
    sync-debug mode "warn", the graphed step under "error" (a launch that
    synchronises raises)."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    runs = {}
    for graphed in (True, False):
        model = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
        captured = {}
        model.register_forward_hook(lambda m, a, o, c=captured: c.update(o))
        runs[graphed] = {"model": model, "captured": captured, "steps": [],
                         "gen": torch.Generator(device=dev).manual_seed(1),
                         "step": build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA),
                                                  make_optimizer(model), graphed=graphed)}
    total = IMG_RES[0] * IMG_RES[1]
    for i in range(steps):
        for graphed in ((True, False) if i % 2 == 0 else (False, True)):
            r = runs[graphed]
            seen = fm.snapshot_launch_counts()
            iters_seen = dict(graphs.loop_iterations)
            program = getattr(r["step"], "program", None)
            launched = program.launches if program is not None else 0
            pix = sample_pixels(r["gen"], total, N_RAYS)
            img = torch.tensor([i % 2], device=dev)
            mode = "error" if graphed else "warn"
            torch.cuda.synchronize()
            with (host_syncs(mode) if count_syncs and i > 0 else contextlib.nullcontext([None])
                  ) as syncs:
                t0 = time.perf_counter()
                losses = r["step"](scene, img, pix, r["gen"], ALPHA)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            program = getattr(r["step"], "program", None)
            r["steps"].append({"ms": ms,
                               "losses": {k: v.clone() for k, v in losses.items()},
                               "mask": r["captured"]["network_object_mask"].clone(),
                               "launches": fm.launch_counts_since(seen),
                               "iterations": {k: v - iters_seen.get(k, 0)
                                              for k, v in graphs.loop_iterations.items()
                                              if v != iters_seen.get(k, 0)},
                               "graph_launches": (program.launches - launched
                                                  if program is not None else 0),
                               "host_syncs": syncs[0]})
    for r in runs.values():
        r["params"] = [p.detach().clone() for p in r["model"].parameters()]
        del r["model"], r["captured"]
    return runs


def phase_graph(dev, fm, scene, smi: str) -> dict:
    """The step launched as one CUDA graph against the eager step, in the
    five cells of ``GRAPH_CELLS``, in turns (``graph_pair_run``):

    * as the step runs by default, GRAPH_TIMED steps of each: step 1's loss
      terms and hit masks bit-identical; the ms of steps 2 on (median, min,
      max) and the capture's seconds;
    * with deterministic algorithms (``utils.debug.deterministic``: the
      only difference between two eager runs is the hash grid's backward
      atomics), GRAPH_HELD steps of each: every step's loss terms and hit
      masks and the parameters after them bit-identical (so within the
      sharded step's bounds, loss 1e-6, parameters 5e-4 / 2e-6, and more),
      and every step's fused-kernel launches (by variant, points and
      cluster size) counted under replay as the eager step counts them,
      the cell's kernel launched in every step, each loop's iterations
      (the device totals) equal to the eager loop's, one graph launch a
      step, and no host synchronisation inside the graphed step's calls
      after the first (sync-debug mode "error"; the eager step's are
      counted under "warn");
    * one step whose alpha is NaN (a static input of the graphs): the
      update skipped on the device (``skipped``), the parameters unchanged.

    Counts reset just before each cell's runs and read just after."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, ngp_conf
    from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
    from hashmodnffbanks_idr_tpu_torch.utils.debug import deterministic
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    records = {}
    for label, preset, mode, fused, kernel in GRAPH_CELLS:
        conf = flagship_conf(num_pixels=N_RAYS) if preset is None else ngp_conf(preset, N_RAYS)
        conf.put("model.tracer_fast", mode)
        conf.put("model.tracer_exact_fused", fused)
        fm.reset_launch_counts()
        timed = graph_pair_run(dev, fm, scene, conf, GRAPH_TIMED)
        g0, e0 = timed[True]["steps"][0], timed[False]["steps"][0]
        for k in e0["losses"]:
            if not torch.equal(g0["losses"][k], e0["losses"][k]):
                raise AssertionError(f"[graph] {label}: step 1's {k} graphed "
                                     f"{float(g0['losses'][k])} eager {float(e0['losses'][k])}")
        if not torch.equal(g0["mask"], e0["mask"]):
            raise AssertionError(f"[graph] {label}: step 1's hit masks differ")
        with deterministic():
            held = graph_pair_run(dev, fm, scene, conf, GRAPH_HELD, count_syncs=True)
        for i, (g, e) in enumerate(zip(held[True]["steps"], held[False]["steps"])):
            for k in e["losses"]:
                if not torch.equal(g["losses"][k], e["losses"][k]):
                    raise AssertionError(f"[graph] {label} (deterministic): step {i + 1}'s {k}")
            if not torch.equal(g["mask"], e["mask"]):
                raise AssertionError(f"[graph] {label} (deterministic): step {i + 1}'s masks")
            if i > 0 and g["launches"] != e["launches"]:
                raise AssertionError(f"[graph] {label}: step {i + 1} counted {g['launches']} "
                                     f"graphed, {e['launches']} eager")
            if kernel is not None and not g["launches"][kernel]["launches"]:
                raise AssertionError(f"[graph] {label}: step {i + 1} launched no {kernel}")
            if i > 0 and (g["iterations"] != e["iterations"]
                          or not g["iterations"].get("march_body")):
                raise AssertionError(f"[graph] {label}: step {i + 1}'s loops ran "
                                     f"{g['iterations']} graphed, {e['iterations']} eager")
            if g["graph_launches"] != 1 or (i > 0 and g["host_syncs"] != 0):
                raise AssertionError(f"[graph] {label}: step {i + 1}: {g['graph_launches']} "
                                     f"graph launches, {g['host_syncs']} host syncs")
        param_max = max(float((a - b).abs().max())
                        for a, b in zip(held[True]["params"], held[False]["params"]))
        if param_max != 0.0:
            raise AssertionError(f"[graph] {label} (deterministic): parameters {param_max} apart")

        # a non-finite step, skipped on the device
        model = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
        opt = make_optimizer(model)
        step = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), opt)
        gen = torch.Generator(device=dev).manual_seed(1)
        img = torch.tensor([0], device=dev)
        step(scene, img, sample_pixels(gen, IMG_RES[0] * IMG_RES[1], N_RAYS), gen, ALPHA)
        before = [p.detach().clone() for p in model.parameters()]
        bad = step(scene, img, sample_pixels(gen, IMG_RES[0] * IMG_RES[1], N_RAYS), gen,
                   float("nan"))
        unchanged = all(torch.equal(a, p.detach()) for a, p in zip(before, model.parameters()))
        if step.skipped != 1 or not unchanged or step.captures != 1:
            raise AssertionError(f"[graph] {label}: a NaN step: skipped {step.skipped}, "
                                 f"parameters unchanged {unchanged}, {step.captures} captures")
        del model, opt, step

        counts = fm.snapshot_launch_counts()
        ms = {v: [s["ms"] for s in timed[v]["steps"][1:]] for v in (True, False)}
        rec = {"label": label, "card": smi, "steps_timed": GRAPH_TIMED - 1,
               "steps_held": GRAPH_HELD,
               "graphed_ms_median": statistics.median(ms[True]),
               "graphed_ms_min": min(ms[True]), "graphed_ms_max": max(ms[True]),
               "eager_ms_median": statistics.median(ms[False]),
               "eager_ms_min": min(ms[False]), "eager_ms_max": max(ms[False]),
               "capture_s": timed[True]["step"].capture_s,
               "graphs": timed[True]["step"].program.graphs(),
               "first_call_ms": {"graphed": timed[True]["steps"][0]["ms"],
                                 "eager": timed[False]["steps"][0]["ms"]},
               "step1_bit_identical": True, "held_bit_identical_steps": GRAPH_HELD,
               "nan_step_skipped": True, "nan_step_loss": float(bad["loss"]),
               "kernel_launches_per_step": {
                   k: [s["launches"][k]["launches"] for s in held[True]["steps"]]
                   for k in counts},
               "graph_launches_per_step": [s["graph_launches"] for s in held[True]["steps"]],
               "loop_iterations_per_step": [s["iterations"] for s in held[True]["steps"]],
               "host_syncs_per_step": {
                   "graphed": [s["host_syncs"] for s in held[True]["steps"][1:]],
                   "eager": [s["host_syncs"] for s in held[False]["steps"][1:]]}}
        print(f"[graph] {json.dumps(rec)}")
        records[label] = counts
        del timed, held
    fm.reset_launch_counts()
    return records


def require_graphed(*runners) -> None:
    """Each runner trained through the step replayed from CUDA graphs,
    captured once."""
    from hashmodnffbanks_idr_tpu_torch.train.trainer import GraphedTrainStep

    for r in runners:
        step = r.train_step
        if not isinstance(step, GraphedTrainStep) or step.captures != 1:
            raise AssertionError(f"{r.expname}: the runner's step is {type(step).__name__} "
                                 f"({getattr(step, 'captures', 0)} captures), not graphed once")


def read_scalars(rundir: str) -> list:
    with open(os.path.join(rundir, "logs", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_runner(fm, smi: str, workdir: str) -> dict:
    """The user's path: the dummy scene written by the port's ``dummy_cli``,
    then ``exp_runner`` on the dummy StyleModNFFB conf (8x512 SDF MLP, 4x512
    rendering MLP, SH view encoder, 2048 rays, 10 steps an epoch) with the
    ``mixed`` tracer for 30 epochs, then ``--is_continue`` to epoch 32.
    Counts reset just before the first run and read just after the second."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
    from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset
    from hashmodnffbanks_idr_tpu_torch.train import exp_runner

    data_root = os.path.join(workdir, "data")
    dummy_cli.main(["--out", os.path.join(data_root, "dummy", "scan0")])
    conf = parse_file(str(DUMMY_CONF))
    conf.put("model.tracer_fast", "mixed")
    conf_path = os.path.join(workdir, "dummy_stylemodnffb_mixed.conf")
    with open(conf_path, "w") as f:
        f.write(conf.dump())
    t0 = time.perf_counter()
    SceneDataset(False, "dummy", conf.get_list("dataset.img_res"), 0, data_root=data_root)
    decode_ms = (time.perf_counter() - t0) * 1e3

    common = ["--conf", conf_path, "--exps_folder_name", os.path.join(workdir, "exps"),
              "--data_root", data_root, "--no_tensorboard"]
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    first = exp_runner.main(common + ["--nepoch", str(RUNNER_EPOCHS)])
    t_first = time.perf_counter() - t0
    second = exp_runner.main(common + ["--nepoch", str(RUNNER_EPOCHS + 2), "--is_continue"])
    counts = fm.snapshot_launch_counts()
    require_graphed(first, second)

    missing = [f"{n}.pt" for n in (0, 25, RUNNER_EPOCHS, "latest")
               if not os.path.exists(os.path.join(first.checkpoints_path, f"{n}.pt"))]
    if missing:
        raise AssertionError(f"runner: checkpoints {missing} missing")
    if second.start_epoch != RUNNER_EPOCHS:
        raise AssertionError(f"runner: resumed at epoch {second.start_epoch}, "
                             f"not {RUNNER_EPOCHS}")
    rows = read_scalars(first.rundir) + read_scalars(second.rundir)
    epochs = [r["step"] for r in rows]
    if epochs != list(range(RUNNER_EPOCHS + 1)) + [RUNNER_EPOCHS, RUNNER_EPOCHS + 1,
                                                     RUNNER_EPOCHS + 2]:
        raise AssertionError(f"runner: logged epochs {epochs}")
    keys = ("loss", "rgb_loss", "eikonal_loss", "mask_loss")
    if not all(math.isfinite(r[k]) for r in rows for k in keys):
        raise AssertionError("runner: a logged loss is not finite")
    bf16 = [r["fused_sdf_raw_bf16_launches"] for r in rows]
    if min(bf16) <= 0 or sum(bf16) != counts["fused_sdf_raw_bf16"]["launches"]:
        raise AssertionError(f"runner: bf16 kernel launches per epoch {bf16}, "
                             f"counted {counts['fused_sdf_raw_bf16']['launches']}")
    loss0, loss30, loss_end = rows[0]["loss"], rows[RUNNER_EPOCHS]["loss"], rows[-1]["loss"]
    if not loss_end <= 0.5 * loss0:
        raise AssertionError(f"runner: loss {loss0} at epoch 0, {loss_end} at the end")
    rays = statistics.median(r["rays_per_s"] for r in rows[2:RUNNER_EPOCHS + 1])
    steps = len(rows) * first.steps_per_epoch
    rec = {"card": smi, "epochs": RUNNER_EPOCHS, "steps_per_epoch": first.steps_per_epoch,
           "loss_epoch0": loss0, f"loss_epoch{RUNNER_EPOCHS}": loss30,
           f"loss_epoch{RUNNER_EPOCHS + 2}": loss_end,
           "skill_target_loss_below_0.1_by_epoch_30": loss30 < 0.1,
           "rays_per_s_median_epochs_2_on": rays, "first_run_s": t_first,
           "dummy_scene_decode_ms": decode_ms,
           "bf16_launches_per_epoch": bf16, "bf16_launches": sum(bf16),
           "bf16_points": counts["fused_sdf_raw_bf16"]["points"],
           "bf16_launches_per_step_by_config": by_config(counts, "fused_sdf_raw_bf16", steps),
           "skipped_steps": sum(r["skipped_steps"] for r in rows)}
    print(f"[runner] {json.dumps(rec)}")
    return counts


def decode_view(i: int, res=DTU_RES):
    """View ``i`` of the ``[decode]`` scan: a shaded image and a disc mask,
    each shifted by a per-view offset (and its own noise), so that no two
    views are equal and a decode that put them out of order fails."""
    H, W = res
    rng = np.random.default_rng(i)
    yy, xx = np.mgrid[0:H, 0:W]
    shade = 128 + 60 * np.sin((xx + 13 * i) / 97.0)[..., None] * np.cos(yy / 61.0)[..., None]
    img = np.clip(shade + 2 * i + rng.normal(0, 12, (H, W, 3)), 0, 255).astype(np.uint8)
    mask = (((xx - W / 2 - 5 * i) ** 2 + (yy - H / 2) ** 2) < (H / 3) ** 2).astype(np.uint8) * 255
    return img, mask


def write_decode_view(scan: str, i: int, res=DTU_RES) -> None:
    """Write view ``i`` (image and mask), every row Paeth-filtered."""
    from hashmodnffbanks_idr_tpu_torch.data.image_io import write_png

    img, mask = decode_view(i, res)
    write_png(os.path.join(scan, "image", f"{i:03d}.png"), img, filters=4)
    write_png(os.path.join(scan, "mask", f"{i:03d}.png"), mask, filters=4)


def phase_decode(smi: str, workdir: str, views: int = 49, res=DTU_RES) -> dict:
    """A DTU-size scan (49 distinct views at 1200x1600, image and mask, every
    row Paeth-filtered: the slow case of the reader) through ``SceneDataset``,
    which decodes it in worker processes (``data/native_loader.py``), then
    serially: the two equal view by view, and views 0, 24 and 48 equal to
    what was written.  (``scripts/time_scene_decode.py`` times threads too.)"""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from hashmodnffbanks_idr_tpu_torch.data import native_loader
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset, glob_imgs

    H, W = res
    scan = os.path.join(workdir, "dtu", "scan0")
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(scan, sub))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(native_loader.default_workers(views),
                             mp_context=get_context("spawn")) as ex:
        list(ex.map(write_decode_view, [scan] * views, range(views), [res] * views))
    write_s = time.perf_counter() - t0
    wm = np.eye(4)  # K [I | t]: a camera 2.5 in front of the origin
    wm[:3, :3] = [[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]]
    wm[:3, 3] = wm[:3, :3] @ [0.0, 0.0, 2.5]
    np.savez(os.path.join(scan, "cameras.npz"),
             **{f"{m}_{i}": a for i in range(views)
                for m, a in (("world_mat", wm), ("scale_mat", np.eye(4)))})
    paths = [glob_imgs(os.path.join(scan, sub)) for sub in ("image", "mask")]
    t0 = time.perf_counter()
    ds = SceneDataset(False, "dtu", res, 0, data_root=workdir)
    parallel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb, mask = native_loader.load_scene_native(*paths, res, workers="serial")
    serial_s = time.perf_counter() - t0
    for i in range(views):
        if not (np.array_equal(ds.rgb_images[i], rgb[i])
                and np.array_equal(ds.object_masks[i], mask[i])):
            raise AssertionError(f"decode: view {i} in processes differs from the serial decode")
    for i in (0, views // 2, views - 1):
        img, mask = decode_view(i, res)
        if not (np.array_equal(ds.rgb_images[i], img.reshape(-1, 3))
                and np.array_equal(ds.object_masks[i], mask.reshape(-1) > 127)):
            raise AssertionError(f"decode: view {i} differs from the file written")
    if len({ds.rgb_images[i].tobytes() for i in range(views)}) != views:
        raise AssertionError("decode: two views are equal")
    rec = {"card": smi, "views": views, "res": list(res), "filters": "paeth",
           "workers": native_loader.default_workers(views), "write_s": write_s,
           "scan_s_processes": parallel_s, "scan_s_serial": serial_s,
           "speedup_processes": serial_s / parallel_s,
           "per_view_ms_processes": parallel_s / views * 1e3}
    print(f"[decode] {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def keep_largest_call(fm, kept: dict):
    """While open, ``fm.fused_sdf_raw`` keeps in ``kept[variant]`` a copy of
    the largest input it was given, with its weights, then launches as
    always; the launch counts are the wrapper's own."""
    launch = fm.fused_sdf_raw
    variant = {dtype: name for name, dtype, *_ in VARIANTS}

    def keeping(x, packed):
        name = variant[packed["w_out"].dtype]
        if name not in kept or x.shape[0] > kept[name][0].shape[0]:
            kept[name] = (x.clone(), packed)
        return launch(x, packed)

    fm.fused_sdf_raw = keeping
    try:
        yield kept
    finally:
        fm.fused_sdf_raw = launch


def phase_eval(fm, smi: str, workdir: str):
    """The eval path, through the entry points a user calls: the anchor
    scene generated on the card, 20 epochs of the anchor conf with plots at
    epochs 10 and 20, ``run_eval`` (mesh at resolution 100, all 8 views
    scored) and ``dtu_chamfer``; then view 0 rendered unfused, exact+fused
    and mixed from the same checkpoint.  Counts reset just before the phase
    and read just after.  Then each kernel is held against its plain twin
    on the largest call the view's render gave it.  Returns the counts and
    that check."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
    from hashmodnffbanks_idr_tpu_torch.data import dtu_shaped
    from hashmodnffbanks_idr_tpu_torch.eval import dtu_chamfer, run_eval
    from hashmodnffbanks_idr_tpu_torch.eval.evaluator import Evaluator
    from hashmodnffbanks_idr_tpu_torch.models.metrics import masked_psnr
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt
    from hashmodnffbanks_idr_tpu_torch.train import exp_runner
    from hashmodnffbanks_idr_tpu_torch.utils.ply import read_ply

    fm.reset_launch_counts()
    data_root = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    gen_dir = dtu_shaped.main(["--out", os.path.join(workdir, "gen"), "--n_views", "8",
                               "--img_res", "240", "320", "--scan_id", "0",
                               "--mesh_resolution", "320"])
    generate_s = time.perf_counter() - t0
    scene = os.path.join(data_root, "dtu_shaped_small", "scan0")
    os.makedirs(os.path.dirname(scene))
    shutil.move(gen_dir, scene)

    conf = parse_file(str(ANCHOR_CONF))
    conf.put("train.plot_freq", EVAL_PLOT_FREQ)
    conf_path = os.path.join(workdir, "headtohead_ours_400_f32_plots.conf")
    with open(conf_path, "w") as f:
        f.write(conf.dump())
    exps, evals = os.path.join(workdir, "exps_eval"), os.path.join(workdir, "evals")
    t0 = time.perf_counter()
    runner = exp_runner.main(["--conf", conf_path, "--nepoch", str(EVAL_EPOCHS),
                               "--data_root", data_root, "--exps_folder_name", exps,
                               "--no_tensorboard"])
    train_s = time.perf_counter() - t0
    require_graphed(runner)
    plots = sorted(os.listdir(runner.plots_dir))
    want = [f"{k}_{e}.{x}" for e in range(EVAL_PLOT_FREQ, EVAL_EPOCHS + 1, EVAL_PLOT_FREQ)
            for k, x in (("rendering", "png"), ("depth", "png"), ("surface", "ply"),
                         ("surface", "html"), ("cameras", "ply"))]
    if sorted(want) != plots:
        raise AssertionError(f"eval: plots {plots}, expected {sorted(want)}")

    t0 = time.perf_counter()
    res = run_eval.main(["--conf", conf_path, "--data_root", data_root, "--resolution", "100",
                         "--eval_rendering", "--exps_folder", exps, "--evals_folder", evals])
    eval_s = time.perf_counter() - t0
    metrics_dir = os.path.join(res["eval_dir"], "metrics")
    for name in ("psnrs.csv", "ssims.csv", "lpips.csv", "summary.json"):
        if not os.path.exists(os.path.join(metrics_dir, name)):
            raise AssertionError(f"eval: {name} missing")
    with open(os.path.join(metrics_dir, "summary.json")) as f:
        summary = json.load(f)
    verts, faces = read_ply(res["mesh"])
    chamfer_log = os.path.join(res["eval_dir"], "chamfer_log.txt")
    t0 = time.perf_counter()
    dtu_chamfer.main(["--data", res["mesh"], "--gt", os.path.join(scene, "gt_mesh.ply"),
                      "--downsample_density", "0.005", "--log", chamfer_log])
    chamfer_s = time.perf_counter() - t0
    with open(chamfer_log) as f:
        chamfer = json.loads(f.read().splitlines()[-1])
    scores = [summary[k] for k in ("psnr_mean", "ssim_mean", "lpips_mean")] + [
        chamfer[k] for k in ("mean_d2s", "mean_s2d", "over_all")]
    if not (len(faces) > 0 and all(math.isfinite(v) for v in scores)):
        raise AssertionError(f"eval: {len(faces)} faces, scores {scores}")

    # one view, one checkpoint, three tracer settings
    renders, kept = {}, {}
    settings = (("exact (unfused)", "exact", False, None, None, None),) + EVAL_VARIANTS
    for label, mode, fused, kernel, _, _ in settings:
        vconf = parse_file(conf_path)
        vconf.put("model.tracer_fast", mode)
        vconf.put("model.tracer_exact_fused", fused)
        model = IDRNetwork(vconf.get_config("model"))
        ckpt.load_checkpoint(runner.checkpoints_path, "latest", model)
        ev = Evaluator(vconf, model, dataset=runner.train_dataset)
        seen = fm.snapshot_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with keep_largest_call(fm, kept):
            t0 = time.perf_counter()
            view = ev.render_view(0)
            render_s = time.perf_counter() - t0
        m3 = view["gt_mask"][..., None].astype(np.float32)
        renders[label] = {
            "view": view, "render_s": render_s,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "psnr": masked_psnr((view["rgb"] + 1) / 2 * m3, (view["gt_rgb"] + 1) / 2 * m3,
                                view["gt_mask"], data_range=1.0),
            "launches": {k: c["launches"] for k, c in fm.launch_counts_since(seen).items()},
            "points": {k: c["points"] for k, c in fm.launch_counts_since(seen).items()}}
        if kernel is not None and renders[label]["launches"][kernel] <= 0:
            raise AssertionError(f"eval render {label}: {kernel} was not launched")
    counts = fm.snapshot_launch_counts()
    # each kernel on the largest input the render gave it (launches made
    # here are comparisons and are not counted)
    largest = {name: {"n": x.shape[0], "max_abs_err": hold_against_plain(
                   fm, name, x, packed, " (the eval render's largest call)")}
               for name, (x, packed) in kept.items()}
    kept.clear()
    fm.reset_launch_counts()
    base = renders["exact (unfused)"]
    held = {}
    for label, _, _, kernel, agree_bound, dpsnr_bound in EVAL_VARIANTS:
        r = renders[label]
        agree = float((r["view"]["mask"] == base["view"]["mask"]).mean())
        dpsnr = r["psnr"] - base["psnr"]
        held[label] = {"kernel": kernel, "mask_agreement": agree,
                       "mask_agreement_bound": agree_bound, "dpsnr_db": dpsnr,
                       "dpsnr_bound_db": dpsnr_bound, "render_s": r["render_s"],
                       "launches": r["launches"][kernel], "points": r["points"][kernel],
                       "largest_call": largest[kernel]}
        if agree < agree_bound or not abs(dpsnr) <= dpsnr_bound:
            raise AssertionError(f"eval render {label}: mask agreement {agree:.6f} "
                                 f"(bound {agree_bound}), dPSNR {dpsnr:.3e} dB "
                                 f"(bound {dpsnr_bound})")
    rec = {"card": smi, "generate_s": generate_s, "train_s": train_s, "epochs": EVAL_EPOCHS,
           "run_eval_s": eval_s, "mesh_s": summary["mesh_s"], "render_8_views_s": summary["render_s"],
           "render_s_per_view": summary["render_s"] / 8, "chamfer_s": chamfer_s,
           "psnr": summary["psnr_mean"], "ssim": summary["ssim_mean"],
           "lpips": summary["lpips_mean"], "lpips_weights": summary["lpips_weights"],
           "chamfer_d2s": chamfer["mean_d2s"], "chamfer_s2d": chamfer["mean_s2d"],
           "chamfer_overall": chamfer["over_all"], "mesh_faces": len(faces),
           "view0_unfused": {"psnr": base["psnr"], "render_s": base["render_s"],
                             "peak_mib_tile_32768": base["peak_mib"]},
           "view0_held": held}
    print(f"[eval] {json.dumps(rec)}")
    return counts, largest


def camera_step(device, fm, conf, scene, pose0, img_idx, pixel_idx, draws):
    """One ``train_cameras`` step of ``conf`` on ``device`` from seed-0
    weights and the pose table ``pose0``: the loss terms, the hit mask, the
    pose gradient, and the poses and SparseAdam state after the step (all on
    the CPU), and the kernels' launches in the step."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.train.trainer import (build_train_step, make_optimizer,
                                                             sparse_adam_init)

    model = IDRNetwork(conf.get_config("model"), device=device, seed=0)
    pose_vecs = torch.tensor(pose0, device=device, requires_grad=True)
    cam_opt = sparse_adam_init(pose_vecs)
    loss = conf.get_config("loss")
    step = build_train_step(model, IDRLossConfig(loss.get_float("eikonal_weight"),
                                                  loss.get_float("mask_weight"),
                                                  loss.get_float("alpha")),
                            make_optimizer(model, conf.get_float("train.learning_rate")),
                            pose_vecs=pose_vecs, cam_opt=cam_opt,
                            lr_cam=conf.get_float("train.learning_rate_cam", 1e-4))
    captured = {}
    model.register_forward_hook(lambda m, a, o: captured.update(o))
    fm.reset_launch_counts()
    losses = step({k: v.to(device) for k, v in scene.items()}, img_idx.to(device),
                  pixel_idx.to(device), None, loss.get_float("alpha"),
                  draws={k: v.to(device) for k, v in draws.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = fm.snapshot_launch_counts()
    return {"losses": {k: float(v) for k, v in losses.items()},
            "mask": captured["network_object_mask"].cpu(), "grad": pose_vecs.grad.cpu(),
            "pose": pose_vecs.detach().cpu(), "cam_opt": {k: v.cpu() for k, v in cam_opt.items()},
            "launches": launches}


def phase_camera_step(dev, fm, data_root: str) -> dict:
    """The trained-camera conf at full width with ``tracer_fast = exact``
    and ``tracer_exact_fused = true``, one 256-ray step of image 3 on the
    card (the f32 kernel) and on the CPU (its plain twin), from the same
    weights, poses (the scene's noisy linear init) and injected draws; held
    at ``CAM_*``.  Returns the card's launches."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset
    from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork

    conf = parse_file(str(TRAINED_CONF))
    conf.put("model.tracer_fast", "exact")
    conf.put("model.tracer_exact_fused", True)
    ds = SceneDataset(True, conf.get_string("dataset.data_dir"),
                      conf.get_list("dataset.img_res"), 0, data_root=data_root)
    scene = ds.device_arrays("cpu")
    pose0 = ds.get_pose_init()
    g = torch.Generator().manual_seed(5)
    pixel_idx = torch.randperm(ds.total_pixels, generator=g)[:CAM_STEP_RAYS]
    img_idx = torch.tensor([3])
    cfg = IDRNetwork(conf.get_config("model"), device="cpu").ray_tracer
    stride = sweep_stride(cfg, False, on_cuda=True)  # exact: no guidance, either device
    draws = {"coarse": torch.rand((cfg.n_steps - 1) // stride + 1, generator=g),
             "fine": torch.rand(3 * (stride - 1), generator=g),
             "eik": torch.rand(CAM_STEP_RAYS // 2, 3, generator=g) * 2 - 1}
    card = camera_step(dev, fm, conf, scene, pose0, img_idx, pixel_idx, draws)
    cpu = camera_step(torch.device("cpu"), fm, conf, scene, pose0, img_idx, pixel_idx, draws)
    fm.reset_launch_counts()

    agree = float((card["mask"] == cpu["mask"]).float().mean())
    loss_rel = {k: abs(card["losses"][k] - v) / abs(v) for k, v in cpu["losses"].items()}
    gmax = float(cpu["grad"].abs().max())
    grad_err = float((card["grad"] - cpu["grad"]).abs().max()) / gmax
    clear = cpu["grad"].abs() > 2 * CAM_GRAD_TOL * gmax
    pose_err = (card["pose"] - cpu["pose"]).abs()
    moved = (cpu["pose"] - torch.from_numpy(pose0)).abs()
    rec = {"rays": CAM_STEP_RAYS, "losses_card": card["losses"], "losses_cpu": cpu["losses"],
           "loss_rel_err": loss_rel, "mask_agreement": agree,
           "hits": [int(card["mask"].sum()), int(cpu["mask"].sum())],
           "pose_grad_max": gmax, "pose_grad_err_rel": grad_err,
           "pose_err_clear_sign": float(pose_err[clear].max()),
           "pose_err_max": float(pose_err.max()), "pose_moved_max": float(moved.max()),
           "cam_opt_m_err_rel": float((card["cam_opt"]["m"] - cpu["cam_opt"]["m"]).abs().max())
           / float(cpu["cam_opt"]["m"].abs().max()),
           "cam_opt_step": [int(card["cam_opt"]["step"]), int(cpu["cam_opt"]["step"])],
           "launches_card": card["launches"], "launches_cpu": cpu["launches"]}
    print(f"[cameras] step card vs cpu: {json.dumps(rec)}")
    if not (all(v <= CAM_LOSS_RTOL for v in loss_rel.values()) and agree >= CAM_MASK_AGREE
            and grad_err <= CAM_GRAD_TOL and rec["pose_err_clear_sign"] <= CAM_POSE_TOL
            and rec["cam_opt_m_err_rel"] <= CAM_GRAD_TOL
            and rec["cam_opt_step"] == [1, 1]):
        raise AssertionError(f"cameras: the card's step disagrees with the CPU's: {rec}")
    untouched = [i for i in range(len(pose0)) if i != int(img_idx[0])]
    if card["grad"][untouched].any() or not torch.equal(card["pose"][untouched],
                                                         torch.from_numpy(pose0)[untouched]):
        raise AssertionError("cameras: rows of images not in the step moved")
    if (card["launches"]["fused_sdf_raw_f32"]["launches"] <= 0
            or any(c["launches"] for c in cpu["launches"].values())):
        raise AssertionError(f"cameras: f32 kernel launches {card['launches']} on the card, "
                             f"{cpu['launches']} on the CPU")
    return card["launches"]


@contextlib.contextmanager
def runner_start_state(kept: list):
    """While open, every ``IDRTrainRunner.run`` first appends a copy of the
    runner's pose table, SparseAdam state and counts as they stand before
    its first step (what a resume loaded)."""
    from hashmodnffbanks_idr_tpu_torch.train.trainer import IDRTrainRunner

    run = IDRTrainRunner.run

    def keeping(self):
        kept.append({"pose_vecs": self.pose_vecs.detach().cpu().clone(),
                     "cam_opt": {k: v.cpu().clone() for k, v in self.cam_opt.items()},
                     "start_epoch": self.start_epoch, "step_count": self.step_count})
        return run(self)

    IDRTrainRunner.run = keeping
    try:
        yield kept
    finally:
        IDRTrainRunner.run = run


def phase_cameras(dev, fm, smi: str, workdir: str, data_root: str) -> dict:
    """Trainable cameras on the eval phase's 8-view scene: the card-vs-CPU
    step (``phase_camera_step``); the trained-camera conf read in place
    through ``exp_runner --train_cameras`` for ``CAM_EPOCHS`` epochs, then
    ``--is_continue`` to 2 more; ``run_eval --eval_cameras`` at resolution
    100 (the errors against GT are printed beside the noisy init's, not
    held); ``preprocess_cameras`` on the card, its voxel votes equal to a CPU
    run.  The phase's counts: the card step's (reset just before it, read
    just after), plus the runner's (reset just before the first run, read
    just after the resumed one)."""
    from hashmodnffbanks_idr_tpu_torch.data import preprocess_cameras as pc
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import glob_imgs, load_mask
    from hashmodnffbanks_idr_tpu_torch.eval import run_eval
    from hashmodnffbanks_idr_tpu_torch.eval.evaluator import camera_alignment
    from hashmodnffbanks_idr_tpu_torch.geometry.cameras import quat_to_rot
    from hashmodnffbanks_idr_tpu_torch.train import exp_runner

    t_phase = time.perf_counter()
    step_launches = phase_camera_step(dev, fm, data_root)
    exps, evals = os.path.join(workdir, "exps_cam"), os.path.join(workdir, "evals_cam")
    common = ["--conf", str(TRAINED_CONF), "--train_cameras", "--data_root", data_root,
              "--exps_folder_name", exps, "--no_tensorboard"]
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    first = exp_runner.main(common + ["--nepoch", str(CAM_EPOCHS)])
    train_s = time.perf_counter() - t0
    saved = torch.load(os.path.join(first.checkpoints_path, "latest.pt"), weights_only=True)
    kept = []
    with runner_start_state(kept):
        second = exp_runner.main(common + ["--nepoch", str(CAM_EPOCHS + 2), "--is_continue"])
    counts = fm.snapshot_launch_counts()
    for name, c in step_launches.items():
        for k in ("launches", "points"):
            counts[name][k] += c[k]

    # the first run takes epochs 0..CAM_EPOCHS and saves its end as epoch
    # CAM_EPOCHS, which the resumed run takes again (then two more)
    require_graphed(first, second)
    steps = (CAM_EPOCHS + 1) * first.steps_per_epoch
    resumed = kept[0]
    if not (resumed["start_epoch"] == CAM_EPOCHS and resumed["step_count"] == steps
            and torch.equal(resumed["pose_vecs"], saved["pose_vecs"])
            and all(torch.equal(resumed["cam_opt"][k], saved["cam_opt"][k])
                    for k in ("m", "v", "step"))
            and int(saved["cam_opt"]["step"]) == steps == saved["step"]):
        raise AssertionError(f"cameras: the resume did not restore the saved cameras "
                             f"(start {resumed['start_epoch']}, step {resumed['step_count']}, "
                             f"cam_opt.step {int(saved['cam_opt']['step'])}, expected {steps})")
    init = torch.from_numpy(first.train_dataset.get_pose_init())
    pose = second.pose_vecs.detach().cpu()
    if not (bool(torch.isfinite(pose).all()) and not torch.equal(pose, init)
            and int(second.cam_opt["step"]) == steps + 3 * first.steps_per_epoch):
        raise AssertionError("cameras: the pose table is not finite or did not move")
    rows = read_scalars(first.rundir) + read_scalars(second.rundir)
    losses = [r["loss"] for r in read_scalars(first.rundir)]
    bf16 = [r["fused_sdf_raw_bf16_launches"] for r in rows]
    first5 = statistics.median(losses[:NGP_RUNNER_WINDOW])
    last5 = statistics.median(losses[-NGP_RUNNER_WINDOW:])
    if not (all(math.isfinite(r["loss"]) for r in rows) and last5 < NGP_RUNNER_FALL * first5):
        raise AssertionError(f"cameras: the loss did not fall: {losses}")
    if min(bf16) <= 0 or sum(bf16) != counts["fused_sdf_raw_bf16"]["launches"]:
        raise AssertionError(f"cameras: bf16 kernel launches per epoch {bf16}")

    t0 = time.perf_counter()
    res = run_eval.main(["--conf", str(TRAINED_CONF), "--data_root", data_root,
                         "--resolution", "100", "--eval_cameras", "--exps_folder", exps,
                         "--evals_folder", evals])
    eval_s = time.perf_counter() - t0
    acc = res["camera_accuracy"]
    gt = first.train_dataset.get_gt_pose(scaled=True)
    init_acc = camera_alignment(quat_to_rot(init[:, :4]).numpy(), gt[:, :3, :3],
                                init[:, 4:].numpy(), gt[:, :3, 3])
    if acc is None or not all(math.isfinite(acc[k]) for k in ("rot_err_mean", "t_err_mean")):
        raise AssertionError(f"cameras: run_eval --eval_cameras gave {acc}")

    # preprocess_cameras: the CLI on the card, then each carve's votes on
    # the card against the CPU on the same inputs
    scan = first.train_dataset.instance_dir
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pc.main(["--source_dir", scan])
    preprocess_s = time.perf_counter() - t0
    new = np.load(out)["scale_mat_0"]
    own = first.train_dataset.get_scale_mat()
    cams = np.load(os.path.join(scan, "cameras.npz"))
    masks = np.stack([load_mask(q) for q in glob_imgs(os.path.join(scan, "mask"))])
    Ps = np.stack([cams[f"world_mat_{i}"][:3, :4].astype(np.float64) for i in range(len(masks))])
    center, scale, _ = pc.epipolar_depth_bounds(Ps, pc.mask_points(masks))
    carves = {}
    for name, fn, kw in (("refine", pc.refine_votes, {"scale": scale, "center": center}),
                         ("hull", pc.hull_votes, {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, v_card = fn(masks, Ps, grid=100, device=dev, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, v_cpu = fn(masks, Ps, grid=100, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        carves[name] = {"voxels": v_cpu.numel(), "views": len(masks), "card_s": card_s,
                        "cpu_s": cpu_s, "inside_all": int((v_cpu >= len(masks)).sum()),
                        "votes_equal": bool(torch.equal(v_card.cpu(), v_cpu))}
        if not carves[name]["votes_equal"]:
            raise AssertionError(f"cameras: {name} votes on the card differ from the CPU's")

    rec = {"card": smi, "conf": TRAINED_CONF.name, "epochs": CAM_EPOCHS,
           "steps_per_epoch": first.steps_per_epoch, "train_s": train_s,
           "loss_epoch0": losses[0], f"loss_epoch{CAM_EPOCHS}": losses[-1],
           "loss_median_first": first5, "loss_median_last": last5,
           "rays_per_s_median_epochs_2_on": statistics.median(
               r["rays_per_s"] for r in read_scalars(first.rundir)[2:]),
           "bf16_launches_per_epoch": bf16, "skipped_steps": sum(r["skipped_steps"] for r in rows),
           "cam_opt_step_saved": int(saved["cam_opt"]["step"]),
           "pose_moved_max": float((pose - init).abs().max()), "run_eval_s": eval_s,
           "camera_error_trained": {k: acc[k] for k in ("rot_err_mean", "rot_err_median",
                                                        "t_err_mean", "t_err_median")},
           "camera_error_init": {k: init_acc[k] for k in ("rot_err_mean", "rot_err_median",
                                                          "t_err_mean", "t_err_median")},
           "preprocess_s": preprocess_s, "preprocess_center": new[:3, 3].tolist(),
           "preprocess_scale": float(new[0, 0]), "scene_center": own[:3, 3].tolist(),
           "scene_scale": float(own[0, 0]), "carves_grid_100": carves,
           "phase_s": time.perf_counter() - t_phase}
    print(f"[cameras] {json.dumps(rec)}")
    fm.reset_launch_counts()
    return counts


def parallel_rank(rank: int, world: int, dev, workdir: str) -> dict:
    """One rank of the ``[parallel]`` phase (see PAR_*): the sharded and the
    unsharded flagship step, the f32 kernel on the largest call the sharded
    step gave it, the timed steps, and the runner under the mesh.  Counts
    reset just before the sharded step and read just after, and again around
    the runner.  Returns the rank's record."""
    import torch.distributed as dist

    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
    from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
    from hashmodnffbanks_idr_tpu_torch.parallel.sharding import make_mesh
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, scene_to_device,
                                                       synthetic_scene)
    from hashmodnffbanks_idr_tpu_torch.train.trainer import (IDRTrainRunner, build_train_step,
                                                             make_optimizer)
    from hashmodnffbanks_idr_tpu_torch.utils.compile_cache import build_once
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    build_once(fm.load_library)
    mesh = make_mesh(n_model=1)
    conf = flagship_conf(num_pixels=N_RAYS)
    conf.put("model.tracer_fast", "exact")
    conf.put("model.tracer_exact_fused", True)
    loss_cfg = IDRLossConfig(0.1, 200.0, ALPHA)
    models, steps = {}, {}
    for label, m in (("sharded", mesh), ("unsharded", None)):
        models[label] = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
        steps[label] = build_train_step(models[label], loss_cfg, make_optimizer(models[label]),
                                        mesh=m)
    scene = scene_to_device(synthetic_scene(n_views=2, img_res=IMG_RES, seed=0), dev)
    total = IMG_RES[0] * IMG_RES[1]
    img_idx = torch.tensor([0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    pixel_idx = sample_pixels(gen, total, N_RAYS)
    draws = models["unsharded"].draw_uniforms(gen, N_RAYS, dev)

    kept = {}
    fm.reset_launch_counts()
    with keep_largest_call(fm, kept):
        sharded = steps["sharded"](scene, img_idx, pixel_idx, None, ALPHA, draws=draws)
        torch.cuda.synchronize()
    counts = fm.snapshot_launch_counts()
    if counts["fused_sdf_raw_f32"]["launches"] == 0:
        raise AssertionError(f"parallel: rank {rank}: the sharded step launched no f32 kernel")
    unsharded = steps["unsharded"](scene, img_idx, pixel_idx, None, ALPHA, draws=draws)
    losses = {k: [float(sharded[k]), float(unsharded[k])] for k in unsharded}
    rel = {k: abs(a - b) / max(abs(b), 1e-30) for k, (a, b) in losses.items()}
    if not max(rel.values()) <= PAR_LOSS_RTOL:
        raise AssertionError(f"parallel: rank {rank}: loss terms {losses} differ by {rel}")
    worst, param_diff = -math.inf, 0.0
    for (n, a), b in zip(models["sharded"].named_parameters(),
                         models["unsharded"].parameters()):
        d = (a.detach() - b.detach()).abs()
        param_diff = max(param_diff, float(d.max()))
        excess = float((d - PAR_PARAM_ATOL - PAR_PARAM_RTOL * b.detach().abs()).max())
        if excess > 0:
            raise AssertionError(f"parallel: rank {rank}: {n} differs by {float(d.max())}")
        worst = max(worst, excess)
    name = "fused_sdf_raw_f32"
    x, packed = kept[name]
    err = hold_against_plain(fm, name, x, packed, where=f" (rank {rank}, sharded step)")
    checksum = torch.tensor([sum(float(p.detach().double().sum())
                                 for p in models["sharded"].parameters())],
                            dtype=torch.float64, device=dev)
    sums = [torch.zeros_like(checksum) for _ in range(world)]
    dist.all_gather(sums, checksum)
    if len({float(t) for t in sums}) != 1:
        raise AssertionError(f"parallel: parameter checksums differ across ranks: {sums}")

    # the two steps alternate, so that a drift of the host's speed hits both
    times = {"sharded": [], "unsharded": []}
    for i in range(PAR_WARMUP + PAR_STEPS):
        for label in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[label](scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, ALPHA)
            torch.cuda.synchronize()
            if i >= PAR_WARMUP:
                times[label].append((time.perf_counter() - t0) * 1e3)
    ms = {label: {"median": statistics.median(t), "min": min(t), "max": max(t)}
          for label, t in times.items()}
    del models, steps, scene
    torch.cuda.empty_cache()

    # the runner under the mesh: the dummy conf with the mixed tracer
    data_root = os.path.join(workdir, "parallel_data")
    if rank == 0:
        dummy_cli.main(["--out", os.path.join(data_root, "dummy", "scan0")])
    dist.barrier()
    rconf = parse_file(str(DUMMY_CONF))
    rconf.put("model.tracer_fast", "mixed")
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    runner = IDRTrainRunner(rconf, nepochs=PAR_RUNNER_EPOCHS, data_root=data_root,
                            exps_folder_name=os.path.join(workdir, "parallel_exps"),
                            log_tensorboard=False, device=dev, mesh=mesh)
    runner.run()
    runner_s = time.perf_counter() - t0
    runner_counts = fm.snapshot_launch_counts()
    if runner_counts["fused_sdf_raw_bf16"]["launches"] == 0:
        raise AssertionError(f"parallel: rank {rank}: the runner launched no bf16 kernel")
    rec = {"rank": rank, "world": world, "mesh": list(mesh.shape), "losses": losses,
           "loss_rel_diff": rel, "param_max_abs_diff": param_diff,
           "param_worst_excess_over_bound": worst, "checksum": float(checksum),
           "largest_call": {"n": x.shape[0], "d_in": x.shape[1], "max_abs_err": err},
           "ms_per_step": ms, "counts": counts, "runner_counts": runner_counts,
           "runner_s": runner_s}
    if rank == 0:
        rows = read_scalars(runner.rundir)
        keys = ("loss", "rgb_loss", "eikonal_loss", "mask_loss")
        if [r["step"] for r in rows] != list(range(PAR_RUNNER_EPOCHS + 1)):
            raise AssertionError(f"parallel: runner logged epochs {[r['step'] for r in rows]}")
        if not all(math.isfinite(r[k]) for r in rows for k in keys):
            raise AssertionError("parallel: a runner loss is not finite")
        per_epoch = [r["fused_sdf_raw_bf16_launches"] for r in rows]
        if min(per_epoch) <= 0:
            raise AssertionError(f"parallel: bf16 launches per epoch {per_epoch}")
        rec["runner"] = {"losses": [r["loss"] for r in rows], "bf16_launches_per_epoch": per_epoch,
                         "rays_per_s": [r["rays_per_s"] for r in rows],
                         "skipped_steps": sum(r["skipped_steps"] for r in rows)}
    return rec


def phase_parallel(smi: str, workdir: str) -> tuple:
    """The ``[parallel]`` phase: one rank per card over NCCL.  First the
    dry run through ``graft_entry.dryrun_multichip`` (its four runs must end
    with a finite loss; ``ngp15-full`` must row-shard its table), then
    ``parallel_rank`` in every rank.  Any rank's failure raises.  Returns
    the counts summed over the ranks (sharded step, runner) and the f32
    kernel's largest-call check."""
    from hashmodnffbanks_idr_tpu_torch import graft_entry
    from hashmodnffbanks_idr_tpu_torch.parallel import multihost

    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(world, timeout=600)
    dry_s = time.perf_counter() - t0
    ngp = [r for recs in dry for r in recs if r["label"] == "ngp15-full"]
    if not all(r["sharded_tables"] for r in ngp):
        raise AssertionError("parallel: ngp15-full did not row-shard its table")
    if not all(math.isfinite(r["loss"]) for recs in dry for r in recs):
        raise AssertionError("parallel: a dry-run loss is not finite")
    t0 = time.perf_counter()
    ranks = multihost.spawn(parallel_rank, world, args=(workdir,), device="cuda", timeout=900)
    ranks_s = time.perf_counter() - t0

    def summed(key):
        return {k: {f: sum(r[key][k][f] for r in ranks) for f in ("launches", "points")}
                for k in ranks[0][key]}

    r0 = ranks[0]
    rec = {"card": smi, "world": world, "mesh": r0["mesh"],
           "dryrun": [{k: r[k] for k in ("label", "mesh", "n_rays", "loss", "sharded_tables",
                                          "launches")} for r in dry[0]],
           "dryrun_s": dry_s, "losses_sharded_unsharded": r0["losses"],
           "loss_rel_diff_max": max(max(r["loss_rel_diff"].values()) for r in ranks),
           "param_max_abs_diff": max(r["param_max_abs_diff"] for r in ranks),
           "checksums": [r["checksum"] for r in ranks],
           "f32_launches_by_rank": [r["counts"]["fused_sdf_raw_f32"]["launches"] for r in ranks],
           "largest_call_by_rank": [r["largest_call"] for r in ranks],
           "ms_per_step_sharded": [r["ms_per_step"]["sharded"] for r in ranks],
           "ms_per_step_unsharded": [r["ms_per_step"]["unsharded"] for r in ranks],
           "collective_cost_ms_median": (r0["ms_per_step"]["sharded"]["median"]
                                         - r0["ms_per_step"]["unsharded"]["median"]),
           "runner": r0["runner"], "runner_s": r0["runner_s"], "ranks_s": ranks_s}
    print(f"[parallel] world size {world}, mesh {tuple(r0['mesh'])}")
    print(f"[parallel] {json.dumps(rec)}")
    largest = max((r["largest_call"] for r in ranks), key=lambda c: c["max_abs_err"])
    return summed("counts"), summed("runner_counts"), largest


def kernel_record(fm, name, x, packed, where=""):
    """One variant on one input: held against its plain twin, then timed
    beside the plain twin and the cuBLAS chain, with its bound."""
    products, peak_key = {n: (p, k) for n, _, _, k, p in VARIANTS}[name]
    err = hold_against_plain(fm, name, x, packed, where)
    n, d_in = x.shape
    hidden = packed["b_in"].shape[0]
    layers = fm.plain_pack(packed, d_in)
    ms = cuda_ms(lambda: fm.fused_sdf_raw(x, packed))
    plain_ms = cuda_ms(lambda: fm.fused_sdf_raw_plain(x, layers))
    library_ms = cuda_ms(lambda: library_chain(x, layers))
    flops, nbytes = sdf_mlp_cost(n, d_in, hidden, packed["w_out"].element_size())
    t_ops = products * flops / PEAK_FLOPS[peak_key] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"d_in": d_in, "k0": fm.kernel_depth(d_in), "n": n, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "max_abs_err": err}


@torch.no_grad()
def spread_input_weights(net, gen):
    """Add N(0, 0.03^2) to the first layer's and the skip layers' weights, as
    training would spread them: the geometric init leaves their columns past
    the 3 coordinates at zero, where a kernel that dropped those columns of
    x would still agree with its plain twin."""
    for l in (0, *net.skip_in):
        lin = net.lin[l]
        p = lin.v if lin.weight_norm else lin.w
        p.add_(0.03 * torch.randn(p.shape, generator=gen, device=p.device))


@torch.no_grad()
def phase_depths(dev, fm):
    """Each variant against its plain twin at every encoder's first-layer
    depth (``CHECK_D_IN``), on that encoder's embedding of N=4096 points,
    timed.  The geometric init zeroes the first layer's and the skip's
    weights past the 3 coordinates, so each depth is held a second time with
    those weights spread (``spread_input_weights``), where every input
    column counts, and there at every configuration the variant compiles,
    each bit for bit equal to its smallest C (``hold_clusters``).  Launches
    made here are comparisons and are not counted."""
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf

    gen = torch.Generator(device=dev).manual_seed(2)
    records = {name: [] for name, *_ in VARIANTS}
    for d_in, (embed_type, puts) in CHECK_D_IN.items():
        conf = flagship_conf(num_pixels=N_RAYS, embed_type=embed_type)
        for k, v in puts.items():
            conf.put(k, v)
        net = IDRNetwork(conf.get_config("model"), device=dev, seed=0).implicit_network
        if net.dims[0] != d_in:
            raise AssertionError(f"{embed_type}: d_in {net.dims[0]}, expected {d_in}")
        pts = (torch.rand(DEPTH_N, 3, generator=gen, device=dev) * 2 - 1) * 0.6
        x = net._embed(pts).contiguous()
        packed = {name: fm.pack_params(net.lin, d_in, net.dims[1], dtype=dtype)
                  for name, dtype, *_ in VARIANTS}
        spread_input_weights(net, gen)
        for name, dtype, *_ in VARIANTS:
            rec = kernel_record(fm, name, x, packed[name], f" d_in={d_in} ({embed_type})")
            spread = fm.pack_params(net.lin, d_in, net.dims[1], dtype=dtype)
            where = f" d_in={d_in} ({embed_type}, input weights spread)"
            rec["max_abs_err_spread"] = hold_against_plain(fm, name, x, spread, where)
            rec["max_abs_err_by_cluster"] = hold_clusters(fm, name, x, spread, where)
            rec["max_abs_err"] = max([rec["max_abs_err"], rec["max_abs_err_spread"]]
                                     + list(rec["max_abs_err_by_cluster"].values()))
            print(f"[ngp] kernel {name} {embed_type}: {json.dumps(rec)}")
            records[name].append(rec)
    fm.reset_launch_counts()
    return records


@torch.no_grad()
def phase_determinism(dev, fm):
    """Each variant at each compiled first-layer depth (d_in 59, 102, 198,
    510 of ``CHECK_D_IN``, input weights spread) and each cluster size it
    compiles, launched DETERMINISM_LAUNCHES times on one input of
    DETERMINISM_N points, a ragged last tile: every output must equal the
    first launch's bit for bit, and each cluster size's the launch at the
    variant's smallest C.  The f32 kernel is also held there against its
    plain twin at every K0 and C at the main path's sizes
    (``F32_HELD_N``).  The launches are a check, not the main path: the
    counts are reset after."""
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf

    gen = torch.Generator(device=dev).manual_seed(4)
    records = {name: {"n": DETERMINISM_N, "launches": DETERMINISM_LAUNCHES, "k0": [],
                      "clusters": list(fm.cluster_sizes(name)), "bit_identical": True}
               for name, *_ in VARIANTS}
    held = records["fused_sdf_raw_f32"]["held"] = {"n": list(F32_HELD_N), "tol": TOL_F32,
                                                   "max_abs_err": {}}
    for d_in in (59, 102, 198, 510):
        embed_type, puts = CHECK_D_IN[d_in]
        conf = flagship_conf(num_pixels=N_RAYS, embed_type=embed_type)
        for k, v in puts.items():
            conf.put(k, v)
        net = IDRNetwork(conf.get_config("model"), device=dev, seed=0).implicit_network
        spread_input_weights(net, gen)
        pts = (torch.rand(DETERMINISM_N, 3, generator=gen, device=dev) * 2 - 1) * 0.6
        x = net._embed(pts).contiguous()
        k0 = fm.kernel_depth(d_in)
        for name, dtype, *_ in VARIANTS:
            packed = fm.pack_params(net.lin, d_in, net.dims[1], dtype=dtype)
            records[name]["k0"].append(k0)
            # each cluster size, each also equal to the smallest
            sizes = fm.cluster_sizes(name)
            outs = {}
            for c in sizes:
                first = fm._launch(x, packed, cluster=c).view(torch.int32)
                same = all(torch.equal(fm._launch(x, packed, cluster=c).view(torch.int32), first)
                           for _ in range(DETERMINISM_LAUNCHES - 1))
                outs[c] = first
                where = f"{name} K0={k0} C={c}"
                records[name]["bit_identical"] &= same
                print(f"[determinism] {where} N={DETERMINISM_N}: "
                      f"{DETERMINISM_LAUNCHES} launches {'bit-identical' if same else 'DIFFER'}")
                if not same:
                    raise AssertionError(f"{where}: repeated launches on one input differ")
                if not torch.equal(first, outs[sizes[0]]):
                    raise AssertionError(f"{where}: differs from C={sizes[0]} on the same input")
            if name != "fused_sdf_raw_f32":
                continue
            errs = {c: 0.0 for c in sizes}
            for n in F32_HELD_N:
                pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
                xn = net._embed(pts).contiguous()
                want = fm.fused_sdf_raw_plain(xn, packed)
                got = {c: fm._launch(xn, packed, cluster=c) for c in sizes}
                for c, out in got.items():
                    err = float((out - want).abs().max())
                    errs[c] = max(errs[c], err)
                    where = f"{name} K0={k0} C={c} N={n}"
                    if not err <= TOL_F32:
                        raise AssertionError(f"{where}: max abs err {err} > {TOL_F32}")
                    if not torch.equal(out.view(torch.int32), got[sizes[0]].view(torch.int32)):
                        raise AssertionError(f"{where}: differs from C={sizes[0]}")
            held["max_abs_err"][k0] = errs
            print(f"[determinism] {name} K0={k0}: against the plain twin at N={F32_HELD_N}, "
                  f"each C bit-identical to C={sizes[0]}: max_abs_err by C {errs} "
                  f"(tol {TOL_F32:g})")
    fm.reset_launch_counts()
    return records


def phase_ngp_steps(dev, fm, scene):
    """The ngp presets' training step at full width (``NGP_CELLS``), each
    cell through ``phase_step`` (counts reset just before its timed steps and
    read just after; the cell fails if its kernel was not launched in every
    step); then each variant held against its plain twin on the largest
    call the cells gave it, and timed there."""
    from hashmodnffbanks_idr_tpu_torch.testing import ngp_conf

    counts, kept = {}, {}
    with keep_largest_call(fm, kept):
        for preset, label, mode, fused, expect in NGP_CELLS:
            cell = f"{preset} {label}"
            counts[cell] = phase_step(dev, fm, scene, cell, mode, fused, 2, 10, expect=expect,
                                      conf=ngp_conf(preset, num_pixels=N_RAYS), tag="ngp")
    largest = {}
    for name, (x, packed) in kept.items():
        largest[name] = kernel_record(fm, name, x, packed, " (the ngp step's largest call)")
        print(f"[ngp] largest call {name}: {json.dumps(largest[name])}")
    kept.clear()
    fm.reset_launch_counts()
    return counts, largest


def phase_ngp_runner(fm, smi: str, workdir: str, data_root: str) -> dict:
    """The repo's hash-grid and positional-encoding confs through
    ``exp_runner`` for ``NGP_RUNNER_EPOCHS`` epochs each, on the scene the
    eval phase generated.  Counts reset just before each run and read just
    after; the loss must fall (``NGP_RUNNER_FALL``) and the bf16 kernel run
    every epoch.  The record counts the steps whose gradient was not finite
    (their updates skipped by the train step)."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
    from hashmodnffbanks_idr_tpu_torch.train import exp_runner

    counts = {}
    for conf_name in NGP_RUNNER_CONFS:
        conf = parse_file(str(DUMMY_CONF.parent / conf_name))
        conf.put("dataset.img_res", [240, 320])
        conf.put("dataset.data_dir", "dtu_shaped_small")
        conf_path = os.path.join(workdir, conf_name)
        with open(conf_path, "w") as f:
            f.write(conf.dump())
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        runner = exp_runner.main(["--conf", conf_path, "--nepoch", str(NGP_RUNNER_EPOCHS),
                                  "--data_root", data_root, "--no_tensorboard",
                                  "--exps_folder_name", os.path.join(workdir, "exps_ngp")])
        train_s = time.perf_counter() - t0
        counts[conf_name] = fm.snapshot_launch_counts()
        require_graphed(runner)
        rows = read_scalars(runner.rundir)
        bf16 = [r["fused_sdf_raw_bf16_launches"] for r in rows]
        losses = [r["loss"] for r in rows]
        rec = {"card": smi, "conf": conf_name, "d_in": runner.model.implicit_network.dims[0],
               "embed_type": conf.get_string("model.embedding_network.embed_type"),
               "tracer_fast": conf.get_string("model.tracer_fast"), "epochs": NGP_RUNNER_EPOCHS,
               "steps_per_epoch": runner.steps_per_epoch, "train_s": train_s,
               "loss_epoch0": losses[0], f"loss_epoch{NGP_RUNNER_EPOCHS}": losses[-1],
               "loss_median_first": statistics.median(losses[:NGP_RUNNER_WINDOW]),
               "loss_median_last": statistics.median(losses[-NGP_RUNNER_WINDOW:]),
               "losses": losses,
               "rays_per_s_median_epochs_2_on": statistics.median(
                   r["rays_per_s"] for r in rows[2:]),
               "bf16_launches_per_epoch": bf16,
               "bf16_points": counts[conf_name]["fused_sdf_raw_bf16"]["points"],
               "bf16_launches_per_step_by_config": by_config(
                   counts[conf_name], "fused_sdf_raw_bf16", len(rows) * runner.steps_per_epoch),
               "skipped_steps": sum(r["skipped_steps"] for r in rows)}
        print(f"[ngp] runner {json.dumps(rec)}")
        if [r["step"] for r in rows] != list(range(NGP_RUNNER_EPOCHS + 1)):
            raise AssertionError(f"{conf_name}: logged epochs {[r['step'] for r in rows]}")
        if not all(math.isfinite(v) for v in losses) or not (
                rec["loss_median_last"] < NGP_RUNNER_FALL * rec["loss_median_first"]):
            raise AssertionError(f"{conf_name}: the loss did not fall: {losses}")
        if min(bf16) <= 0 or sum(bf16) != counts[conf_name]["fused_sdf_raw_bf16"]["launches"]:
            raise AssertionError(f"{conf_name}: bf16 kernel launches per epoch {bf16}")
    fm.reset_launch_counts()
    return counts


def check_spills(ptxas_log: str, depths) -> dict:
    """Each kernel, at every compiled first-layer depth (and the f32 kernel
    at every cluster size), must keep its float accumulators and its
    fragments in registers: no spills in the ``-Xptxas -v`` report.  Returns
    each variant's registers a thread and spill bytes (stores + loads) by
    instantiation ("K0" or "K0,C")."""
    out = {}
    for name, (mangled, rest) in PTXAS_ENTRY.items():
        out[name] = {}
        for k0 in depths:
            for c in rest:
                args = f"ILi{k0}E" + (f"Li{c}E" if c else "") + "E"
                label = f"{k0}" + (f",{c}" if c else "")
                entries = [e for e in ptxas_log.split("Compiling entry function")[1:]
                           if f"{mangled}{args}" in e]
                if len(entries) != 1:
                    raise AssertionError(f"ptxas report: {len(entries)} entries of {name} "
                                         f"<{label}>")
                spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                                     entries[0])]
                regs = re.search(r"Used (\d+) registers", entries[0])
                print(f"[ptxas] {name} <{label}>: {regs.group(1) if regs else '?'} registers, "
                      f"spill stores/loads {spills} bytes")
                if len(spills) != 2 or any(spills) or regs is None:
                    raise AssertionError(f"{name} <{label}> spills registers: "
                                         f"{entries[0].strip()}")
                out[name][label] = {"registers": int(regs.group(1)), "spill_bytes": sum(spills)}
    return out


def descendants() -> list:
    """The pids of this process's descendants that have not exited, from
    ``/proc``."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError):
                continue
    out, front = [], [os.getpid()]
    while front:
        pid = front.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        out += kids
        front += kids
    return [p for p in out if running(p)]


def running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def stop_children(grace_s: float = 5.0) -> None:
    """Stop every process the script started that still runs, however the
    script ended: multiprocessing's resource tracker (the spawn context's
    pools and ranks start it; it ignores SIGTERM), and any worker or rank a
    failed phase left.  SIGTERM, then SIGKILL after ``grace_s``; the
    script's own children are reaped."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    pids = descendants()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0]:
                    pass
            pids = [p for p in pids if running(p)]
            if not pids:
                return
            time.sleep(0.1)
    if pids:
        print(f"chip_smoke: processes {pids} outlived SIGKILL", file=sys.stderr)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2

    from hashmodnffbanks_idr_tpu_torch import resolve_device
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, ngp_conf,
                                                       scene_to_device, synthetic_scene)

    t_start = time.perf_counter()
    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    # the bounds use the H100 SXM data sheet (HBM3 marks the SXM part)
    sxm = "H100" in name and ("HBM3" in name or "SXM" in name)
    print(f"[bound] peaks {PEAK_FLOPS} FLOP/s, {PEAK_BYTES_PER_S} B/s are the H100 SXM's: "
          f"{'this card' if sxm else 'NOT this card; bound_ms is only indicative'}")

    release = subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-2]
    cuda_driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip()
    print(f"[versions] nvcc: {release}; CUDA driver {cuda_driver}; torch {torch.__version__} "
          f"built with CUDA {torch.version.cuda}")

    # one nvcc for each source, both started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for build in [pool.submit(fm.load_library), pool.submit(gl.load_library)]:
            build.result()
    print(f"[build] fused_mlp.cu and graph_loops.cu built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    report = fm.ptxas_report().read_text()
    print(report.strip())
    regs = check_spills(report, fm.KERNEL_DEPTHS)

    model = IDRNetwork(flagship_conf(num_pixels=N_RAYS).get_config("model"), device=dev, seed=0)
    kernels = phase_kernels(dev, fm, model)
    ffbtcnn = IDRNetwork(ffbtcnn_conf().get_config("model"), device=dev, seed=0)
    encode = phase_nffb_encode(dev, fm, {"StyleModNFFB": model, "FFBTcnn": ffbtcnn})
    del model, ffbtcnn
    depth_records = phase_depths(dev, fm)
    phase_reference(dev, fm)
    ngp_ref = ngp_conf("ngp_log2_15", num_pixels=256)
    ngp_ref.put("model.tracer_exact_fused", False)
    phase_reference(dev, fm, conf=ngp_ref, label="ngp log2=15 exact (unfused)", expect=None)
    ngp_mixed = ngp_conf("ngp_log2_15", num_pixels=256)
    ngp_mixed.put("model.tracer_fast", "mixed")
    phase_reference(dev, fm, conf=ngp_mixed, label="ngp log2=15 mixed",
                    expect="fused_sdf_raw_bf16")
    deterministic = phase_determinism(dev, fm)
    set_while = phase_set_while(dev)

    scene = scene_to_device(synthetic_scene(n_views=2, img_res=IMG_RES, seed=0), dev)
    phases = {
        "exact+fused": phase_step(dev, fm, scene, "exact+fused", "exact", True, 2, 10,
                                  expect="fused_sdf_raw_f32"),
        "mixed": phase_step(dev, fm, scene, "mixed", "mixed", False, 2, 10,
                            expect="fused_sdf_raw_bf16"),
        "fast": phase_step(dev, fm, scene, "fast", "fast", False, 2, 10,
                           expect="fused_sdf_raw_bf16"),
        "exact (unfused)": phase_step(dev, fm, scene, "exact (unfused)", "exact", False, 1, 3),
        "ffbtcnn mixed": phase_step(dev, fm, scene, "ffbtcnn mixed", "mixed", False, 2, 10,
                                    expect="nffb_ngp_encode_bf16", conf=ffbtcnn_conf(),
                                    tag="ffbtcnn mixed"),
    }
    phases.update({f"graph {k}": v for k, v in phase_graph(dev, fm, scene, smi).items()})
    ngp_counts, ngp_largest = phase_ngp_steps(dev, fm, scene)
    phases.update(ngp_counts)
    del scene
    with tempfile.TemporaryDirectory() as workdir:
        phases["runner"] = phase_runner(fm, smi, workdir)
        phase_decode(smi, workdir)
        phases["eval"], eval_largest = phase_eval(fm, smi, workdir)
        phases["cameras"] = phase_cameras(dev, fm, smi, workdir, os.path.join(workdir, "data"))
        phases.update(phase_ngp_runner(fm, smi, workdir, os.path.join(workdir, "data")))
        phases["parallel"], phases["parallel-runner"], parallel_largest = phase_parallel(
            smi, workdir)

    src = "hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu"
    out = []
    # launches and points: each kernel's run in its first main-path cell
    for name, cell in (("fused_sdf_raw_f32", "exact+fused"), ("fused_sdf_raw_bf16", "mixed")):
        r = kernels[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": "hashmodnffbanks_idr_tpu/ops/fused_mlp.py:104",
               "design": KERNEL_DESIGN[name],
               "launches": phases[cell][name]["launches"], "points": phases[cell][name]["points"],
               "launches_by_phase": {p: c[name]["launches"] for p, c in phases.items()}}
        rec.update((k, r[k]) for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_fp32_cores_ms", "bound_by", "library_ms",
                                        "n", "other_calls") if k in r)
        # the largest error of every check: the tracer's batch sizes and the
        # eval render's largest call
        rec["max_abs_err"] = max(r["max_abs_err"], eval_largest[name]["max_abs_err"])
        rec["eval_largest_call"] = eval_largest[name]
        rec["registers"] = max(r["registers"] for r in regs[name].values())
        rec["spill_bytes"] = sum(r["spill_bytes"] for r in regs[name].values())
        rec["registers_by_depth"] = {k: r["registers"] for k, r in regs[name].items()}
        # the [ngp] phase: every encoder's first-layer depth at N=4096, and
        # the ngp step's largest call
        rec["held_d_in"] = sorted(set(CHECK_D_IN) | {ngp_largest[name]["d_in"]})
        rec["depths"] = depth_records[name]
        rec["ngp_largest_call"] = ngp_largest[name]
        rec["max_abs_err"] = max([rec["max_abs_err"], ngp_largest[name]["max_abs_err"]]
                                 + [r["max_abs_err"] for r in depth_records[name]])
        rec["deterministic"] = deterministic[name]["bit_identical"]
        rec["determinism"] = deterministic[name]
        if name == "fused_sdf_raw_f32":  # the [parallel] phase's sharded step
            rec["parallel_largest_call"] = parallel_largest
            rec["max_abs_err"] = max(rec["max_abs_err"], parallel_largest["max_abs_err"])
        # the cluster sizes: the rule's choice and each forced C's time at
        # each timed call, the slots it read, the main path's launches by C,
        # the forced checks
        calls = r["other_calls"] + [r]
        rec["cluster"] = {c["n"]: c["cluster"] for c in calls}
        rec["ms_by_cluster"] = {c["n"]: c["ms_by_cluster"] for c in calls}
        rec["slots"] = r["slots"]
        rec["tiles"] = fm.TILES[name]
        rec["launches_by_cluster"] = {c: phases[cell][name][f"cluster_{c}"]
                                      for c in fm.cluster_sizes(name)}
        rec["cluster_check"] = r["cluster_check"]
        # the cell's march calls (2 x 2048 rays) run on the rule's
        # configuration
        march_c = rec["cluster"][4096]
        if not rec["launches_by_cluster"][march_c]:
            raise AssertionError(f"{cell}: {name} never ran on clusters of {march_c}, the "
                                 f"rule's size at N=4096: {rec['launches_by_cluster']}")
        out.append(rec)
    # the NFFB encode kernel: its runs in the main path's cells, where it
    # encodes every query of the fused kernel of its precision (in mixed,
    # bf16 the guidance, f32 the decisions)
    enc_rec = {"name": "nffb_encode", "route": "cuda",
               "source": "hashmodnffbanks_idr_tpu_torch/ops/csrc/nffb_encode.cu",
               "replaces": "none (the JAX package leaves NFFBEmbedder.forward to XLA)",
               "launches_by_phase": {p: {v: c[v]["launches"] for v in c if v.startswith("nffb")}
                                     for p, c in phases.items() if "nffb_encode_f32" in c},
               "checks": {k: v for k, v in encode.items() if not k.startswith("nffb_ngp")}}
    for cell, enc_name, mlp in (("exact+fused", "nffb_encode_f32", "fused_sdf_raw_f32"),
                                ("mixed", "nffb_encode_bf16", "fused_sdf_raw_bf16"),
                                ("mixed", "nffb_encode_f32", "fused_sdf_raw_f32")):
        if phases[cell][enc_name]["points"] != phases[cell][mlp]["points"]:
            raise AssertionError(f"{cell}: {enc_name} encoded {phases[cell][enc_name]} points, "
                                 f"{mlp} ran {phases[cell][mlp]}")
        enc_rec[f"points_{cell}_{enc_name}"] = phases[cell][enc_name]["points"]
    out.append(enc_rec)
    # the same kernel on the ngp grid: its runs in the graphed FFB_TCNN mixed
    # step (counts reset just before its timed steps), where its bf16 launches
    # encode every guidance query of the bf16 kernel, its f32 launches the
    # decisions of the f32 kernel, and the torch grid's kernel never runs
    ngp = phases["ffbtcnn mixed"]
    for prec in ("bf16", "f32"):
        enc_name, mlp = f"nffb_ngp_encode_{prec}", f"fused_sdf_raw_{prec}"
        if ngp[enc_name]["points"] != ngp[mlp]["points"]:
            raise AssertionError(f"ffbtcnn mixed: {enc_name} encoded {ngp[enc_name]} points, "
                                 f"{mlp} ran {ngp[mlp]}")
    if not ngp["nffb_ngp_encode_f32"]["launches"] or any(
            ngp[v]["launches"] for v in ("nffb_encode_f32", "nffb_encode_bf16")):
        raise AssertionError(f"ffbtcnn mixed: {ngp}")
    out.append({"name": "nffb_ngp_encode", "route": "cuda",
                "source": "hashmodnffbanks_idr_tpu_torch/ops/csrc/nffb_encode.cu",
                "kernel": "nffb_encode_kernel<NgpGrid, L, W, STYLE, BF16>",
                "replaces": "none (the JAX package leaves NFFBEmbedder.forward on the ngp "
                            "grid to XLA)",
                "launches": {v: ngp[v]["launches"]
                             for v in ("nffb_ngp_encode_f32", "nffb_ngp_encode_bf16")},
                "points": {v: ngp[v]["points"]
                           for v in ("nffb_ngp_encode_f32", "nffb_ngp_encode_bf16")},
                "checks": {k: v for k, v in encode.items() if k.startswith("nffb_ngp")}})
    # set_while: its runs in the exact+fused cell (before each while-node
    # and after each body), its check and times per iteration
    out.append({"name": "set_while", "route": "cuda",
                "source": "hashmodnffbanks_idr_tpu_torch/ops/csrc/graph_loops.cu",
                "replaces": "hashmodnffbanks_idr_tpu/models/ray_tracing.py:316",
                "replaces_note": "jax.lax.while_loop (XLA's on-device while, :316 and :333); "
                                 "no Pallas kernel",
                "launches": phases["exact+fused"]["set_while"]["launches"],
                "launches_by_phase": {p: c["set_while"]["launches"]
                                      for p, c in phases.items() if "set_while" in c},
                **set_while})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
