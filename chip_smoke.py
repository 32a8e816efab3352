#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``hashmodnffbanks_idr_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernel from ``hashmodnffbanks_idr_tpu_torch/ops/csrc``
into ``build/``, holds each kernel variant against its plain PyTorch twin at
the flagship widths, checks one small train step on the card against the
same step on the CPU, then drives the flagship StyleModNFFB training step
(2048 rays, 1200x1600 synthetic two-view scene, random weights from a seed)
in four tracer configurations and times it.  Then it runs the user's path:
the port's ``dummy_cli`` writes the dummy scene, ``exp_runner`` trains the
repo's ``dummy_stylemodnffb.conf`` (with the ``mixed`` tracer) for 30 epochs
and resumes it to epoch 32, and a DTU-size scan is decoded through
``SceneDataset``.  Last comes the eval path: the port's ``dtu_shaped``
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
the CPU's).  It fails if ``-Xptxas -v`` reports a spill in either kernel at any
compiled first-layer depth.  Any failed check raises and
the script exits non-zero.  The second-to-last line is the kernels' JSON
record, the last line ``{"ok": true, "device": {...}}``.

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
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit): f32 on the
# CUDA cores, tf32 and bf16 on the tensor cores
from hashmodnffbanks_idr_tpu_torch.utils.profiling import H100_PEAK_BYTES_PER_S as PEAK_BYTES_PER_S
from hashmodnffbanks_idr_tpu_torch.utils.profiling import H100_PEAK_FLOPS as PEAK_FLOPS

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
# each variant's largest call on the main path, where its time is reported;
# it is also timed at the small calls (secant, march), which fill few SMs
TIME_N = {"fused_sdf_raw_f32": 49152, "fused_sdf_raw_bf16": 69632}
TIME_SMALL_N = (2048, 4096)
# each variant's kernel in the ``-Xptxas -v`` report, by its namespace in the
# mangled name (csrc/fused_mlp.cu: f32::, bf16k::)
PTXAS_ENTRY = {"fused_sdf_raw_f32": "3f3216fused_sdf_kernel",
               "fused_sdf_raw_bf16": "5bf16k16fused_sdf_kernel"}
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
    torch's own softplus: the yardstick (the port never calls it)."""
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
    if packed["w_in"].dtype == torch.bfloat16:
        big = want.abs() > 5e-2
        if not bool((torch.sign(got[big]) == torch.sign(want[big])).all()):
            raise AssertionError(f"{name} N={x.shape[0]}{where}: sign disagreement "
                                 "where |sdf|>5e-2")
    return err


@torch.no_grad()
def phase_kernels(dev, fm, model):
    """Each variant against its plain twin at the tracer's batch sizes."""
    net = model.implicit_network
    d_in, hidden = net.dims[0], net.dims[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    records = {}
    for name, dtype, _, peak_key, products in VARIANTS:
        packed = fm.pack_params(net.lin, d_in, hidden, dtype=dtype)
        max_err = 0.0
        for n in CHECK_N:
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            x = net._embed(pts).contiguous()
            max_err = max(max_err, hold_against_plain(fm, name, x, packed))
        timed = []
        for n in TIME_SMALL_N + (TIME_N[name],):
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            x = net._embed(pts).contiguous()
            ms = cuda_ms(lambda: fm.fused_sdf_raw(x, packed))
            plain_ms = cuda_ms(lambda: fm.fused_sdf_raw_plain(x, packed))
            library_ms = cuda_ms(lambda: library_chain(x, packed))
            flops, nbytes = sdf_mlp_cost(n, d_in, hidden, packed["w_in"].element_size())
            t_ops = products * flops / PEAK_FLOPS[peak_key] * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            rec = {"n": n, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "achieved_tflops": flops / (ms * 1e-3) / 1e12}
            if dtype == torch.float32:
                rec["bound_fp32_cores_ms"] = max(flops / PEAK_FLOPS["f32"] * 1e3, t_bytes)
            print(f"[kernel] {name} N={n}: " + json.dumps(rec))
            timed.append(rec)
        records[name] = dict(timed[-1], max_abs_err=max_err, small_calls=timed[:-1])
    fm.reset_launch_counts()
    return records


def phase_reference(dev, fm, conf=None, label="exact+fused"):
    """One small step on the card against the same step on the CPU (plain
    twin), same weights and draws: loss and hit masks agree.  By default the
    flagship in exact+fused; ``conf`` (a 256-ray conf) replaces it."""
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
    print(f"[reference] {n_rays} rays {label}: loss cuda={l_gpu:.6f} cpu={l_cpu:.6f} "
          f"hits cuda={int(m_gpu.sum())} cpu={int(m_cpu.sum())} mask agreement={agree:.4f} "
          f"(cuda launches {fm.launch_counts['fused_sdf_raw_f32']['launches']} f32, "
          f"{fm.launch_counts['fused_sdf_raw_bf16']['launches']} bf16)")
    if not (math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)):
        raise AssertionError(f"loss on the card {l_gpu} vs CPU {l_cpu}")
    if agree < 0.98:
        raise AssertionError(f"hit masks agree on {agree:.3f} of rays")
    fm.reset_launch_counts()


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
    from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    conf = flagship_conf(num_pixels=N_RAYS) if conf is None else conf
    conf.put("model.tracer_fast", mode)
    conf.put("model.tracer_exact_fused", fused)
    model = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), make_optimizer(model))
    gen = torch.Generator(device=dev).manual_seed(1)
    img_idx = torch.tensor([0], device=dev)
    total = IMG_RES[0] * IMG_RES[1]
    before = [p.detach().clone() for p in model.parameters()]

    for _ in range(warmup):
        step(scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, ALPHA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    times, per_step, losses = [], [], None
    for _ in range(steps):
        seen = {k: v["launches"] for k, v in fm.launch_counts.items()}
        t0 = time.perf_counter()
        losses = step(scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, ALPHA)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: fm.launch_counts[k]["launches"] - seen[k] for k in seen})
    counts = {k: dict(v) for k, v in fm.launch_counts.items()}
    tracer_ms = time_tracer(model, scene, img_idx, sample_pixels(gen, total, N_RAYS), gen)

    loss = float(losses["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{label}: loss {loss}")
    if not any(bool((p.detach() != b).any()) for p, b in zip(model.parameters(), before)):
        raise AssertionError(f"{label}: no parameter changed")
    if expect is not None and not all(s[expect] > 0 for s in per_step):
        raise AssertionError(f"{label}: {expect} was not launched in every step: {per_step}")
    ms = statistics.median(times)
    rec = {"label": label, "steps": steps, "ms_per_step_median": ms,
           "ms_per_step_min": min(times), "ms_per_step_max": max(times),
           "rays_per_s": N_RAYS / (ms * 1e-3), "tracer_ms_median": tracer_ms, "loss": loss,
           "launches_per_step": {k: v["launches"] / steps for k, v in counts.items()},
           "points_per_step": {k: v["points"] / steps for k, v in counts.items()},
           "max_memory_allocated_mib": torch.cuda.max_memory_allocated() / 2**20}
    print(f"[{tag}] {json.dumps(rec)}")
    fm.reset_launch_counts()
    return counts


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
    counts = {k: dict(v) for k, v in fm.launch_counts.items()}

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
    rec = {"card": smi, "epochs": RUNNER_EPOCHS, "steps_per_epoch": first.steps_per_epoch,
           "loss_epoch0": loss0, f"loss_epoch{RUNNER_EPOCHS}": loss30,
           f"loss_epoch{RUNNER_EPOCHS + 2}": loss_end,
           "skill_target_loss_below_0.1_by_epoch_30": loss30 < 0.1,
           "rays_per_s_median_epochs_2_on": rays, "first_run_s": t_first,
           "dummy_scene_decode_ms": decode_ms,
           "bf16_launches_per_epoch": bf16, "bf16_launches": sum(bf16),
           "bf16_points": counts["fused_sdf_raw_bf16"]["points"]}
    print(f"[runner] {json.dumps(rec)}")
    return counts


def phase_decode(smi: str, workdir: str, views: int = 49) -> None:
    """A DTU-size scan (49 views at 1200x1600, image and mask) through
    ``SceneDataset``.  Every row is Paeth-filtered, the slow case of the
    reader: one file of each is written and copied to every view."""
    from hashmodnffbanks_idr_tpu_torch.data.image_io import write_png
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset

    H, W = DTU_RES
    scan = os.path.join(workdir, "dtu", "scan0")
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(scan, sub))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    shade = 128 + 60 * np.sin(xx / 97.0)[..., None] * np.cos(yy / 61.0)[..., None]
    img = np.clip(shade + rng.normal(0, 12, (H, W, 3)), 0, 255).astype(np.uint8)
    mask = (((xx - W / 2) ** 2 + (yy - H / 2) ** 2) < (H / 3) ** 2).astype(np.uint8) * 255
    write_png(os.path.join(scan, "image", "000.png"), img, filters=4)
    write_png(os.path.join(scan, "mask", "000.png"), mask, filters=4)
    wm = np.eye(4)  # K [I | t]: a camera 2.5 in front of the origin
    wm[:3, :3] = [[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]]
    wm[:3, 3] = wm[:3, :3] @ [0.0, 0.0, 2.5]
    np.savez(os.path.join(scan, "cameras.npz"),
             **{f"{m}_{i}": a for i in range(views)
                for m, a in (("world_mat", wm), ("scale_mat", np.eye(4)))})
    for i in range(1, views):
        for sub in ("image", "mask"):
            shutil.copyfile(os.path.join(scan, sub, "000.png"),
                            os.path.join(scan, sub, f"{i:03d}.png"))
    t0 = time.perf_counter()
    ds = SceneDataset(False, "dtu", DTU_RES, 0, data_root=workdir)
    dt = time.perf_counter() - t0
    if not (np.array_equal(ds.rgb_images[-1], img.reshape(-1, 3))
            and np.array_equal(ds.object_masks[-1], mask.reshape(-1) > 127)):
        raise AssertionError("decode: the scan's pixels differ from those written")
    print(f"[decode] {json.dumps({'card': smi, 'views': views, 'res': list(DTU_RES), 'filters': 'paeth', 'scan_s': dt, 'per_view_ms': dt / views * 1e3})}")


@contextlib.contextmanager
def keep_largest_call(fm, kept: dict):
    """While open, ``fm.fused_sdf_raw`` keeps in ``kept[variant]`` a copy of
    the largest input it was given, with its weights, then launches as
    always; the launch counts are the wrapper's own."""
    launch = fm.fused_sdf_raw
    variant = {dtype: name for name, dtype, *_ in VARIANTS}

    def keeping(x, packed):
        name = variant[packed["w_in"].dtype]
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
        seen = {k: dict(v) for k, v in fm.launch_counts.items()}
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
            "launches": {k: fm.launch_counts[k]["launches"] - seen[k]["launches"] for k in seen},
            "points": {k: fm.launch_counts[k]["points"] - seen[k]["points"] for k in seen}}
        if kernel is not None and renders[label]["launches"][kernel] <= 0:
            raise AssertionError(f"eval render {label}: {kernel} was not launched")
    counts = {k: dict(v) for k, v in fm.launch_counts.items()}
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
    launches = {k: dict(c) for k, c in fm.launch_counts.items()}
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
    counts = {k: dict(v) for k, v in fm.launch_counts.items()}
    for name, c in step_launches.items():
        for k in ("launches", "points"):
            counts[name][k] += c[k]

    # the first run takes epochs 0..CAM_EPOCHS and saves its end as epoch
    # CAM_EPOCHS, which the resumed run takes again (then two more)
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
           "bf16_launches_per_epoch": bf16, "cam_opt_step_saved": int(saved["cam_opt"]["step"]),
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


def kernel_record(fm, name, x, packed, where=""):
    """One variant on one input: held against its plain twin, then timed
    beside the plain twin and the cuBLAS chain, with its bound."""
    products, peak_key = {n: (p, k) for n, _, _, k, p in VARIANTS}[name]
    err = hold_against_plain(fm, name, x, packed, where)
    n, d_in = x.shape
    hidden = packed["w_in"].shape[1]
    ms = cuda_ms(lambda: fm.fused_sdf_raw(x, packed))
    plain_ms = cuda_ms(lambda: fm.fused_sdf_raw_plain(x, packed))
    library_ms = cuda_ms(lambda: library_chain(x, packed))
    flops, nbytes = sdf_mlp_cost(n, d_in, hidden, packed["w_in"].element_size())
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
    column counts.  Launches made here are comparisons and are not counted."""
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
            rec["max_abs_err_spread"] = hold_against_plain(
                fm, name, x, fm.pack_params(net.lin, d_in, net.dims[1], dtype=dtype),
                f" d_in={d_in} ({embed_type}, input weights spread)")
            rec["max_abs_err"] = max(rec["max_abs_err"], rec["max_abs_err_spread"])
            print(f"[ngp] kernel {name} {embed_type}: {json.dumps(rec)}")
            records[name].append(rec)
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
    every epoch."""
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
        counts[conf_name] = {k: dict(v) for k, v in fm.launch_counts.items()}
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
               "bf16_points": counts[conf_name]["fused_sdf_raw_bf16"]["points"]}
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
    """Each kernel, at every compiled first-layer depth, must keep its 128
    float accumulators and its fragments in registers: no spills in the
    ``-Xptxas -v`` report.  Returns each variant's registers a thread and
    spill bytes (stores + loads) by depth."""
    out = {}
    for name, mangled in PTXAS_ENTRY.items():
        out[name] = {}
        for k0 in depths:
            entries = [e for e in ptxas_log.split("Compiling entry function")[1:]
                       if f"{mangled}ILi{k0}E" in e]
            if len(entries) != 1:
                raise AssertionError(f"ptxas report: {len(entries)} entries of {name} K0={k0}")
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                                 entries[0])]
            regs = re.search(r"Used (\d+) registers", entries[0])
            print(f"[ptxas] {name} K0={k0}: {regs.group(1) if regs else '?'} registers, "
                  f"spill stores/loads {spills} bytes")
            if len(spills) != 2 or any(spills) or regs is None:
                raise AssertionError(f"{name} K0={k0} spills registers: {entries[0].strip()}")
            out[name][k0] = {"registers": int(regs.group(1)), "spill_bytes": sum(spills)}
    return out


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

    t0 = time.perf_counter()
    fm.load_library()
    print(f"[build] fused_mlp.cu built and loaded in {time.perf_counter() - t0:.1f} s")
    report = fm.ptxas_report().read_text()
    print(report.strip())
    regs = check_spills(report, fm.KERNEL_DEPTHS)

    model = IDRNetwork(flagship_conf(num_pixels=N_RAYS).get_config("model"), device=dev, seed=0)
    kernels = phase_kernels(dev, fm, model)
    del model
    depth_records = phase_depths(dev, fm)
    phase_reference(dev, fm)
    ngp_ref = ngp_conf("ngp_log2_15", num_pixels=256)
    ngp_ref.put("model.tracer_exact_fused", False)
    phase_reference(dev, fm, conf=ngp_ref, label="ngp log2=15 exact (unfused)")

    scene = scene_to_device(synthetic_scene(n_views=2, img_res=IMG_RES, seed=0), dev)
    phases = {
        "exact+fused": phase_step(dev, fm, scene, "exact+fused", "exact", True, 2, 10,
                                  expect="fused_sdf_raw_f32"),
        "mixed": phase_step(dev, fm, scene, "mixed", "mixed", False, 2, 10,
                            expect="fused_sdf_raw_bf16"),
        "fast": phase_step(dev, fm, scene, "fast", "fast", False, 2, 10,
                           expect="fused_sdf_raw_bf16"),
        "exact (unfused)": phase_step(dev, fm, scene, "exact (unfused)", "exact", False, 1, 3),
    }
    ngp_counts, ngp_largest = phase_ngp_steps(dev, fm, scene)
    phases.update(ngp_counts)
    del scene
    with tempfile.TemporaryDirectory() as workdir:
        phases["runner"] = phase_runner(fm, smi, workdir)
        phase_decode(smi, workdir)
        phases["eval"], eval_largest = phase_eval(fm, smi, workdir)
        phases["cameras"] = phase_cameras(dev, fm, smi, workdir, os.path.join(workdir, "data"))
        phases.update(phase_ngp_runner(fm, smi, workdir, os.path.join(workdir, "data")))

    src = "hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu"
    out = []
    # launches and points: each kernel's run in its first main-path cell
    for name, cell in (("fused_sdf_raw_f32", "exact+fused"), ("fused_sdf_raw_bf16", "mixed")):
        r = kernels[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": "hashmodnffbanks_idr_tpu/ops/fused_mlp.py:104",
               "launches": phases[cell][name]["launches"], "points": phases[cell][name]["points"],
               "launches_by_phase": {p: c[name]["launches"] for p, c in phases.items()}}
        rec.update((k, r[k]) for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_fp32_cores_ms", "bound_by", "library_ms",
                                        "n", "small_calls") if k in r)
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
        out.append(rec)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
