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
``SceneDataset``.  It fails if ``-Xptxas -v``
reports a spill in either kernel.  Any failed check raises and
the script exits non-zero.  The second-to-last line is the kernels' JSON
record, the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package, and exits non-zero
without a result when CUDA is unavailable.
"""

from __future__ import annotations

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
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
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
def phase_kernels(dev, fm, model):
    """Each variant against its plain twin at the tracer's batch sizes."""
    net = model.implicit_network
    d_in, hidden = net.dims[0], net.dims[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    records = {}
    for name, dtype, tol, peak_key, products in VARIANTS:
        packed = fm.pack_params(net.lin, d_in, hidden, dtype=dtype)
        max_err = 0.0
        for n in CHECK_N:
            pts = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * 0.6
            x = net._embed(pts).contiguous()
            got = fm.fused_sdf_raw(x, packed)
            want = fm.fused_sdf_raw_plain(x, packed)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"[kernel] {name} N={n}: max_abs_err={err:.3e} (tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"{name} N={n}: max abs err {err} > {tol}")
            if dtype == torch.bfloat16:
                big = want.abs() > 5e-2
                if not bool((torch.sign(got[big]) == torch.sign(want[big])).all()):
                    raise AssertionError(f"{name} N={n}: sign disagreement where |sdf|>5e-2")
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


def phase_reference(dev, fm):
    """One small exact+fused step on the card against the same step on the
    CPU (plain twin), same weights and draws: loss and hit masks agree."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, scene_to_device,
                                                       synthetic_scene)
    from hashmodnffbanks_idr_tpu_torch.train.trainer import loss_fn

    n_rays = 256
    conf = flagship_conf(num_pixels=n_rays)
    conf.put("model.tracer_exact_fused", True)
    scene_np = synthetic_scene(n_views=2, img_res=(64, 64), seed=0)
    g = torch.Generator().manual_seed(5)
    pix = torch.randperm(64 * 64, generator=g)[:n_rays]
    outs = {}
    for device in (dev, torch.device("cpu")):
        model = IDRNetwork(conf.get_config("model"), device=device, seed=0)
        cfg = model.ray_tracer
        stride = sweep_stride(cfg, False, on_cuda=device.type == "cuda")
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
    print(f"[reference] {n_rays} rays exact+fused: loss cuda={l_gpu:.6f} cpu={l_cpu:.6f} "
          f"hits cuda={int(m_gpu.sum())} cpu={int(m_cpu.sum())} mask agreement={agree:.4f} "
          f"(cuda launches {fm.launch_counts['fused_sdf_raw_f32']['launches']})")
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


def phase_step(dev, fm, scene, label, mode, fused, warmup, steps, expect=None):
    """The flagship training step through the port's entry points; counts
    reset just before the timed steps and read just after."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf
    from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    conf = flagship_conf(num_pixels=N_RAYS)
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
    print(f"[step] {json.dumps(rec)}")
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


def check_spills(ptxas_log: str) -> dict:
    """Each kernel must keep its 128 float accumulators and its fragments in
    registers: no spills in the ``-Xptxas -v`` report.  Returns each
    variant's registers a thread and spill bytes (stores + loads)."""
    out = {}
    for name, mangled in PTXAS_ENTRY.items():
        entries = [e for e in ptxas_log.split("Compiling entry function")[1:] if mangled in e]
        if len(entries) != 1:
            raise AssertionError(f"ptxas report: {len(entries)} entries of {name}")
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", entries[0])]
        regs = re.search(r"Used (\d+) registers", entries[0])
        print(f"[ptxas] {name}: {regs.group(1) if regs else '?'} registers, "
              f"spill stores/loads {spills} bytes")
        if len(spills) != 2 or any(spills) or regs is None:
            raise AssertionError(f"{name} spills registers: {entries[0].strip()}")
        out[name] = {"registers": int(regs.group(1)), "spill_bytes": sum(spills)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2

    from hashmodnffbanks_idr_tpu_torch import resolve_device
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, scene_to_device,
                                                       synthetic_scene)

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
    regs = check_spills(report)

    model = IDRNetwork(flagship_conf(num_pixels=N_RAYS).get_config("model"), device=dev, seed=0)
    kernels = phase_kernels(dev, fm, model)
    del model
    phase_reference(dev, fm)

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
    del scene
    with tempfile.TemporaryDirectory() as workdir:
        phases["runner"] = phase_runner(fm, smi, workdir)
        phase_decode(smi, workdir)

    src = "hashmodnffbanks_idr_tpu_torch/ops/csrc/fused_mlp.cu"
    out = []
    # launches and points: each kernel's run in its first main-path cell
    for name, cell in (("fused_sdf_raw_f32", "exact+fused"), ("fused_sdf_raw_bf16", "mixed")):
        r = kernels[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": "hashmodnffbanks_idr_tpu/ops/fused_mlp.py:104",
               "launches": phases[cell][name]["launches"], "points": phases[cell][name]["points"],
               "launches_by_phase": {p: c[name]["launches"] for p, c in phases.items()}}
        rec.update((k, r[k]) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_fp32_cores_ms", "bound_by", "library_ms",
                                        "n", "small_calls") if k in r)
        rec.update(regs[name])
        out.append(rec)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
