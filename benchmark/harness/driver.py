"""One run of a cell: set-up, the measured window, the traced segment, and
the comparison with the plain reference.

The window drives the port's graphed train step
(``train/trainer.py:build_train_step``) as ``IDRTrainRunner.run`` drives it:
each epoch draws one pixel subset on the device and a view order on the
host, each step sets the learning rate and trains one view's rays, each
epoch ends in one host read of the losses and of the skipped steps.  The
conf's LR and alpha schedules are followed as the runner follows them.  The
weights and every draw come from the seed and are made here, so the
reference is handed the same ones.

Set-up builds the step once and drives it through its first three steps
(the first captures the CUDA graph), keeping their inputs, the losses, the
first gradient as the program's Adam state holds it, the first step's
per-ray outputs (kept by a forward hook on the program's model, so read
from the graph's own buffers) and the parameters after the third; the
window continues with the same object.  Once the window has closed (and,
with ``trace``, a profiled segment after it), the program's state is freed
and the reference trains the same three steps."""

from __future__ import annotations

import gc
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from reference import step as ref_step
from reference.renderer import IDRNetwork as RefNetwork
from reference.support import Config as RefConfig

from . import check, stats
from .scene import build_scene
from .spec import Cell, metric_reader
from .trace import TraceReading, read_profile

CHECKED_STEPS = 3
TRACE_WARM_STEPS = 2      # a first profile of the graph loses kernel records
TRACE_STEPS = 12
BETA1 = 0.9


@dataclass
class Counters:
    """What the program counts over a stretch of steps: loop iterations by
    loop and fused-kernel launches and points by variant."""
    steps: int
    loop_iterations: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, Dict[str, float]] = field(default_factory=dict)


@dataclass
class MetricContext:
    """What a per-layer metric's reader is given."""
    conf: Dict
    rays: int
    d_in: int                     # the SDF MLP's embedded input width
    feature_vector_size: int
    rendering_dims: List[int]
    window_s: float
    window: Counters
    traced: Optional[TraceReading]
    traced_counts: Optional[Counters]


def _snapshot(fm, graphs):
    return (fm.snapshot_launch_counts(), dict(graphs.loop_iterations))


def _since(fm, graphs, before, steps: int) -> Counters:
    launched, loops = before
    now = fm.launch_counts_since(launched)
    return Counters(steps=steps,
                    loop_iterations={k: v - loops.get(k, 0)
                                     for k, v in graphs.loop_iterations.items()},
                    launches={k: {"launches": c["launches"], "points": c["points"]}
                              for k, c in now.items()})


class Feed:
    """The runner's inputs, drawn from the seed: per epoch a pixel subset
    (device generator) and a view order (host generator), per step the
    learning rate, alpha and the forward's uniform draws."""

    def __init__(self, conf: Dict, scene: Dict[str, torch.Tensor], draw_model: RefNetwork,
                 seed: int, rays: int, device):
        train = conf["train"]
        self.scene, self.draw_model, self.rays = scene, draw_model, rays
        self.n_views = scene["rgb"].shape[0]
        self.total_pixels = scene["uv"].shape[0]
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.order_gen = torch.Generator().manual_seed(seed + 2)
        self.device = device
        self.lr = float(train["learning_rate"])
        self.sched_factor = float(train.get("sched_factor", 0.0))
        self.milestone_steps = [int(m) * self.n_views for m in train.get("sched_milestones", [])]
        self.alpha0 = float(conf["loss"]["alpha"])
        self.alpha_milestones = [int(m) for m in train.get("alpha_milestones", [])]
        self.alpha_factor = float(train.get("alpha_factor", 0.0))
        self.epoch, self.i, self.count = 0, 0, 0
        self._new_epoch()

    def _new_epoch(self):
        self.pixel_idx = torch.randperm(self.total_pixels, generator=self.gen,
                                        device=self.device)[:self.rays]
        self.order = torch.randperm(self.n_views, generator=self.order_gen).to(self.device)
        self.alpha = self.alpha0 * self.alpha_factor ** sum(
            self.epoch >= m for m in self.alpha_milestones)

    def next(self) -> Dict:
        """The next step's inputs; ``epoch_end`` marks an epoch's last step."""
        lr = self.lr * self.sched_factor ** sum(self.count >= m for m in self.milestone_steps)
        inp = {"img_idx": self.order[self.i:self.i + 1], "pixel_idx": self.pixel_idx,
               "alpha": self.alpha, "lr": lr,
               "draws": ref_step.make_draws(self.draw_model, self.gen, self.rays),
               "epoch_end": self.i == self.n_views - 1}
        self.count += 1
        self.i += 1
        if self.i == self.n_views:
            self.epoch, self.i = self.epoch + 1, 0
            self._new_epoch()
        return inp


class Program:
    """The system under test: the port's model with the run's weights, its
    Adam and its train step (graphed on the card)."""

    def __init__(self, conf: Dict, weights: Dict[str, torch.Tensor], device):
        from hashmodnffbanks_idr_tpu_torch.config.hocon import Config
        from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
        from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
        from hashmodnffbanks_idr_tpu_torch.train import trainer

        lc = conf["loss"]
        self.model = IDRNetwork(Config(conf["model"]), device=device, seed=0)
        self.model.load_state_dict(weights)
        self.optimizer = trainer.make_optimizer(self.model, lr=float(conf["train"]["learning_rate"]))
        self.loss_cfg = IDRLossConfig(eikonal_weight=lc["eikonal_weight"],
                                      mask_weight=lc["mask_weight"], alpha=lc["alpha"],
                                      tv_weight=float(lc.get("tv_weight", 0.0)))
        self.step = trainer.build_train_step(self.model, self.loss_cfg, self.optimizer)
        self._set_lr = trainer.set_lr
        # the step's per-ray outputs, kept by reference: on the card the
        # tensors of the captured forward, which every replay writes again
        self._rays: Dict[str, torch.Tensor] = {}
        self.model.register_forward_hook(self._keep_rays)

    def _keep_rays(self, module, args, out) -> None:
        self._rays = {k: out[k].detach() for k in ref_step.RAY_OUTPUTS}

    def __call__(self, scene, inp) -> Dict[str, torch.Tensor]:
        self._set_lr(self.optimizer, inp["lr"])
        return self.step(scene, inp["img_idx"], inp["pixel_idx"], None, inp["alpha"],
                         draws=inp["draws"])

    def skipped(self) -> int:
        return int(self.step.skipped)

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """The first step's gradient as Adam got it, from its first moment
        after one step."""
        return {n: self.optimizer.state[p]["exp_avg"].detach() / (1 - BETA1)
                for n, p in self.model.named_parameters() if self.optimizer.state.get(p)}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def rays(self) -> Dict[str, torch.Tensor]:
        """The last step's per-ray outputs (``ref_step.RAY_OUTPUTS``)."""
        return {k: v.clone() for k, v in self._rays.items()}


class Clock:
    """Per-step completion times: CUDA events recorded after each launch on
    the card (no synchronise per step), the host's clock after each step on
    the CPU (where a step returns when it is done)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def times_ms(self) -> List[float]:
        if self.cuda:
            return [self.marks[0].elapsed_time(e) for e in self.marks]
        return [(t - self.marks[0]) * 1e3 for t in self.marks]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Started:
    """A program driven through its first steps, with what the comparison
    needs of them."""
    program: Program
    run_step: Callable
    feed: Feed
    weights: Dict[str, torch.Tensor]
    checked: List[Dict]           # the inputs of the checked steps
    prog: Dict                    # their losses, first gradient and per-ray
                                  # outputs, the parameters after
    d_in: int
    feature_vector_size: int
    rendering_dims: List[int]


def start(cell: Cell, scene: Dict[str, torch.Tensor], seed: int, device,
          wrap_program: Optional[Callable] = None) -> Started:
    """The weights and the feed from ``seed``, the program built once and
    driven through its first ``CHECKED_STEPS`` steps (the first captures the
    step's graph on the card).  ``wrap_program`` (tests) wraps the program's
    step, to plant a fault under the harness."""
    conf = cell.conf
    rays = int(cell.traffic["rays_per_step"])
    marks = [time.perf_counter()]
    draw_model = RefNetwork(RefConfig(conf["model"]), device=device, seed=seed)
    weights = {k: v.detach().clone() for k, v in draw_model.state_dict().items()}
    for p in draw_model.parameters():
        p.requires_grad_(False)
    feed = Feed(conf, scene, draw_model, seed, rays, device)
    marks.append(time.perf_counter())
    program = Program(conf, weights, device)
    run_step = wrap_program(program) if wrap_program else program
    marks.append(time.perf_counter())
    checked, losses, grad1, rays1 = [], [], None, None
    for k in range(CHECKED_STEPS):
        inp = feed.next()
        checked.append({k2: v for k2, v in inp.items() if k2 != "epoch_end"})
        losses.append(run_step(scene, inp))
        if k == 0:
            grad1, rays1 = program.first_gradient(), program.rays()
        marks.append(time.perf_counter())
    print(f"[start] weights and feed {marks[1] - marks[0]:.3f} s, program built "
          f"{marks[2] - marks[1]:.3f}, steps {[round(b - a, 3) for a, b in zip(marks[2:], marks[3:])]}",
          file=sys.stderr, flush=True)
    prog = {"losses": [{k: float(v) for k, v in t.items()} for t in losses], "grad1": grad1,
            "params": program.parameters(), "rays1": rays1}
    return Started(program=program, run_step=run_step, feed=feed, weights=weights,
                   checked=checked, prog=prog, d_in=draw_model.implicit_network.dims[0],
                   feature_vector_size=draw_model.feature_vector_size,
                   rendering_dims=list(draw_model.rendering_network.dims))


def free(device) -> None:
    """Return what the dropped program held to the device."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, root: Path, seed: int, seconds: float, trace: bool, device,
             t_start: float, wrap_program: Optional[Callable] = None, log=sys.stderr) -> Dict:
    """One run; returns the result line's object (``check`` last)."""
    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
    from hashmodnffbanks_idr_tpu_torch.utils import graphs

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    conf = cell.conf
    rays = int(cell.traffic["rays_per_step"])

    # set-up: the scene, the weights, the program, its first steps; the
    # memory peak is the training's (the scene resident, not its render's
    # transients)
    t_scene = time.perf_counter()
    scene = build_scene(cell.traffic, device)
    sync(device)
    t_program = time.perf_counter()
    if trace:
        start_profiler(device)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    st = start(cell, scene, seed, device, wrap_program)
    program, run_step, feed = st.program, st.run_step, st.feed
    skipped0 = program.skipped()
    sync(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    print(f"[setup] {setup_s:.3f} s: imports and context {t_scene - t_start:.3f}, scene "
          f"{tuple(scene['rgb'].shape)} {t_program - t_scene:.3f}, program and its first "
          f"{CHECKED_STEPS} steps {t_end - t_program:.3f} (capture "
          f"{getattr(program.step, 'capture_s', 0.0):.3f})", file=log, flush=True)

    # the window
    before = _snapshot(fm, graphs)
    clock = Clock(device)
    t0 = time.perf_counter()
    clock.mark()
    n, losses, host_s, launched_s = 0, None, [], []
    while time.perf_counter() - t0 < seconds:
        th = time.perf_counter()
        launched_s.append(th - t0)
        inp = feed.next()
        losses = run_step(scene, inp)
        clock.mark()
        host_s.append(time.perf_counter() - th)
        n += 1
        if inp["epoch_end"]:   # the runner's one host read an epoch
            torch.stack(list(losses.values())).tolist()
            program.skipped()
    sync(device)
    window_s = time.perf_counter() - t0
    window = _since(fm, graphs, before, n)
    failed = program.skipped() - skipped0
    step_ms = stats.step_times_ms(clock.times_ms())
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "train_rays_per_s":
                metrics[m["name"]] = {"value": stats.rate(rays * n, window_s), "unit": m["unit"]}
            elif m["name"] == "step_ms_p95":
                metrics[m["name"]] = {"value": stats.p95(step_ms), "unit": m["unit"]}
            elif m["name"] == "setup_s":
                metrics[m["name"]] = {"value": setup_s, "unit": m["unit"]}
    q = statistics.quantiles(step_ms, n=4) if len(step_ms) > 1 else step_ms * 3
    print(f"[window] {n} steps in {window_s:.3f} s, step ms quartiles "
          f"{[round(v, 3) for v in q]} max {max(step_ms):.3f}; loop iterations a step "
          f"{ {k: v / max(n, 1) for k, v in window.loop_iterations.items()} }; host ms a "
          f"launch median {1e3 * statistics.median(host_s):.3f} max {1e3 * max(host_s):.3f}; "
          f"skipped {failed}",
          file=log, flush=True)
    _log_steadiness(clock.times_ms(), launched_s, rays, feed.n_views, device, log)

    traced, traced_counts, breakdown = None, None, None
    if trace:
        traced, traced_counts = _traced_segment(run_step, feed, scene, device, fm, graphs, log)
        if traced is not None:
            breakdown = {"device_ops": [[k, v] for k, v in traced.top_ops(10)],
                         "idle_gaps": [[k, v] for k, v in traced.idle_gaps]}
        ctx = MetricContext(conf=conf, rays=rays, d_in=st.d_in,
                            feature_vector_size=st.feature_vector_size,
                            rendering_dims=st.rendering_dims,
                            window_s=window_s, window=window,
                            traced=traced, traced_counts=traced_counts)
        for m in cell.per_layer:
            value = metric_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    # the program's state freed, then the reference on the same three steps
    del program, run_step, losses, st.program, st.run_step
    free(device)
    t_ref = time.perf_counter()
    ref = ref_step.run_steps(conf, scene, st.weights, st.checked)
    numbers = check.gaps(st.prog, ref, st.weights)
    correct = check.verdict(numbers, cell.limits)
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s; losses, program "
          f"{[t['loss'] for t in st.prog['losses']]}, reference "
          f"{[t['loss'] for t in ref['losses']]}; readings {numbers}", file=log, flush=True)
    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers.get(k), "limit": v} for k, v in cell.limits.items()}
    return result


SHORTER_WINDOWS_S = (10.0, 30.0)


def _log_steadiness(event_ms: List[float], launched_s: List[float], rays: int, n_views: int,
                    device, log) -> None:
    """What the window's spread comes from, on standard error: the rate and
    p95 that windows of ``SHORTER_WINDOWS_S`` seconds would have read (the
    steps launched within them, up to the device's end of the last), the
    median step of each epoch, and the allocator's state."""
    step_ms = stats.step_times_ms(event_ms)
    shorter = []
    for w in SHORTER_WINDOWS_S:
        k = sum(t < w for t in launched_s)
        if 0 < k < len(launched_s):
            shorter.append(f"{w:g} s: {stats.rate(rays * k, event_ms[k] / 1e3):.1f} rays/s, "
                           f"p95 {stats.p95(step_ms[:k]):.3f} ms")
    epochs = [round(statistics.median(step_ms[i:i + n_views]), 2)
              for i in range(0, len(step_ms), n_views)]
    memory = ""
    if torch.device(device).type == "cuda":
        ms = torch.cuda.memory_stats(device)
        memory = (f"; allocator reserved {torch.cuda.memory_reserved(device)} B in "
                  f"{ms.get('segment.all.current', 0)} segments, "
                  f"{ms.get('num_alloc_retries', 0)} retries")
    print(f"[steadiness] {'; '.join(shorter) or 'no shorter window'}; median step ms by "
          f"epoch {epochs}{memory}", file=log, flush=True)


FUSED_KERNELS = {"fused_sdf_raw_f32": r"\bf32::fused_sdf_kernel<",
                 "fused_sdf_raw_bf16": r"\bbf16k::fused_sdf_kernel<"}
TRACE_TRIES = 3


def trace_is_whole(traced: TraceReading, counts: Counters) -> bool:
    """Whether the trace holds every launch of the fused kernels that the
    program counted over the same steps (kernels inside the graph's
    while-nodes are the ones a trace can lose)."""
    return all(traced.kernel_launches(pattern) == counts.launches.get(variant, {}).get("launches", 0)
               for variant, pattern in FUSED_KERNELS.items())


def start_profiler(device) -> None:
    """One empty profile before the step is captured: the profiler's
    device tracing has to be up when the graph is instantiated, or the
    kernels its while-nodes launch are missing from later traces."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type == "cuda":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)


def _traced_segment(run_step, feed, scene, device, fm, graphs, log):
    """The steps after the window under ``torch.profiler``: a short profile
    first, dropped, then ``TRACE_STEPS`` steps kept; a stretch whose trace
    lost a fused-kernel launch (``trace_is_whole``) is traced again,
    ``TRACE_TRIES`` times at most, and then given up (None).  The stretch is
    short because a trace holds 10-15 thousand kernels a step; the
    epoch's host read, when one falls in it, idles the device for about a
    millisecond (the host queues several steps ahead)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def steps(k):
        for _ in range(k):
            inp = feed.next()
            losses = run_step(scene, inp)
            if inp["epoch_end"]:
                torch.stack(list(losses.values())).tolist()
        sync(device)

    with profile(activities=activities):
        steps(TRACE_WARM_STEPS)
    for attempt in range(TRACE_TRIES):
        before = _snapshot(fm, graphs)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            steps(TRACE_STEPS)
            window_s = time.perf_counter() - t0
        counts = _since(fm, graphs, before, TRACE_STEPS)
        traced = read_profile(prof, TRACE_STEPS, window_s)
        whole = trace_is_whole(traced, counts)
        print(f"[trace] try {attempt + 1}: {traced.kernel_count} kernels, fused launches "
              f"{ {v: traced.kernel_launches(p) for v, p in FUSED_KERNELS.items()} } traced, "
              f"{ {v: c['launches'] for v, c in counts.launches.items()} } counted; "
              f"whole {whole}", file=log, flush=True)
        if whole:
            return traced, counts
    return None, None
