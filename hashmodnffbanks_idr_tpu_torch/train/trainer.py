"""The training step and the training runner.

Counterpart of ``hashmodnffbanks_idr_tpu/train/trainer.py``.  The step is
pixel gather -> render -> IDR loss -> clipped Adam: the network's gradient
is clipped to a global norm of 1.0 exactly as ``optax.clip_by_global_norm``
does (idr_train.py:306), then a ``torch.optim.Adam`` step is taken (its
update is algebraically optax's); a step whose gradient is not finite
takes no update.  With trainable cameras the step's poses
are rows of a (V, 7) quaternion+translation table; its gradient is not
clipped (JAX's optax chain holds the network alone) and goes to a SparseAdam
kept on the device (idr_train.py:134-139).

On the card the one-device step runs as one device program a step, as JAX's
jitted step does (JAX :152): ``GraphedTrainStep`` captures it once and
launches it as one CUDA graph, the tracer's loops conditional while-nodes
(``utils/graphs.py``), with no host read inside; the finite-update guard
is a mask on the device.  The eager
step (``build_train_step(graphed=False)``) stays for comparisons; the CPU
runs it by default.

``IDRTrainRunner`` keeps the JAX runner's semantics (JAX :159-419): run
directories, one pixel subset per epoch, checkpoints every 25 epochs and at
the end, MultiStep LR on the optimizer's step count, per-epoch alpha
annealing, JSONL scalars, and every ``plot_freq`` epochs (never at epoch 0)
the plots of ``eval/plots.py:plot_epoch``; with ``train_cameras`` the pose
table starts from ``SceneDataset.get_pose_init`` and travels in the
checkpoint with its optimizer state.  Under a ``mesh`` it runs the sharded
step on every rank; rank 0 alone writes the run directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import traceback
from datetime import datetime
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config.hocon import Config, parse_file
from ..data.scene_dataset import SceneDataset, rgb_to_pm1
from ..models.loss import IDRLossConfig, idr_loss
from ..models.renderer import IDRNetwork
from ..ops import fused_mlp as fm
from ..utils import graphs, profiling
from ..utils.compile_cache import build_once, enable_compile_cache
from ..utils.logging import ScalarLogger
from ..utils.sampling import sample_pixels
from . import checkpoints as ckpt
from .schedule import annealed_alpha

MAX_GRAD_NORM = 1.0  # idr_train.py:306
CHECKPOINT_EVERY = 25  # epochs (JAX :311)


def make_optimizer(model: IDRNetwork, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8).  On the card
    it is ``capturable`` with its learning rate a device tensor, so that a
    CUDA graph can replay its step; ``set_lr`` changes the rate in place."""
    params = list(model.parameters())
    dev = params[0].device
    if dev.type == "cuda":
        return torch.optim.Adam(params, lr=torch.tensor(lr, dtype=torch.float32, device=dev),
                                betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate: a tensor rate in place (its address
    is in the graphed step's graphs), a float rate by assignment."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``max_norm / ||g||`` when ``||g|| >= max_norm``,
    as ``optax.clip_by_global_norm`` does (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def update_is_finite(step: Callable, g_norm: torch.Tensor,
                     pose_vecs: Optional[torch.Tensor],
                     losses: Dict[str, torch.Tensor]) -> bool:
    """Whether a step's update may be taken: the global norm of the
    network's gradient and the camera gradient are finite (one host read).
    If not, the update is skipped, as ``optax.apply_if_finite`` skips it:
    the parameters and the optimizers' states stay as they were, so that
    one non-finite step cannot turn every parameter into NaN.  The skip is
    counted in ``step.skipped`` and reported with the step's loss terms
    (a non-finite term means the forward failed, finite terms the
    backward)."""
    ok = torch.isfinite(g_norm)
    if pose_vecs is not None and pose_vecs.grad is not None:
        ok = ok & torch.isfinite(pose_vecs.grad).all()
    if bool(ok):
        return True
    step.skipped += 1
    terms = {k: float(v) for k, v in losses.items()}
    print(f"[train step] non-finite gradient (global norm {float(g_norm)}): update skipped "
          f"({step.skipped} so far); loss terms {terms}")
    return False


def sparse_adam_init(pose_vecs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """SparseAdam state of a (V, 7) pose table: moments and the global step
    count, on the table's device (JAX :50-55)."""
    return {"m": torch.zeros_like(pose_vecs),
            "v": torch.zeros_like(pose_vecs),
            "step": torch.zeros((), dtype=torch.int32, device=pose_vecs.device)}


@torch.no_grad()
def sparse_adam_update(pose_vecs: torch.Tensor, grads: torch.Tensor,
                       state: Dict[str, torch.Tensor], touched_rows: torch.Tensor,
                       lr: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8) -> None:
    """``torch.optim.SparseAdam``'s semantics, as the JAX package keeps them
    (JAX :58-75), in place: the moments advance only for the rows in
    ``touched_rows`` (a repeated row counts once, its gradient being the
    sum), the bias-correction step count is global and advances every
    call.  A masked dense update with no host synchronisation: the touched
    mask is built with ``index_fill_``."""
    touched = torch.zeros(pose_vecs.shape[0], dtype=torch.bool, device=pose_vecs.device)
    tcol = touched.index_fill_(0, touched_rows, True)[:, None]
    state["step"].add_(1)
    m = torch.where(tcol, b1 * state["m"] + (1 - b1) * grads, state["m"])
    v = torch.where(tcol, b2 * state["v"] + (1 - b2) * grads ** 2, state["v"])
    state["m"].copy_(m)
    state["v"].copy_(v)
    stepf = state["step"].to(pose_vecs.dtype)
    mhat = m / (1 - torch.pow(b1, stepf))
    vhat = v / (1 - torch.pow(b2, stepf))
    upd = -lr * mhat / (torch.sqrt(vhat) + eps)
    pose_vecs.add_(torch.where(tcol, upd, torch.zeros_like(upd)))


def loss_fn(model: IDRNetwork, loss_cfg: IDRLossConfig, scene: Dict[str, torch.Tensor],
            img_idx: torch.Tensor, pixel_idx: torch.Tensor,
            generator: Optional[torch.Generator], alpha: Union[float, torch.Tensor],
            draws: Optional[Dict[str, torch.Tensor]] = None,
            pose_vecs: Optional[torch.Tensor] = None,
            n_rays: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Gather the step's pixels from the device-resident scene, render them
    and return the loss terms (JAX :94-126).  With ``pose_vecs`` (trainable
    cameras) the poses are its rows ``img_idx``, (B, 7), else the scene's
    (B, 4, 4).  With ``loss_cfg.tv_weight > 0`` and a grid encoder, the
    grid's total variation at the traced points (gradient-stopped: the
    points select cells, the gradient goes to the table) is added as
    ``tv_loss``.  ``n_rays`` (a sharded step's global ray count) makes
    every term this rank's share of the global term."""
    B = img_idx.shape[0]
    uv = scene["uv"][pixel_idx][None].expand(B, -1, -1)             # (B, P, 2)
    mask = scene["mask"][img_idx][:, pixel_idx]                     # (B, P)
    rgb_gt = rgb_to_pm1(scene["rgb"][img_idx][:, pixel_idx])        # (B, P, 3)
    inputs = {
        "uv": uv,
        "intrinsics": scene["intrinsics"][img_idx],
        "pose": scene["pose"][img_idx] if pose_vecs is None else pose_vecs[img_idx],
        "object_mask": mask,
    }
    outputs = model(inputs, generator=generator, training=True, draws=draws)
    with profiling.span("render"):
        if n_rays is None:
            losses = idr_loss(loss_cfg, outputs, rgb_gt, alpha)
        else:  # the eikonal rows: R // 2 samples and every traced point
            losses = idr_loss(loss_cfg, outputs, rgb_gt, alpha, n_rays=n_rays,
                              n_eik=n_rays // 2 + n_rays)
        if loss_cfg.tv_weight > 0.0:
            tv = model.implicit_network.tv_loss(outputs["points"].detach())
            if tv is not None:
                if n_rays is not None:  # a mean over this rank's points
                    tv = tv * (outputs["points"].shape[0] / n_rays)
                losses["tv_loss"] = tv
                losses["loss"] = losses["loss"] + loss_cfg.tv_weight * tv
    return losses


def build_train_step(model: IDRNetwork, loss_cfg: IDRLossConfig,
                     optimizer: torch.optim.Optimizer,
                     pose_vecs: Optional[torch.Tensor] = None,
                     cam_opt: Optional[Dict[str, torch.Tensor]] = None,
                     lr_cam: float = 1e-4, mesh=None,
                     min_table_rows: int = 1024, graphed: Optional[bool] = None) -> Callable:
    """One train step over ``model``'s parameters, updated in place:
    ``step(scene, img_idx, pixel_idx, generator, alpha, draws=None)`` returns
    the detached loss terms; a step whose gradient is not finite takes no
    update (counted in ``step.skipped``).  With ``pose_vecs``
    (a (V, 7) leaf that requires grad) and its ``cam_opt``
    (``sparse_adam_init``) the cameras train too: their unclipped gradient
    takes a SparseAdam step at ``lr_cam`` over the rows ``img_idx``.

    ``graphed`` (default: whether the parameters are on the card) gives a
    ``GraphedTrainStep``, replayed from CUDA graphs on the card; on the CPU
    it runs the same program eagerly.  ``graphed=False`` gives the eager
    step, whose one host read outside the tracer is ``update_is_finite``'s
    check.

    With ``mesh`` (``parallel.sharding.make_mesh``) the step is sharded
    (``_sharded_step``, eager); ``optimizer`` is then re-pointed at each
    row-sharded table's rows on this rank."""
    if mesh is not None:
        if graphed:
            raise ValueError("the sharded step is not graphed: its flag exchange reads the host")
        return _sharded_step(model, loss_cfg, optimizer, pose_vecs, cam_opt, lr_cam,
                             mesh, min_table_rows)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    on_cuda = params[0].device.type == "cuda"
    if graphed is None:
        graphed = on_cuda
    if graphed:
        return GraphedTrainStep(model, loss_cfg, optimizer, pose_vecs, cam_opt, lr_cam,
                                capture=on_cuda)

    def step(scene, img_idx, pixel_idx, generator, alpha, draws=None):
        with profiling.span("step"):
            optimizer.zero_grad(set_to_none=True)
            if pose_vecs is not None:
                pose_vecs.grad = None
            losses = loss_fn(model, loss_cfg, scene, img_idx, pixel_idx, generator, alpha,
                             draws=draws, pose_vecs=pose_vecs)
            with profiling.span("backward"):
                losses["loss"].backward()
            with profiling.span("update"):
                g_norm = clip_by_global_norm(params, MAX_GRAD_NORM)
                if update_is_finite(step, g_norm, pose_vecs, losses):
                    optimizer.step()
                    if pose_vecs is not None:
                        sparse_adam_update(pose_vecs, pose_vecs.grad, cam_opt, img_idx, lr_cam)
        return {k: v.detach() for k, v in losses.items()}

    step.skipped = 0
    return step


def init_adam_state(optimizer: torch.optim.Adam, p: torch.Tensor) -> None:
    """``optimizer.state[p]`` as ``torch.optim.Adam`` makes it before its
    first step of ``p``: zero moments and a zero step count, on ``p``'s
    device when the optimizer is capturable.  The graphed step makes it
    before its capture, so that no graph allocates or resets it."""
    group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
    on_device = group.get("capturable") or group.get("fused")
    state = optimizer.state[p]
    state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device) if on_device
                     else torch.tensor(0.0, dtype=torch.float32))
    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    if group.get("amsgrad"):
        state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _host_range(name: str):
    """A ``torch.profiler`` range named ``name`` with tracing on, else
    nothing."""
    if profiling.tracing():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class GraphedTrainStep:
    """The one-device step as one device program, as JAX's jitted step
    (JAX :82-152), called as the eager step is; ``capture=True`` (the card)
    launches it as one CUDA graph, ``capture=False`` runs the same program
    eagerly (the CPU tests, where the tracer's loops read their predicates
    on the host as the eager step does).  The launched graph reads nothing
    on the host: the tracer's loops are while-nodes on the device:

    * the step's inputs live in static buffers, copied in every call:
      ``img_idx``, ``pixel_idx``, ``alpha`` (a 0-d tensor) and the uniform
      draws, taken from ``generator`` before the replays by
      ``IDRNetwork.draw_uniforms`` (the numbers the eager forward takes), or
      ``draws`` when given; the learning rate is the optimizer's tensor
      (``set_lr``);
    * the update is masked on the device: the parameters, the Adam state
      and, with cameras, the pose table and its SparseAdam state are saved
      before the update and restored where the gradient's global norm (or
      the camera gradient) is not finite, as ``optax.apply_if_finite``
      leaves them.  Such a step adds one to a device counter, which
      ``skipped`` reads (one host read), and keeps its loss terms
      (``last_skipped_terms``);
    * the first call warms up on a side stream (a forward and a backward:
      the CUDA kernel's build and occupancy queries, cuBLAS, the Adam
      state), captures the program (``utils/graphs.py:capture_program``)
      into one memory pool and assembles it into one executable graph
      (``Program.instantiate``); a call whose shapes, scene, parameters or
      optimizer state (a checkpoint loaded into the optimizer) moved
      captures again.  A capture or an assembly that fails raises: there is
      no eager fallback.

    ``captures`` counts the captures and ``capture_s`` holds the last one's
    host seconds (warm-up, capture, assembly and instantiation).

    With tracing on (``utils/profiling.py:set_tracing``; switching it makes
    the next call capture again) the graph holds the step's spans, and a
    call records the host ranges ``step.inputs`` (the signature and the
    inputs' copies), ``step.launch`` and ``step.outputs`` (the signature
    kept and the losses' copies) for ``torch.profiler``."""

    def __init__(self, model: IDRNetwork, loss_cfg: IDRLossConfig,
                 optimizer: torch.optim.Optimizer, pose_vecs: Optional[torch.Tensor],
                 cam_opt: Optional[Dict[str, torch.Tensor]], lr_cam: float, capture: bool):
        if not isinstance(optimizer, torch.optim.Adam):
            raise TypeError(f"the graphed step takes torch.optim.Adam, not {type(optimizer)}")
        self.model, self.loss_cfg, self.optimizer = model, loss_cfg, optimizer
        self.pose_vecs, self.cam_opt, self.lr_cam = pose_vecs, cam_opt, lr_cam
        self.capture = capture
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.device = self.params[0].device
        if capture and (self.device.type != "cuda" or not all(
                g["capturable"] and torch.is_tensor(g["lr"]) for g in optimizer.param_groups)):
            raise ValueError("capturing needs the parameters on a CUDA device and a capturable "
                             "Adam whose learning rate is a tensor (make_optimizer)")
        self._skipped = torch.zeros((), dtype=torch.int64, device=self.device)
        self._skip_terms: Optional[torch.Tensor] = None
        self._key = None
        self._inputs: Dict = {}
        self._losses: Dict[str, torch.Tensor] = {}
        self.program: Optional[graphs.Program] = None
        self.captures, self.capture_s = 0, 0.0

    @property
    def skipped(self) -> int:
        """Steps whose update was skipped (a host read of the device count)."""
        return int(self._skipped)

    def last_skipped_terms(self) -> Dict[str, float]:
        """The loss terms of the last skipped step (NaN before any)."""
        if self._skip_terms is None:
            return {}
        return dict(zip(self._losses, self._skip_terms.tolist()))

    def __call__(self, scene, img_idx, pixel_idx, generator, alpha, draws=None):
        if draws is None:
            draws = self.model.draw_uniforms(generator, img_idx.shape[0] * pixel_idx.shape[0],
                                             self.device)
        with _host_range("step.inputs"):
            if self._signature(scene, img_idx, pixel_idx, draws) != self._key:
                self._setup(scene, img_idx, pixel_idx, draws)
            self._fill(img_idx, pixel_idx, alpha, draws)
        if self.capture:
            if self.program is None:
                self._capture()
            with _host_range("step.launch"):
                self.program.replay()
        else:
            self._run()
        with _host_range("step.outputs"):
            self._key = self._signature(scene, img_idx, pixel_idx, draws)
            return {k: v.clone() for k, v in self._losses.items()}

    def _signature(self, scene, img_idx, pixel_idx, draws):
        """What the captured graphs hold by address or shape."""
        opt = self.optimizer
        tensors = list(self.params) + list(scene.values())
        tensors += [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
        tensors += [t for st in opt.state.values() for t in st.values() if torch.is_tensor(t)]
        if self.pose_vecs is not None:
            tensors += [self.pose_vecs] + list(self.cam_opt.values())
        return (tuple((t.data_ptr(), tuple(t.shape)) for t in tensors),
                tuple(img_idx.shape), tuple(pixel_idx.shape),
                tuple((k, tuple(v.shape)) for k, v in sorted(draws.items())),
                profiling.tracing())

    def _setup(self, scene, img_idx, pixel_idx, draws) -> None:
        """Static input buffers; the old program, if any, is dropped (what
        its loops ran folded into the launch counts first)."""
        if self.program is not None:
            graphs.fold_device_counts()
        self.program = None
        self.scene = scene
        dev = self.device
        self._inputs = {
            "img_idx": torch.empty(img_idx.shape, dtype=torch.int64, device=dev),
            "pixel_idx": torch.empty(pixel_idx.shape, dtype=torch.int64, device=dev),
            "alpha": torch.empty((), dtype=torch.float32, device=dev),
            "draws": {k: torch.empty(tuple(v.shape), dtype=torch.float32, device=dev)
                      for k, v in draws.items()}}

    def _fill(self, img_idx, pixel_idx, alpha, draws) -> None:
        inp = self._inputs
        inp["img_idx"].copy_(img_idx)
        inp["pixel_idx"].copy_(pixel_idx)
        if torch.is_tensor(alpha):
            inp["alpha"].copy_(alpha)
        else:
            inp["alpha"].fill_(alpha)
        for k, v in draws.items():
            inp["draws"][k].copy_(torch.as_tensor(v))

    def _zero_grads(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        if self.pose_vecs is not None:
            self.pose_vecs.grad = None

    def _forward_backward(self) -> Dict[str, torch.Tensor]:
        self._zero_grads()
        inp = self._inputs
        losses = loss_fn(self.model, self.loss_cfg, self.scene, inp["img_idx"],
                         inp["pixel_idx"], None, inp["alpha"], draws=inp["draws"],
                         pose_vecs=self.pose_vecs)
        with profiling.span("backward"):
            losses["loss"].backward()
        return losses

    def _update_tensors(self) -> List[torch.Tensor]:
        """Every tensor the update writes."""
        out = []
        for p in self.params:
            if p.grad is not None:
                if not self.optimizer.state[p]:
                    init_adam_state(self.optimizer, p)
                out += [p] + [t for t in self.optimizer.state[p].values() if torch.is_tensor(t)]
        if self.pose_vecs is not None:
            out += [self.pose_vecs] + list(self.cam_opt.values())
        return out

    def _run(self) -> None:
        """The step's program: forward, backward, clip, the masked update."""
        with profiling.span("step"):
            losses = self._forward_backward()
            with torch.no_grad(), profiling.span("update"):
                g_norm = clip_by_global_norm(self.params, MAX_GRAD_NORM)
                ok = torch.isfinite(g_norm)
                if self.pose_vecs is not None and self.pose_vecs.grad is not None:
                    ok = ok & torch.isfinite(self.pose_vecs.grad).all()
                written = self._update_tensors()
                saved = [t.clone() for t in written]
                self.optimizer.step()
                if self.pose_vecs is not None:
                    sparse_adam_update(self.pose_vecs, self.pose_vecs.grad, self.cam_opt,
                                       self._inputs["img_idx"], self.lr_cam)
                for t, old in zip(written, saved):
                    t.copy_(torch.where(ok, t, old))
                self._skipped.add_(~ok)
                terms = torch.stack([v.detach() for v in losses.values()])
                if self._skip_terms is None:
                    self._skip_terms = torch.full_like(terms, float("nan"))
                self._skip_terms.copy_(torch.where(ok, self._skip_terms, terms))
        self._losses = {k: v.detach() for k, v in losses.items()}

    def _capture(self) -> None:
        t0 = time.perf_counter()
        stream = graphs.side_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            # the warm-up: nothing of it is kept but what it builds
            losses = self._forward_backward()
            self._update_tensors()
            if self._skip_terms is None or self._skip_terms.numel() != len(losses):
                self._skip_terms = torch.full((len(losses),), float("nan"), device=self.device)
            del losses
            self._zero_grads()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        try:
            with graphs.capture_program(stream=stream) as program:
                self._run()
            program.instantiate()
        except Exception as e:
            raise RuntimeError(f"capturing the train step failed: {e}") from e
        self.program = program
        torch.cuda.synchronize(self.device)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0


def _sharded_step(model, loss_cfg, optimizer, pose_vecs, cam_opt, lr_cam, mesh,
                  min_table_rows):
    """The step on a ('data', 'model') mesh, computing what the one-device
    step computes (JAX :82-130, where XLA SPMD inserts the collectives):

    * every rank takes the global pixel batch and the global draws (from
      ``generator``, seeded alike on every rank, or ``draws``) and renders
      its slice of the rays (``sharding.ray_sharding``) with its rows of
      ``'eik'``; its loss terms divide by the global counts, so they are
      partial sums, and the returned terms are their sums over the ranks;
    * the replicated parameters' gradients (and the pose table's) are
      summed over the ranks in one flat all-reduce; a gradient that is
      None on a rank (a parameter its rays did not reach) counts as zeros,
      and one that is None on every rank stays None, as in the one-device
      step (Adam then skips the parameter);
    * a row-sharded table (``sharding.param_sharding``) lives as this
      rank's rows and their Adam moments; its gradient is reduce-scattered
      over 'model' and summed over 'data', and the full table is gathered
      back into the module after the update;
    * the clip is by the global norm: the replicated gradients once, the
      table rows' squares summed over 'model'; the cameras stay unclipped;
      a norm that is not finite skips the update on every rank alike.

    The returned step carries the ``ShardedTables`` as ``step.tables`` and
    ``step.optimizer_state_dict()``, the optimizer's state with each
    table's moments gathered whole (collective; for a checkpoint)."""
    from ..parallel import sharding as sh

    placement = sh.param_sharding(model, mesh, min_table_rows)
    names = [n for n, spec in placement.items() if spec == sh.ROWS]
    tables = sh.ShardedTables(model, mesh, names)
    by_param = {id(p): n for n, p in tables.full.items()}
    for group in optimizer.param_groups:
        for i, p in enumerate(group["params"]):
            n = by_param.get(id(p))
            if n is None:
                continue
            shard = tables.shards[n]
            group["params"][i] = shard
            st = optimizer.state.pop(p, None)
            if st:  # a restored state: keep this rank's rows of the moments
                optimizer.state[shard] = {
                    k: (v[tables.rows[n]].clone() if torch.is_tensor(v) and v.dim() == 2 else v)
                    for k, v in st.items()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    shard_ids = {id(p) for p in tables.shards.values()}
    replicated = [p for p in params if id(p) not in shard_ids]
    reduced = replicated + ([pose_vecs] if pose_vecs is not None else [])
    shard_slots = {n: next(i for i, p in enumerate(params) if p is tables.shards[n])
                   for n in names}
    world = mesh.size()
    # CPU tensors go over gloo; under NCCL a gloo group carries them
    host_group = dist.new_group(backend="gloo") if dist.get_backend() == "nccl" else None

    def step(scene, img_idx, pixel_idx, generator, alpha, draws=None):
        optimizer.zero_grad(set_to_none=True)
        for p in tables.full.values():
            p.grad = None
        if pose_vecs is not None:
            pose_vecs.grad = None
        n_rays = img_idx.shape[0] * pixel_idx.shape[0]
        if n_rays % (2 * world):
            raise ValueError(f"{n_rays} rays do not split into even shares of {world} ranks")
        if draws is None:
            draws = model.draw_uniforms(generator, n_rays, scene["uv"].device)
        local = dict(draws)
        local["eik"] = sh.constrain_rays(torch.as_tensor(draws["eik"]), mesh)
        losses = loss_fn(model, loss_cfg, scene, img_idx, sh.constrain_rays(pixel_idx, mesh),
                         generator, alpha, draws=local, pose_vecs=pose_vecs, n_rays=n_rays)
        losses["loss"].backward()
        with torch.no_grad():
            # which gradients exist on some rank: a host-side exchange
            counts = torch.tensor([float(p.grad is not None) for p in reduced])
            dist.all_reduce(counts, group=host_group)
            flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                              for p in reduced])
            dist.all_reduce(flat)
            counts = counts.tolist()
            offset = 0
            for p, count in zip(reduced, counts):
                p.grad = flat[offset:offset + p.numel()].view_as(p) if count > 0 else None
                offset += p.numel()
            tables.reduce_grads()
            # the global norm: replicated gradients once, table rows over 'model'
            sq = torch.stack([(p.grad ** 2).sum() for p in replicated
                              if p.grad is not None]).sum()
            if len(tables):
                sq_rows = torch.stack([(p.grad ** 2).sum() for p in tables.shards.values()]).sum()
                dist.all_reduce(sq_rows, group=tables.model_group)
                sq = sq + sq_rows
            g_norm = torch.sqrt(sq)
            keep = g_norm < MAX_GRAD_NORM
            for p in params:
                if p.grad is not None:
                    p.grad.copy_(torch.where(keep, p.grad, (p.grad / g_norm) * MAX_GRAD_NORM))
        # the norm and the camera gradient are alike on every rank: all skip alike
        if update_is_finite(step, g_norm, pose_vecs, losses):
            optimizer.step()
            if pose_vecs is not None:
                sparse_adam_update(pose_vecs, pose_vecs.grad, cam_opt, img_idx, lr_cam)
        tables.gather()
        terms = torch.stack([v.detach() for v in losses.values()])
        dist.all_reduce(terms)
        return dict(zip(losses, terms.unbind()))

    def optimizer_state_dict():
        sd = optimizer.state_dict()
        for n, slot in shard_slots.items():
            st = sd["state"].get(slot)
            if st is not None:
                sd["state"][slot] = {
                    k: (tables.gather_rows(n, v) if torch.is_tensor(v) and v.dim() == 2 else v)
                    for k, v in st.items()}
        return sd

    step.skipped = 0
    step.tables = tables
    step.optimizer_state_dict = optimizer_state_dict
    return step


class IDRTrainRunner:
    """Trains one scene from a conf file (JAX :159-358).

    ``device=None`` means the CUDA card (raises when there is none); pass
    ``"cpu"`` to train on the CPU.  The initial weights come from ``seed``,
    the pixel and tracer draws from a generator on the device seeded with
    ``seed + 1``, the image order from a host generator seeded with
    ``seed + 2``.  These streams differ from the JAX runner's.

    With ``mesh`` (``parallel.sharding.make_mesh``; every rank builds the
    runner alike) the step is ``build_train_step(mesh=...)``: the seeds give
    every rank the same weights and draws.  In a process
    group of more than one rank, rank 0 builds the CUDA kernel first
    (``utils/compile_cache.py:build_once``) and alone writes the run
    directory, checkpoints, scalars and plots; a checkpoint holds the
    tables' Adam moments whole, so it resumes with or without a mesh.

    With ``trace_spans`` the step's spans are on (``utils/profiling.py``)
    and each epoch logs ``span_ms/<span>`` (ms a step) and
    ``launch_gap_ms`` (the card's mean wait between one step's work and the
    next), folded at the epoch's one host read."""

    def __init__(
        self,
        conf: str | Config,
        batch_size: int = 1,
        nepochs: int = 2000,
        expname: str = "",
        exps_folder_name: str = "exps",
        train_cameras: bool = False,
        scan_id: int = -1,
        is_continue: bool = False,
        timestamp: str = "latest",
        checkpoint: str = "latest",
        data_root: Optional[str] = None,
        seed: int = 42,
        log_tensorboard: bool = True,
        device=None,
        mesh=None,
        trace_spans: bool = False,
    ):
        self.device = resolve_device(device)
        self.trace_spans = trace_spans
        if trace_spans:
            profiling.set_tracing(True, self.device)
        self.conf = parse_file(conf) if isinstance(conf, str) else conf
        self.batch_size = batch_size
        self.nepochs = nepochs
        self.train_cameras = train_cameras
        self.mesh = mesh
        self.rank, self.world = ((dist.get_rank(), dist.get_world_size())
                                 if dist.is_initialized() else (0, 1))
        self.is_writer = self.rank == 0
        enable_compile_cache()  # JAX :177-179
        if self.device.type == "cuda" and self.world > 1:
            build_once(fm.load_library)

        # a non-empty --expname REPLACES the conf expname (JAX :186-196;
        # idr_train.py:35 would append)
        self.expname = expname or self.conf.get_string("train.expname")
        if expname and expname != self.conf.get_string("train.expname"):
            print(f"[expname] '--expname {expname}' REPLACES the conf "
                  f"expname '{self.conf.get_string('train.expname')}' "
                  f"(reference idr_train.py:35 would append)")
        if scan_id == -1:
            scan_id = self.conf.get_int("dataset.scan_id", -1)
        if scan_id != -1:
            self.expname += f"_{scan_id}"

        # experiment dirs (idr_train.py:63-90)
        self.expdir = os.path.join(exps_folder_name, self.expname)
        resume_dir = None
        if is_continue and timestamp == "latest":
            if os.path.exists(self.expdir):
                stamps = sorted(os.listdir(self.expdir))
                if stamps:
                    resume_dir = os.path.join(self.expdir, stamps[-1])
        elif is_continue:
            resume_dir = os.path.join(self.expdir, timestamp)
        if self.world > 1:  # every rank has its resume_dir before rank 0 adds a run
            dist.barrier()
        self.timestamp = "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
        self.rundir = os.path.join(self.expdir, self.timestamp)
        self.plots_dir = os.path.join(self.rundir, "plots")
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        if self.is_writer:
            os.makedirs(self.plots_dir, exist_ok=True)
            os.makedirs(self.checkpoints_path, exist_ok=True)
            with open(os.path.join(self.rundir, "runconf.conf"), "w") as f:
                f.write(self.conf.dump())

        # data
        dataset_conf = dict(self.conf.get_config("dataset").data)
        if scan_id != -1:
            dataset_conf["scan_id"] = scan_id
        self.train_dataset = SceneDataset(train_cameras, data_root=data_root, **dataset_conf)
        self.n_images = len(self.train_dataset)
        self.total_pixels = self.train_dataset.total_pixels

        # model / loss
        self.model = IDRNetwork(self.conf.get_config("model"), device=self.device, seed=seed)
        loss_conf = self.conf.get_config("loss").data
        self.loss_cfg = IDRLossConfig(
            eikonal_weight=loss_conf["eikonal_weight"],
            mask_weight=loss_conf["mask_weight"],
            alpha=loss_conf["alpha"],
            tv_weight=float(loss_conf.get("tv_weight", 0.0)),
        )

        # schedules
        self.lr = self.conf.get_float("train.learning_rate")
        self.sched_milestones = self.conf.get_list("train.sched_milestones", [])
        self.sched_factor = self.conf.get_float("train.sched_factor", 0.0)
        self.alpha_milestones = self.conf.get_list("train.alpha_milestones", [])
        self.alpha_factor = self.conf.get_float("train.alpha_factor", 0.0)
        self.num_pixels = self.conf.get_int("train.num_pixels")
        self.plot_freq = self.conf.get_int("train.plot_freq")
        self.plot_conf = self.conf.get_config("plot")
        self._plot_ev = None
        self.steps_per_epoch = max(self.n_images // self.batch_size, 1)
        self.milestone_steps = [int(m) * self.steps_per_epoch for m in self.sched_milestones]

        self.optimizer = make_optimizer(self.model, lr=self.lr)
        # trainable cameras: a (V, 7) pose table from the noisy linear init
        # and its SparseAdam state (JAX :271-276), both in the checkpoint
        self.pose_vecs, self.cam_opt = None, None
        self.lr_cam = self.conf.get_float("train.learning_rate_cam", 1e-4)
        if train_cameras:
            self.pose_vecs = torch.tensor(self.train_dataset.get_pose_init(),
                                          device=self.device, requires_grad=True)
            self.cam_opt = sparse_adam_init(self.pose_vecs)
        # optimizer steps taken: the LR schedule's count (optax keeps it in
        # opt_state; here it travels in the checkpoint)
        self.step_count = 0
        self.start_epoch = 0
        if resume_dir is not None and ckpt.latest_exists(os.path.join(resume_dir, "checkpoints")):
            loaded = ckpt.load_checkpoint(os.path.join(resume_dir, "checkpoints"), checkpoint,
                                          self.model, self.optimizer, cameras=self._cameras())
            self.start_epoch, self.step_count = loaded["epoch"], loaded["step"]
            if self.is_writer:
                print(f"resumed from {resume_dir} at epoch {self.start_epoch} "
                      f"(step {self.step_count})")

        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.order_generator = torch.Generator().manual_seed(seed + 2)
        self.scene = self.train_dataset.device_arrays(self.device)
        self.logger = (ScalarLogger(os.path.join(self.rundir, "logs"),
                                    use_tensorboard=log_tensorboard)
                       if self.is_writer else None)
        # the built step (graphed on the card), whose count of skipped
        # updates each epoch logs; run() calls _step_fn, which a caller may
        # wrap
        self.train_step = build_train_step(self.model, self.loss_cfg, self.optimizer,
                                           pose_vecs=self.pose_vecs, cam_opt=self.cam_opt,
                                           lr_cam=self.lr_cam, mesh=mesh)
        self._step_fn = self.train_step
        self._skipped_seen = 0

    def _cameras(self) -> Optional[Dict]:
        """The trainable cameras' checkpoint entries, or None."""
        if not self.train_cameras:
            return None
        return {"pose_vecs": self.pose_vecs, "cam_opt": self.cam_opt}

    def _save(self, epoch: int) -> None:
        """A checkpoint from rank 0; under a mesh every rank joins the
        gather of the tables' moments first."""
        opt_state = self._step_fn.optimizer_state_dict() if self.mesh is not None else None
        if self.is_writer:
            ckpt.save_checkpoint(self.checkpoints_path, epoch, self.model, self.optimizer,
                                 self.step_count, cameras=self._cameras(),
                                 optimizer_state=opt_state)

    def lr_at(self, count: int) -> float:
        """The LR of the step taken at optimizer count ``count``, as optax's
        schedule gives it (JAX :252-258): ``lr * factor ** #{milestone
        steps <= count}``."""
        return self.lr * self.sched_factor ** sum(count >= m for m in self.milestone_steps)

    def run(self):
        if self.is_writer:
            print(f"training {self.expname} for {self.nepochs} epochs "
                  f"({self.steps_per_epoch} steps/epoch, {self.num_pixels} rays/step) "
                  f"on {self.device}"
                  + (f", mesh {tuple(self.mesh.shape)}" if self.mesh is not None else ""))
        B = self.batch_size
        for epoch in range(self.start_epoch, self.nepochs + 1):
            alpha = annealed_alpha(self.loss_cfg.alpha, self.alpha_milestones,
                                   self.alpha_factor, epoch)
            if epoch % CHECKPOINT_EVERY == 0:
                self._save(epoch)
            if self.plot_freq and epoch % self.plot_freq == 0 and epoch > 0:
                try:
                    self._plot(epoch)
                except Exception:  # plotting never stops training (JAX :313-317)
                    print(f"[plot @{epoch}] failed:")
                    traceback.print_exc()

            # one pixel subset per epoch, shared by its steps (idr_train.py:278)
            pixel_idx = sample_pixels(self.generator, self.total_pixels, self.num_pixels)
            order = torch.randperm(self.n_images, generator=self.order_generator).to(self.device)
            launched = fm.snapshot_launch_counts()
            spans_before = profiling.snapshot_spans() if self.trace_spans else None

            t0 = time.perf_counter()
            for i in range(self.steps_per_epoch):
                set_lr(self.optimizer, self.lr_at(self.step_count))
                losses = self._step_fn(self.scene, order[i * B:(i + 1) * B], pixel_idx,
                                       self.generator, alpha)
                self.step_count += 1
            # one device->host read of the losses and of the skip count an
            # epoch (the eager step also reads its finiteness check a step)
            host_losses = dict(zip(losses, torch.stack(list(losses.values())).tolist()))
            skipped = self.train_step.skipped
            dt = time.perf_counter() - t0
            skipped_steps, self._skipped_seen = skipped - self._skipped_seen, skipped
            if skipped_steps and isinstance(self.train_step, GraphedTrainStep):
                print(f"[train step] non-finite gradient: {skipped_steps} update(s) skipped in "
                      f"epoch {epoch} ({skipped} so far); the last one's loss terms "
                      f"{self.train_step.last_skipped_terms()}")
            rays_per_s = self.steps_per_epoch * self.num_pixels / dt
            # the graphed step's loop launches are counted on the device:
            # folded in here, one host read an epoch
            kernel_launches = {f"{k}_launches": c["launches"]
                               for k, c in fm.launch_counts_since(launched).items()}
            spans = self._span_scalars(spans_before) if self.trace_spans else {}
            if not self.is_writer:
                continue
            self.logger.log(epoch, rays_per_s=rays_per_s, alpha=alpha, **host_losses,
                            skipped_steps=skipped_steps, **kernel_launches, **spans)
            if epoch % 10 == 0:
                print(f"[{epoch}] loss={host_losses['loss']:.5f} "
                      f"rgb={host_losses['rgb_loss']:.5f} "
                      f"eik={host_losses['eikonal_loss']:.5f} "
                      f"mask={host_losses['mask_loss']:.6f} "
                      f"rays/s={rays_per_s:.0f}")
        self._save(self.nepochs)
        if self.is_writer:
            self.logger.close()

    def _span_scalars(self, before: Dict[str, Dict[str, int]]) -> Dict[str, float]:
        """Each span's ms a step, and the mean wait between steps, since
        ``before`` (``profiling.snapshot_spans``; the epoch's fold is made)."""
        now = profiling.snapshot_spans()
        out = {f"span_ms/{k}": (now[k]["ns"] - before[k]["ns"]) / self.steps_per_epoch / 1e6
               for k in profiling.SPANS}
        gaps = now["between_steps"]["count"] - before["between_steps"]["count"]
        out["launch_gap_ms"] = ((now["between_steps"]["ns"] - before["between_steps"]["ns"])
                                / max(gaps, 1) / 1e6)
        return out

    def _plot(self, epoch: int):
        """Per-plot-epoch artifacts (idr_train.py:231-273 role; JAX
        :396-419): one view, drawn from the image-order generator, rendered
        at eval tiles by one reused ``Evaluator`` (with the trained poses
        when the cameras train), and the mesh at ``plot.resolution``."""
        from ..eval.evaluator import Evaluator
        from ..eval.plots import plot_epoch

        # every rank draws the view, so that the image order stays alike
        idx = int(torch.randint(0, self.n_images, (), generator=self.order_generator))
        if not self.is_writer:
            return
        if self._plot_ev is None:
            self._plot_ev = Evaluator(self.conf, self.model, dataset=self.train_dataset)
        if self.train_cameras:
            self._plot_ev.pose_vecs = self.pose_vecs.detach()
        view = self._plot_ev.render_view(idx)
        plot_epoch(self.plots_dir, epoch, view, self.model.implicit_network.sdf,
                   self.train_dataset.pose_all,
                   resolution=self.plot_conf.get_int("resolution", 100), device=self.device)

    def validation_loss_slope(self, out_path: Optional[str] = None):
        """Mean-loss-per-epoch slope plot (idr_train.py:340-359 role), from
        the run's scalars.jsonl; falls back to printing when matplotlib is
        unavailable."""
        log_path = os.path.join(self.rundir, "logs", "scalars.jsonl")
        if not os.path.exists(log_path):
            return None
        with open(log_path) as f:
            rows = [json.loads(line) for line in f]
        if not rows:
            return None
        steps = [r["step"] for r in rows]
        losses = [r.get("loss", float("nan")) for r in rows]
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("validation slope:", list(zip(steps[-10:], losses[-10:])))
            return None
        embed_type = self.conf.get_string("model.embedding_network.embed_type", "none")
        plt.figure()
        plt.plot(steps, losses, label=f"IDR with {embed_type} Embedding Network Loss")
        plt.xlabel("Epochs")
        plt.ylabel("Loss")
        plt.legend()
        out = out_path or os.path.join(
            self.plots_dir, f"loss_plot_{embed_type}_EpochStamp{steps[-1]}.png")
        plt.savefig(out)
        plt.close()
        return out
