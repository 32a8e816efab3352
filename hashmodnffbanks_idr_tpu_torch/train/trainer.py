"""The training step and the training runner.

Counterpart of ``hashmodnffbanks_idr_tpu/train/trainer.py`` for fixed
cameras.  The step is pixel gather -> render -> IDR loss -> clipped Adam:
the gradient is clipped to a global norm of 1.0 exactly as
``optax.clip_by_global_norm`` does (idr_train.py:306), then a
``torch.optim.Adam`` step is taken (its update is algebraically optax's).

``IDRTrainRunner`` keeps the JAX runner's semantics (JAX :159-419): run
directories, one pixel subset per epoch, checkpoints every 25 epochs and at
the end, MultiStep LR on the optimizer's step count, per-epoch alpha
annealing, JSONL scalars, and every ``plot_freq`` epochs (never at epoch 0)
the plots of ``eval/plots.py:plot_epoch``.  Still to port: trainable
cameras (SparseAdam).
"""

from __future__ import annotations

import json
import os
import time
import traceback
from datetime import datetime
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..config.hocon import Config, parse_file
from ..data.scene_dataset import SceneDataset, rgb_to_pm1
from ..models.loss import IDRLossConfig, idr_loss
from ..models.renderer import IDRNetwork
from ..ops import fused_mlp as fm
from ..utils.logging import ScalarLogger
from ..utils.sampling import sample_pixels
from . import checkpoints as ckpt
from .schedule import annealed_alpha

MAX_GRAD_NORM = 1.0  # idr_train.py:306
CHECKPOINT_EVERY = 25  # epochs (JAX :311)


def make_optimizer(model: IDRNetwork, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


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


def loss_fn(model: IDRNetwork, loss_cfg: IDRLossConfig, scene: Dict[str, torch.Tensor],
            img_idx: torch.Tensor, pixel_idx: torch.Tensor,
            generator: Optional[torch.Generator], alpha: float,
            draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Gather the step's pixels from the device-resident scene, render them
    and return the loss terms (JAX :94-126).  With ``loss_cfg.tv_weight > 0``
    and a grid encoder, the grid's total variation at the traced points
    (gradient-stopped: the points select cells, the gradient goes to the
    table) is added as ``tv_loss``."""
    B = img_idx.shape[0]
    uv = scene["uv"][pixel_idx][None].expand(B, -1, -1)             # (B, P, 2)
    mask = scene["mask"][img_idx][:, pixel_idx]                     # (B, P)
    rgb_gt = rgb_to_pm1(scene["rgb"][img_idx][:, pixel_idx])        # (B, P, 3)
    inputs = {
        "uv": uv,
        "intrinsics": scene["intrinsics"][img_idx],
        "pose": scene["pose"][img_idx],
        "object_mask": mask,
    }
    outputs = model(inputs, generator=generator, training=True, draws=draws)
    losses = idr_loss(loss_cfg, outputs, rgb_gt, alpha)
    if loss_cfg.tv_weight > 0.0:
        tv = model.implicit_network.tv_loss(outputs["points"].detach())
        if tv is not None:
            losses["tv_loss"] = tv
            losses["loss"] = losses["loss"] + loss_cfg.tv_weight * tv
    return losses


def build_train_step(model: IDRNetwork, loss_cfg: IDRLossConfig,
                     optimizer: torch.optim.Optimizer) -> Callable:
    """One train step over ``model``'s parameters, updated in place:
    ``step(scene, img_idx, pixel_idx, generator, alpha, draws=None)`` returns
    the detached loss terms (no host synchronisation)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(scene, img_idx, pixel_idx, generator, alpha, draws=None):
        optimizer.zero_grad(set_to_none=True)
        losses = loss_fn(model, loss_cfg, scene, img_idx, pixel_idx, generator, alpha,
                         draws=draws)
        losses["loss"].backward()
        clip_by_global_norm(params, MAX_GRAD_NORM)
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


class IDRTrainRunner:
    """Trains one scene from a conf file (JAX :159-358).

    ``device=None`` means the CUDA card (raises when there is none); pass
    ``"cpu"`` to train on the CPU.  The initial weights come from ``seed``,
    the pixel and tracer draws from a generator on the device seeded with
    ``seed + 1``, the image order from a host generator seeded with
    ``seed + 2``.  These streams differ from the JAX runner's."""

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
    ):
        if train_cameras:
            raise NotImplementedError("trainable cameras (SparseAdam) are not ported yet")
        self.device = resolve_device(device)
        self.conf = parse_file(conf) if isinstance(conf, str) else conf
        self.batch_size = batch_size
        self.nepochs = nepochs

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
        self.timestamp = "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
        self.rundir = os.path.join(self.expdir, self.timestamp)
        self.plots_dir = os.path.join(self.rundir, "plots")
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
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
        # optimizer steps taken: the LR schedule's count (optax keeps it in
        # opt_state; here it travels in the checkpoint)
        self.step_count = 0
        self.start_epoch = 0
        if resume_dir is not None and ckpt.latest_exists(os.path.join(resume_dir, "checkpoints")):
            loaded = ckpt.load_checkpoint(os.path.join(resume_dir, "checkpoints"), checkpoint,
                                          self.model, self.optimizer)
            self.start_epoch, self.step_count = loaded["epoch"], loaded["step"]
            print(f"resumed from {resume_dir} at epoch {self.start_epoch} "
                  f"(step {self.step_count})")

        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.order_generator = torch.Generator().manual_seed(seed + 2)
        self.scene = self.train_dataset.device_arrays(self.device)
        self.logger = ScalarLogger(os.path.join(self.rundir, "logs"),
                                   use_tensorboard=log_tensorboard)
        self._step_fn = build_train_step(self.model, self.loss_cfg, self.optimizer)

    def lr_at(self, count: int) -> float:
        """The LR of the step taken at optimizer count ``count``, as optax's
        schedule gives it (JAX :252-258): ``lr * factor ** #{milestone
        steps <= count}``."""
        return self.lr * self.sched_factor ** sum(count >= m for m in self.milestone_steps)

    def run(self):
        print(f"training {self.expname} for {self.nepochs} epochs "
              f"({self.steps_per_epoch} steps/epoch, {self.num_pixels} rays/step) "
              f"on {self.device}")
        B = self.batch_size
        for epoch in range(self.start_epoch, self.nepochs + 1):
            alpha = annealed_alpha(self.loss_cfg.alpha, self.alpha_milestones,
                                   self.alpha_factor, epoch)
            if epoch % CHECKPOINT_EVERY == 0:
                ckpt.save_checkpoint(self.checkpoints_path, epoch, self.model,
                                     self.optimizer, self.step_count)
            if self.plot_freq and epoch % self.plot_freq == 0 and epoch > 0:
                try:
                    self._plot(epoch)
                except Exception:  # plotting never stops training (JAX :313-317)
                    print(f"[plot @{epoch}] failed:")
                    traceback.print_exc()

            # one pixel subset per epoch, shared by its steps (idr_train.py:278)
            pixel_idx = sample_pixels(self.generator, self.total_pixels, self.num_pixels)
            order = torch.randperm(self.n_images, generator=self.order_generator).to(self.device)
            launched = {k: c["launches"] for k, c in fm.launch_counts.items()}

            t0 = time.perf_counter()
            for i in range(self.steps_per_epoch):
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr_at(self.step_count)
                losses = self._step_fn(self.scene, order[i * B:(i + 1) * B], pixel_idx,
                                       self.generator, alpha)
                self.step_count += 1
            # one device->host read an epoch: the step itself adds no sync
            host_losses = dict(zip(losses, torch.stack(list(losses.values())).tolist()))
            dt = time.perf_counter() - t0
            rays_per_s = self.steps_per_epoch * self.num_pixels / dt
            kernel_launches = {f"{k}_launches": c["launches"] - launched[k]
                               for k, c in fm.launch_counts.items()}
            self.logger.log(epoch, rays_per_s=rays_per_s, alpha=alpha, **host_losses,
                            **kernel_launches)
            if epoch % 10 == 0:
                print(f"[{epoch}] loss={host_losses['loss']:.5f} "
                      f"rgb={host_losses['rgb_loss']:.5f} "
                      f"eik={host_losses['eikonal_loss']:.5f} "
                      f"mask={host_losses['mask_loss']:.6f} "
                      f"rays/s={rays_per_s:.0f}")
        ckpt.save_checkpoint(self.checkpoints_path, self.nepochs, self.model,
                             self.optimizer, self.step_count)
        self.logger.close()

    def _plot(self, epoch: int):
        """Per-plot-epoch artifacts (idr_train.py:231-273 role; JAX
        :396-419): one view, drawn from the image-order generator, rendered
        at eval tiles by one reused ``Evaluator``, and the mesh at
        ``plot.resolution``."""
        from ..eval.evaluator import Evaluator
        from ..eval.plots import plot_epoch

        if self._plot_ev is None:
            self._plot_ev = Evaluator(self.conf, self.model, dataset=self.train_dataset)
        idx = int(torch.randint(0, self.n_images, (), generator=self.order_generator))
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
