#!/usr/bin/env python3
"""The f32 anchor witness: the JAX package and the port trained side by side.

The port's 400-epoch f32 anchor (``headtohead_ours_400_f32.conf``) scores
above the JAX package's record, which was taken on a TPU.  There the "f32"
run's matmuls ran at XLA's default precision: one bfloat16 pass.  This
script trains that conf three ways, on the CPU, from the same weights and
the same inputs:

  A  the JAX package at full float32;
  B  the JAX package with every dot's operands rounded to bfloat16 and
     accumulated in float32, forward and backward, at every order of
     differentiation (``bf16_passes``): the TPU's default precision,
     emulated by rounding.  ``jax.default_matmul_precision('bfloat16')``
     cannot stand in for it: on the CPU it changes no product;
  C  the port at full float32.

The arms share the initial weights (the JAX init, bridged to the port by
``weights.from_jax_params``), every step's image, pixels and random key
(one numpy stream, ``plan``; the port takes the draws the JAX step derives
from the key), the LR milestones and the alpha annealing of the runners,
and the port-generated ``dtu_shaped_small`` scan 0.

    python scripts/anchor_witness.py check                 # step 1: A against C
    python scripts/anchor_witness.py train --arm A --epochs 400 [--out witness]
    python scripts/anchor_witness.py score [--checkpoints 100 200 latest] [--out witness]
                                           [--platform cpu]

``check`` holds A and C on the first step at the exact step's bounds (loss
terms rtol 1e-4, gradients rtol 1e-3 / atol 1e-5, the Adam update atol
1e-6), then counts the dots of B's step by how many operands it rounds.
``train`` runs epochs 0..E of 8 steps (the runner's count), logs each
epoch's last loss terms to ``<out>/<arm>/log.jsonl`` and writes the final
weights as a port checkpoint under ``<out>/exps``.  ``score`` needs
only the port: for each arm found it runs ``run_eval`` at resolution 200
over the 8 views and ``dtu_chamfer`` at 0.005, as ``scripts/torch_anchor.sh``
scores the anchor, on the card unless ``--platform cpu``, at each of
``--checkpoints`` (``train`` saves every 50 epochs), and writes
``<out>/witness.json``.  The scene is generated into ``--data_root`` when
it is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONF = os.path.join(REPO, "hashmodnffbanks_idr_tpu/config/confs/headtohead_ours_400_f32.conf")
SCENE = ("dtu_shaped_small", 0, (240, 320), 8)  # data dir, scan, img_res, views
ARMS = ("A", "B", "C")
SAVE_EVERY = 50  # epochs between checkpoints, each scorable with --checkpoint


# ---------------------------------------------------------------------------
# the shared inputs
# ---------------------------------------------------------------------------

def scene_arrays(data_root: str, platform: str = "cpu") -> dict:
    """The anchor scene as numpy arrays (the port's ``SceneDataset``),
    generated first by the port's ``dtu_shaped`` if it is missing."""
    from hashmodnffbanks_idr_tpu_torch.data import dtu_shaped
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset

    data_dir, scan, res, views = SCENE
    scan_dir = os.path.join(data_root, data_dir, f"scan{scan}")
    if not os.path.exists(os.path.join(scan_dir, "gt_mesh.ply")):
        gen = os.path.join(data_root, "_gen")
        dtu_shaped.main(["--out", gen, "--n_views", str(views), "--img_res", str(res[0]),
                         str(res[1]), "--scan_id", str(scan), "--platform", platform])
        os.makedirs(os.path.dirname(scan_dir), exist_ok=True)
        os.replace(os.path.join(gen, "dtu_shaped", f"scan{scan}"), scan_dir)
    ds = SceneDataset(False, data_dir, list(res), scan, data_root=data_root)
    return {k: v.numpy() for k, v in ds.device_arrays("cpu").items()}


def plan(seed: int, epochs: int, n_images: int, total_pixels: int, num_pixels: int):
    """Every step's (epoch, step count, image, pixels, key) from one numpy
    stream, as the runners order them: one pixel subset per epoch, the
    images in a fresh order each epoch, epochs 0..``epochs``."""
    rng = np.random.default_rng(seed)
    count = 0
    for epoch in range(epochs + 1):
        pixels = np.sort(rng.choice(total_pixels, num_pixels, replace=False)).astype(np.int32)
        for img in rng.permutation(n_images):
            yield epoch, count, np.asarray([img], np.int32), pixels, int(rng.integers(2**31))
            count += 1


def lr_at(conf, count, steps_per_epoch: int):
    """The runners' step LR (JAX ``train/trainer.py:252-258``), for a step
    count given as an int or as optax's traced count."""
    base = conf.get_float("train.learning_rate")
    factor = conf.get_float("train.sched_factor", 0.0)
    return base * factor ** sum(count >= m * steps_per_epoch
                                for m in conf.get_list("train.sched_milestones", []))


def port_draws(model, key: int, n_rays: int) -> dict:
    """The uniform draws the JAX step takes from ``PRNGKey(key)`` (JAX
    ``models/renderer.py`` and ``models/ray_tracing.py``), for the port."""
    import jax
    import torch

    from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride

    rng_trace, rng_eik = jax.random.split(jax.random.PRNGKey(key))
    cfg = model.ray_tracer
    with torch.no_grad():
        guidance = model._tracer_sdfs()[1]
    stride = sweep_stride(cfg, bool(guidance and guidance.get("coarse")), on_cuda=False)
    n_c, n_f = (cfg.n_steps - 1) // stride + 1, 3 * (stride - 1)
    rng_c, rng_f = jax.random.split(rng_trace)
    bb = model.object_bounding_sphere
    return {"coarse": np.array(jax.random.uniform(rng_c, (n_c,))),
            "fine": np.array(jax.random.uniform(rng_f, (n_f,))),
            "eik": np.array(jax.random.uniform(rng_eik, (n_rays // 2, 3), minval=-bb, maxval=bb))}


# ---------------------------------------------------------------------------
# arm B: bfloat16 passes
# ---------------------------------------------------------------------------

def to_bf16_grid(x):
    """``x`` (float32) rounded to the nearest bfloat16 value, ties to even,
    kept in float32: the bits are rounded as integers, which XLA cannot fold
    away (it may drop a float32 -> bfloat16 -> float32 round trip, and the
    CPU runtime has no bfloat16 x bfloat16 -> float32 dot).  Its derivative
    is the identity."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.custom_jvp
    def grid(x):
        u = lax.bitcast_convert_type(x, jnp.uint32)
        u = (u + jnp.uint32(0x7FFF) + ((u >> 16) & jnp.uint32(1))) & jnp.uint32(0xFFFF0000)
        return lax.bitcast_convert_type(u, jnp.float32)

    grid.defjvp(lambda primals, tangents: (grid(primals[0]), tangents[0]))
    return grid(x)


@contextlib.contextmanager
def bf16_passes():
    """Inside, every float32 ``dot_general`` that JAX traces takes its
    operands rounded to bfloat16 values (``to_bf16_grid``) and accumulates
    in float32, as a TPU does at the default precision.  Its gradients are
    dots of the same kind: the backward rule transposes (as JAX's
    ``_dot_general_transpose_lhs``) into the same rounded dot, so the
    cotangent and the saved operand are rounded too, and so on where the
    eikonal term differentiates a gradient.  The gradient that flows back
    into an operand is not rounded.  One kind of dot escapes: where the
    outer derivative of the eikonal term goes through the forward dot of
    the inner gradient, JAX transposes that dot itself, whose cotangent is
    then not rounded.  Jit caches are cleared on entry and exit so that no
    trace crosses the boundary."""
    import jax
    import jax.numpy as jnp
    from jax._src.lax import lax as lax_internal

    orig_dot, orig_einsum = lax_internal.dot_general, jnp.einsum

    def rounded(lhs, rhs, dims):
        return orig_dot(to_bf16_grid(lhs), to_bf16_grid(rhs), dims,
                        preferred_element_type=jnp.float32)

    @partial(jax.custom_vjp, nondiff_argnums=(2,))
    def rounded_dot(lhs, rhs, dims):
        return rounded(lhs, rhs, dims)

    def fwd(lhs, rhs, dims):
        return rounded(lhs, rhs, dims), (lhs, rhs)

    def transpose_lhs(g, x_ndim, y, dims, swap_ans=False):
        # JAX's ``_dot_general_transpose_lhs``, its dot the rounded one
        (x_contract, y_contract), (x_batch, y_batch) = dims
        x_kept = lax_internal.remaining(range(x_ndim), x_contract, x_batch)
        y_kept = lax_internal.remaining(range(y.ndim), y_contract, y_batch)
        if swap_ans:
            ans_batch, ans_y, _ = lax_internal.ranges_like(x_batch, y_kept, x_kept)
        else:
            ans_batch, _, ans_y = lax_internal.ranges_like(x_batch, x_kept, y_kept)
        by_y = list(np.take(x_contract, np.argsort(y_contract)))
        out = rounded_dot(g, y, ((tuple(ans_y), tuple(y_kept)), (tuple(ans_batch), tuple(y_batch))))
        return jnp.transpose(out, tuple(np.argsort(list(x_batch) + x_kept + by_y)))

    def bwd(dims, saved, g):
        lhs, rhs = saved
        (lc, rc), (lb, rb) = dims
        return (transpose_lhs(g, lhs.ndim, rhs, dims),
                transpose_lhs(g, rhs.ndim, lhs, ((rc, lc), (rb, lb)), swap_ans=True))

    rounded_dot.defvjp(fwd, bwd)

    def dot_general(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None,
                    *, out_sharding=None):
        lhs, rhs = jnp.asarray(lhs), jnp.asarray(rhs)
        if (lhs.dtype == rhs.dtype == jnp.float32 and out_sharding is None
                and preferred_element_type in (None, jnp.float32)):
            (lc, rc), (lb, rb) = dimension_numbers
            return rounded_dot(lhs, rhs, ((tuple(lc), tuple(rc)), (tuple(lb), tuple(rb))))
        return orig_dot(lhs, rhs, dimension_numbers, precision, preferred_element_type,
                        out_sharding=out_sharding)

    jax.clear_caches()
    lax_internal.dot_general = dot_general
    jnp.einsum = partial(orig_einsum, _dot_general=dot_general)
    try:
        yield
    finally:
        lax_internal.dot_general, jnp.einsum = orig_dot, orig_einsum
        jax.clear_caches()


def rounded_dots(closed_jaxpr) -> dict:
    """How many ``dot_general``s of a jaxpr traced inside ``bf16_passes``
    take both operands from ``to_bf16_grid``, one, or neither (loop bodies
    and derivative rules included)."""
    counts = {"both": 0, "one": 0, "neither": 0}

    def walk(jaxpr):
        made_by = {}
        for eqn in jaxpr.eqns:
            made_by.update((v, eqn.primitive.name) for v in eqn.outvars)
            if eqn.primitive.name == "dot_general":
                n = sum(made_by.get(v) == "custom_jvp_call" for v in eqn.invars)
                counts[("neither", "one", "both")[n]] += 1
            for param in eqn.params.values():
                for sub in param if isinstance(param, (list, tuple)) else (param,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(closed_jaxpr.jaxpr)
    return counts


# ---------------------------------------------------------------------------
# the arms
# ---------------------------------------------------------------------------

class JaxArm:
    """The JAX package's train step (``build_train_step``) with the runner's
    optimizer: global-norm clip 1.0, Adam on the milestone LR.  Arm B runs
    it inside ``bf16_passes``, entered once around the whole run."""

    def __init__(self, conf_text: str, params, steps_per_epoch: int):
        import jax
        import optax

        from hashmodnffbanks_idr_tpu.config.hocon import parse
        from hashmodnffbanks_idr_tpu.models.loss import IDRLossConfig
        from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork
        from hashmodnffbanks_idr_tpu.train.schedule import annealed_alpha
        from hashmodnffbanks_idr_tpu.train.trainer import build_train_step

        self.conf = parse(conf_text)
        self.model = IDRNetwork(self.conf.get_config("model"))
        loss = self.conf.get_config("loss")
        self.alpha0 = loss.get_float("alpha")
        self.alpha = lambda epoch: annealed_alpha(
            self.alpha0, self.conf.get_list("train.alpha_milestones", []),
            self.conf.get_float("train.alpha_factor", 0.0), epoch)
        optimizer = optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adam(lambda count: lr_at(self.conf, count, steps_per_epoch)))
        self.state = {"params": params, "opt_state": optimizer.init(params)}
        self._step = build_train_step(self.model, IDRLossConfig(
            loss.get_float("eikonal_weight"), loss.get_float("mask_weight"), self.alpha0),
            optimizer)
        self.scene = None
        self._jax = jax

    def step(self, scene: dict, epoch: int, img, pixels, key: int) -> dict:
        jax = self._jax
        import jax.numpy as jnp

        if self.scene is None:
            self.scene = {k: jnp.asarray(v) for k, v in scene.items()}
        self.state, losses = self._step(
            self.state, self.scene, jnp.asarray(img), jnp.asarray(pixels),
            jax.random.PRNGKey(key), jnp.asarray(self.alpha(epoch), jnp.float32))
        return {k: float(v) for k, v in jax.device_get(losses).items()}

    def params_numpy(self) -> dict:
        return self._jax.tree_util.tree_map(np.asarray, self.state["params"])

    def clipped_grads(self) -> dict:
        """After the first step only: Adam's ``mu = (1 - b1) * clipped grad``."""
        from hashmodnffbanks_idr_tpu_torch.weights import _flatten

        mu = self._jax.tree_util.tree_map(np.asarray, self.state["opt_state"][1][0].mu)
        return {k: v / 0.1 for k, v in _flatten(mu)}


class PortArm:
    """The port's train step (``build_train_step``) on the CPU, with the
    runner's LR per step and its alpha annealing."""

    def __init__(self, conf_text: str, params_np: dict, steps_per_epoch: int):
        import torch

        from hashmodnffbanks_idr_tpu_torch.config.hocon import parse
        from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
        from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
        from hashmodnffbanks_idr_tpu_torch.train.schedule import annealed_alpha
        from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
        from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

        self.conf = parse(conf_text)
        self.model = IDRNetwork(self.conf.get_config("model"), device="cpu")
        self.model.load_state_dict(from_jax_params(params_np, self.model))
        loss = self.conf.get_config("loss")
        alpha0 = loss.get_float("alpha")
        self.alpha = lambda epoch: annealed_alpha(
            alpha0, self.conf.get_list("train.alpha_milestones", []),
            self.conf.get_float("train.alpha_factor", 0.0), epoch)
        self.optimizer = make_optimizer(self.model, lr=self.conf.get_float("train.learning_rate"))
        self._step = build_train_step(self.model, IDRLossConfig(
            loss.get_float("eikonal_weight"), loss.get_float("mask_weight"), alpha0),
            self.optimizer)
        self.steps_per_epoch = steps_per_epoch
        self.n_rays = self.conf.get_int("train.num_pixels")
        self.scene = None
        self._torch = torch

    def step(self, scene: dict, epoch: int, img, pixels, key: int, count: int) -> dict:
        torch = self._torch
        if self.scene is None:
            self.scene = {k: torch.as_tensor(v) for k, v in scene.items()}
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(self.conf, count, self.steps_per_epoch)
        losses = self._step(self.scene, torch.as_tensor(img).long(),
                            torch.as_tensor(pixels).long(), None, self.alpha(epoch),
                            draws=port_draws(self.model, key, len(pixels)))
        return {k: float(v) for k, v in losses.items()}


def init_params(conf_text: str, seed: int):
    import jax

    from hashmodnffbanks_idr_tpu.config.hocon import parse
    from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork

    model = IDRNetwork(parse(conf_text).get_config("model"))
    return jax.jit(model.init)(jax.random.PRNGKey(seed))


def compare_first_step(jarm: JaxArm, parm: PortArm, jl: dict, pl: dict) -> dict:
    """The first step of A against C, by the parity tests' own rule
    (``tests/torch_step_parity.py``: ``step_metrics``, held at ``EXACT`` by
    ``assert_step``): loss terms, clipped gradients, the updated
    parameters.  Raises past the bounds; returns the largest errors."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_step_parity import assert_step, step_metrics

    from hashmodnffbanks_idr_tpu_torch.weights import _flatten

    m = step_metrics(parm.model, pl, jl, jarm.clipped_grads(), dict(_flatten(jarm.params_numpy())))
    assert_step(m)
    leaves = m["leaves"].values()
    return {"loss_rel": max(m["loss_rel"].values()),
            "grad_excess": max(l["grad_excess"] for l in leaves),
            "update_abs": max(l["update_abs"] for l in leaves)}


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_check(args) -> None:
    conf_text = open(CONF).read()
    scene = scene_arrays(args.data_root)
    n_img, total = scene["rgb"].shape[0], scene["rgb"].shape[1]
    params = init_params(conf_text, args.seed)
    jarm = JaxArm(conf_text, params, n_img)
    parm = PortArm(conf_text, jarm.params_numpy(), n_img)
    epoch, count, img, pixels, key = next(plan(args.seed + 1, 0, n_img, total,
                                               parm.n_rays))
    jl = jarm.step(scene, epoch, img, pixels, key)
    pl = parm.step(scene, epoch, img, pixels, key, count)
    worst = compare_first_step(jarm, parm, jl, pl)
    print("[check] step 1, A against C: " + json.dumps({"jax": jl, "port": pl, **worst}))
    import jax
    import jax.numpy as jnp

    with bf16_passes():
        barm = JaxArm(conf_text, params, n_img)
        jaxpr = jax.make_jaxpr(barm._step)(
            barm.state, {k: jnp.asarray(v) for k, v in scene.items()}, jnp.asarray(img),
            jnp.asarray(pixels), jax.random.PRNGKey(key), jnp.float32(barm.alpha0))
    print("[check] arm B's step, dots by rounded operands: " + json.dumps(rounded_dots(jaxpr)))


def cmd_train(args) -> None:
    import jax

    conf_text = open(CONF).read()
    scene = scene_arrays(args.data_root)
    n_img, total = scene["rgb"].shape[0], scene["rgb"].shape[1]
    params = init_params(conf_text, args.seed)
    if args.arm == "C":
        arm = PortArm(conf_text, jax.tree_util.tree_map(np.asarray, params), n_img)
    else:
        arm = JaxArm(conf_text, params, n_img)
    n_rays = arm.conf.get_int("train.num_pixels")
    out = os.path.join(args.out, args.arm)
    os.makedirs(out, exist_ok=True)
    t0, last = time.time(), None
    with open(os.path.join(out, "log.jsonl"), "w") as log, \
            (bf16_passes() if args.arm == "B" else contextlib.nullcontext()):
        for epoch, count, img, pixels, key in plan(args.seed + 1, args.epochs, n_img, total,
                                                   n_rays):
            if args.arm == "C":
                last = arm.step(scene, epoch, img, pixels, key, count)
            else:
                last = arm.step(scene, epoch, img, pixels, key)
            if count % n_img == n_img - 1:
                log.write(json.dumps({"epoch": epoch, "s": time.time() - t0, **last}) + "\n")
                log.flush()
                if epoch % SAVE_EVERY == 0 and 0 < epoch < args.epochs:
                    save_arm(args.out, args.arm, arm, epoch, count + 1, conf_text)
            if not all(np.isfinite(v) for v in last.values()):
                raise SystemExit(f"arm {args.arm}: non-finite loss at epoch {epoch}: {last}")
    save_arm(args.out, args.arm, arm, args.epochs, count + 1, conf_text)
    print(f"[train] arm {args.arm}: {args.epochs} epochs in {time.time() - t0:.1f} s; "
          f"last loss terms {json.dumps(last)}")


def save_arm(out: str, arm_name: str, arm, epoch: int, steps: int, conf_text: str) -> None:
    """The arm's weights as a port checkpoint, where ``run_eval`` finds it:
    ``<out>/exps/witness_<arm>_0/final/checkpoints/latest.pt``."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.train.checkpoints import save_checkpoint
    from hashmodnffbanks_idr_tpu_torch.train.trainer import make_optimizer
    from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

    if isinstance(arm, PortArm):
        model = arm.model
    else:
        model = IDRNetwork(parse(conf_text).get_config("model"), device="cpu")
        model.load_state_dict(from_jax_params(arm.params_numpy(), model))
    ckpt_dir = os.path.join(out, "exps", f"witness_{arm_name}_0", "final", "checkpoints")
    save_checkpoint(ckpt_dir, epoch, model, make_optimizer(model), steps)


def cmd_score(args) -> None:
    from hashmodnffbanks_idr_tpu_torch.eval import dtu_chamfer, run_eval

    data_dir, scan, _, _ = SCENE
    scene_arrays(args.data_root, platform=args.platform or "cuda")
    gt = os.path.join(args.data_root, data_dir, f"scan{scan}", "gt_mesh.ply")
    plat = ["--platform", args.platform] if args.platform else []
    result = {}
    for arm in ARMS:
        exp = f"witness_{arm}"
        ckpts = os.path.join(args.out, "exps", f"{exp}_0", "final", "checkpoints")
        train_log = os.path.join(args.out, arm, "log.jsonl")
        rows = ({r["epoch"]: r for r in map(json.loads, open(train_log))}
                if os.path.exists(train_log) else {})
        for ckpt in args.checkpoints:
            if not os.path.exists(os.path.join(ckpts, f"{ckpt}.pt")):
                continue
            evals = os.path.join(args.out, "evals", ckpt)
            t0 = time.time()
            run_eval.main(["--conf", CONF, "--expname", exp, "--exps_folder",
                           os.path.join(args.out, "exps"), "--evals_folder", evals,
                           "--data_root", args.data_root, "--resolution", "200",
                           "--checkpoint", ckpt, "--eval_rendering"] + plat)
            ev = os.path.join(evals, f"{exp}_0")
            summary = json.load(open(os.path.join(ev, "metrics", "summary.json")))
            epoch = summary["epoch"]
            log = os.path.join(ev, "chamfer_log.txt")
            dtu_chamfer.main(["--data", os.path.join(ev, f"surface_world_coordinates_{epoch}.ply"),
                              "--gt", gt, "--downsample_density", "0.005", "--log", log])
            chamfer = json.loads(open(log).read().splitlines()[-1])
            row = rows.get(epoch, {})
            rec = {"epochs": epoch, "psnr": summary["psnr_mean"], "ssim": summary["ssim_mean"],
                   "chamfer_d2s": chamfer["mean_d2s"], "chamfer_s2d": chamfer["mean_s2d"],
                   "chamfer": chamfer["over_all"], "train_s": row.get("s"),
                   "loss": row.get("loss"), "score_s": time.time() - t0}
            result.setdefault(arm, {})[str(epoch)] = rec
            print(f"[score] arm {arm} epoch {epoch}: " + json.dumps(rec))
    with open(os.path.join(args.out, "witness.json"), "w") as f:
        json.dump(result, f, indent=1)
    print("[witness] " + json.dumps(result))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=("check", "train", "score"))
    p.add_argument("--arm", choices=ARMS)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default=os.path.join(REPO, "witness"))
    p.add_argument("--data_root", default=os.path.join(REPO, "data"))
    p.add_argument("--checkpoints", nargs="+", default=["latest"],
                   help="score: the saved epochs to score (default: the last saved)")
    p.add_argument("--platform", default=None,
                   help="score: the torch device (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)
    if args.command in ("check", "train"):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.command == "train" and args.arm is None:
        p.error("train needs --arm")
    {"check": cmd_check, "train": cmd_train, "score": cmd_score}[args.command](args)


if __name__ == "__main__":
    main()
