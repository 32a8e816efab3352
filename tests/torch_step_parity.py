"""Shared set-up of the train-step parity tests of the hash-grid and
classic-encoder configurations (tests/test_torch_ngp_step.py,
tests/test_torch_classic_step.py): the narrowed confs, the same weights on both
sides (``from_jax_params``), the JAX step's draws for injection, and one
step held against JAX (losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-5,
the Adam update atol 1e-6, as tests/test_torch_train_step.py holds the
flagship).

The bf16 tracer guidance of the 'mixed' and 'fast' modes is held against
JAX's kernel path (``jax_kernel_guidance``): off the TPU the JAX renderer
falls back to its jnp bf16 layers, which round the skip input after
scaling it, where the Pallas kernel and the port round it before.
``jax_port_guidance`` gives JAX's tracer the port's guidance values
instead, so that what differs is the two tracers' logic alone.
"""

import contextlib
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse as j_parse
from hashmodnffbanks_idr_tpu.models.loss import IDRLossConfig as JLossConfig
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.testing import synthetic_scene
from hashmodnffbanks_idr_tpu.train.trainer import build_train_step as j_build_train_step

from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.ops.hashgrid import as_rows
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, ngp_conf, scene_to_device
from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
from hashmodnffbanks_idr_tpu_torch.weights import _flatten, from_jax_params

N_RAYS = 64
ALPHA = 50.0
# one step against JAX's (``assert_step``): loss terms, gradients and the
# Adam update
EXACT = {"loss_rtol": 1e-4, "grad_rtol": 1e-3, "grad_atol": 1e-5, "update_atol": 1e-6}
# a 'mixed' hash-grid step through JAX's kernel path (check_exact_step's
# ``loose``): loss terms, the whole gradient's relative error, and the share
# of updated entries within 1e-6.  Measured over keys 7/21/33 of the two
# ngp presets by scripts/mixed_parity_report.py: 2.9e-2, 0.097, 0.976 at
# worst (ROADMAP §3, "Bounded limits"); one parameter's own error reaches
# 1.49 there, so the tensors are held one by one with the same guidance
# instead (``check_same_guidance_step``)
LOOSE = {"loss_rtol": 5e-2, "grad_rel": 0.2, "update_share": 0.95}


def narrow(conf, mode, view="SHEncoder"):
    conf.put("model.implicit_network.dims", [128] * 8)
    conf.put("model.rendering_network.dims", [64, 64])
    conf.put("model.feature_vector_size", 32)
    conf.put("model.ray_tracer.n_steps", 28)
    conf.put("model.tracer_fast", mode)
    conf.put("model.tracer_exact_fused", True)
    conf.put("model.rendering_network.viewdirs_embed_type", view)
    return conf


def ngp_k3(mode, n_rays=N_RAYS):
    """The pruned preset (K=3 < 6 levels), narrowed, two guided secant steps."""
    conf = narrow(ngp_conf("ngp_log2_15_k3", num_pixels=n_rays), mode)
    conf.put("model.ray_tracer.prune_secant_iters", 2)
    return conf


def classic_conf(mode, render_mode, embed, view, multires_view, d_in):
    """The ablation confs' settings: a classic encoder, the given view
    embedding and rendering mode."""
    conf = narrow(flagship_conf(num_pixels=N_RAYS, embed_type=embed), mode, view=view)
    conf.put("model.rendering_network.mode", render_mode)
    conf.put("model.rendering_network.multires_view", multires_view)
    conf.put("model.rendering_network.d_in", d_in)
    return conf


def setup(conf, seed=0, perturb=True):
    """JAX model and params, the port's model with the same weights, the
    scene and the pixels.  ``perturb`` spreads the grid table and the
    layers that read the encoding (which the geometric init leaves at 1e-4
    and zero) as training would, so that the pruned guidance differs from
    the exact SDF."""
    jmodel = JIDRNetwork(j_parse(conf.dump()).get_config("model"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    if perturb:
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
        impl = params["implicit_network"]
        if "table" in impl.get("embed", {}):
            t = impl["embed"]["table"]
            impl["embed"]["table"] = t + 0.02 * jax.random.normal(keys[0], t.shape)
        for key, lin in zip(keys[1:], (impl["lin"][0], impl["lin"][4])):
            lin["v"] = lin["v"] + 0.1 * jax.random.normal(key, lin["v"].shape)
    model = IDRNetwork(conf.get_config("model"), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    scene_np = synthetic_scene(n_views=2, img_res=(32, 32), seed=0)
    n_rays = conf.get_int("train.num_pixels")
    pixel_idx = np.random.default_rng(3).permutation(32 * 32)[:n_rays]
    return jmodel, params, model, scene_np, pixel_idx


def draws(model, rng, n_rays):
    """The uniform draws the JAX step takes from ``rng`` (renderer.py:165,
    ray_tracing.py:368-393, renderer.py:189-191), for injection; the sweep's
    stride follows the port's guidance, as JAX's follows its own."""
    rng_trace, rng_eik = jax.random.split(rng)
    cfg = model.ray_tracer
    with torch.no_grad():
        _, guidance = model._tracer_sdfs()
    stride = sweep_stride(cfg, bool(guidance and guidance.get("coarse")), on_cuda=False)
    n_c, n_f = (cfg.n_steps - 1) // stride + 1, 3 * (stride - 1)
    rng_c, rng_f = jax.random.split(rng_trace)
    bb = model.object_bounding_sphere
    return {
        "coarse": np.array(jax.random.uniform(rng_c, (n_c,))),
        "fine": np.array(jax.random.uniform(rng_f, (n_f,))),
        "eik": np.array(jax.random.uniform(rng_eik, (n_rays // 2, 3), minval=-bb, maxval=bb)),
    }


@contextlib.contextmanager
def jax_kernel_guidance(jmodel):
    """JAX's bf16 guidance through ``make_fast_sdf(interpret=True)``: the
    Pallas kernel, run in interpret mode, that the port's fused kernel
    replaces."""
    jnet = jmodel.implicit_network
    plain_apply = jnet.apply

    def apply(p, x, fast=False, max_level=None, floor_interp=False):
        if not fast:
            return plain_apply(p, x, max_level=max_level, floor_interp=floor_interp)
        return jnet.make_fast_sdf(p, interpret=True, max_level=max_level,
                                  floor_interp=floor_interp)(x)[:, None]

    jnet.apply = apply
    try:
        yield
    finally:
        del jnet.apply


@contextlib.contextmanager
def jax_port_guidance(jmodel, model):
    """JAX's bf16 guidance replaced by the port's (``make_fast_sdf('bf16')``,
    the fused kernel's plain twin here) through ``jax.pure_callback``."""
    jnet = jmodel.implicit_network
    plain_apply = jnet.apply

    def apply(p, x, fast=False, max_level=None, floor_interp=False):
        if not fast:
            return plain_apply(p, x, max_level=max_level, floor_interp=floor_interp)
        sdf = model.implicit_network.make_fast_sdf("bf16", max_level=max_level,
                                                   floor_interp=floor_interp)

        def port(points):
            with torch.no_grad():
                return sdf(torch.tensor(np.asarray(points))).numpy()

        out = jax.ShapeDtypeStruct((x.shape[0],), jnp.float32)
        return jax.pure_callback(port, out, x)[:, None]

    jnet.apply = apply
    try:
        yield
    finally:
        del jnet.apply


@contextlib.contextmanager
def step_traces(jmodel, model):
    """The hit masks and distances of the forward inside each side's train
    step: ``{'jax': {'mask': ..., 'dists': ...}, 'port': {...}}`` once both
    steps have run."""
    traces = {}
    jax_apply = jmodel.apply

    def keep(side, mask, dists):
        traces[side] = {"mask": np.asarray(mask), "dists": np.asarray(dists)}

    def apply(p, inputs, rng, training=True):
        out = jax_apply(p, inputs, rng, training=training)
        jax.debug.callback(partial(keep, "jax"), out["network_object_mask"], out["dists"])
        return out

    jmodel.apply = apply
    hook = model.register_forward_hook(lambda mod, args, out: keep(
        "port", out["network_object_mask"].numpy(), out["dists"].detach().numpy()))
    try:
        yield traces
    finally:
        del jmodel.apply
        hook.remove()


def check_same_guidance_step(jmodel, params, model, scene_np, pixel_idx):
    """Inside ``jax_port_guidance``: the step at the exact step's bounds.
    The packages' camera rays differ by float32 rounding, which a guided
    choice can turn into another root on one ray (JAX's own jitted step and
    forward part on such a ray; ROADMAP §3, "Bounded limits"): at most one
    ray of the step may trace elsewhere, and the step is then held again
    with that ray's pixel replaced by another of the step's pixels."""
    run = jax_train_step(jmodel)
    # one ``traces`` for both attempts: the compiled step keeps its callback
    with step_traces(jmodel, model) as traces:
        for attempt in range(2):
            if attempt:
                model.load_state_dict(from_jax_params(
                    jax.tree_util.tree_map(np.asarray, params), model))
                pixel_idx = np.where(moved, pixel_idx[~moved][0], pixel_idx)
            jstep = run(params, scene_np, pixel_idx)
            fm.reset_launch_counts()
            losses = port_step(model, scene_np, pixel_idx)
            moved = np.abs(traces["port"]["dists"] - traces["jax"]["dists"]) > 1e-5
            assert moved.sum() <= 1 - attempt, np.nonzero(moved)
            if not moved.any():
                break
    assert_step(step_metrics(model, losses, *jstep))
    assert all(c["launches"] == 0 for c in fm.launch_counts.values())


def check_mixed_step(jmodel, params, model, scene_np, pixel_idx, loose=False,
                     same_guidance_step=False):
    """A 'mixed' step against JAX.  With the port's guidance in JAX's tracer
    the traces agree ray for ray: hit masks equal, distances within 1e-5
    on all rays but at most one, which stays within 1e-3 (the packages'
    camera rays differ by float32 rounding, which a guided march or sweep
    choice can turn into 2e-4; scripts/mixed_parity_report.py).
    With ``same_guidance_step`` the step holds the exact step's bounds
    (``check_same_guidance_step``).  Through JAX's kernel path the hit
    masks of the two steps' forwards are equal ray for ray, and the step
    holds the exact step's bounds, or with ``loose`` the ``LOOSE`` ones
    (ROADMAP §3, "Bounded limits": the bf16 guidance of two
    implementations differs by rounding flips, and the guided tracer's
    discrete choices amplify them)."""
    with jax_port_guidance(jmodel, model):
        jout, out, agree = forward_pair(jmodel, params, model, scene_np, pixel_idx, seed=11)
        assert agree == 1.0, agree
        diff = np.abs(out["dists"].numpy() - np.asarray(jout["dists"]))
        assert (diff > 1e-5).sum() <= 1 and diff.max() <= 1e-3, diff[diff > 1e-5]
        if same_guidance_step:
            check_same_guidance_step(jmodel, params, model, scene_np, pixel_idx)
            model.load_state_dict(from_jax_params(
                jax.tree_util.tree_map(np.asarray, params), model))
    with jax_kernel_guidance(jmodel), step_traces(jmodel, model) as traces:
        losses = check_exact_step(jmodel, params, model, scene_np, pixel_idx, loose=loose)
    np.testing.assert_array_equal(traces["port"]["mask"], traces["jax"]["mask"])
    return losses


def jax_train_step(jmodel, tv_weight=0.0):
    """JAX's step (clip 1.0, Adam 1e-4), built once: ``run(params,
    scene_np, pixel_idx, key=7)`` steps from ``params`` on image 0 with
    ``PRNGKey(key)`` and returns its loss terms, its clipped gradients (read
    back from the Adam state: after one step ``mu = (1 - b1) *
    clipped_grad``) and its updated parameters, flattened as ``_flatten``
    names them.  Calls on inputs of one shape share one compilation."""
    jloss_cfg = JLossConfig(eikonal_weight=0.1, mask_weight=200.0, alpha=ALPHA,
                            tv_weight=tv_weight)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    step = j_build_train_step(jmodel, jloss_cfg, optimizer)
    to_np = lambda tree: dict(_flatten(jax.tree_util.tree_map(np.asarray, tree)))

    def run(params, scene_np, pixel_idx, key=7):
        # the step donates its state: a copy keeps ``params`` for later calls
        state = {"params": jax.tree_util.tree_map(jnp.copy, params),
                 "opt_state": optimizer.init(params)}
        new_state, jlosses = step(
            state, {k: jnp.asarray(v) for k, v in scene_np.items()}, jnp.asarray([0], jnp.int32),
            jnp.asarray(pixel_idx), jax.random.PRNGKey(key), jnp.asarray(ALPHA, jnp.float32))
        jgrads = {k: v / 0.1 for k, v in to_np(new_state["opt_state"][1][0].mu).items()}
        return {k: float(v) for k, v in jlosses.items()}, jgrads, to_np(new_state["params"])

    return run


def port_step(model, scene_np, pixel_idx, key=7, tv_weight=0.0):
    """The port's step on the same inputs and the draws JAX's takes from
    ``PRNGKey(key)``; the model keeps its gradients and updated weights."""
    losses = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA, tv_weight),
                              make_optimizer(model))(
        scene_to_device(scene_np, "cpu"), torch.tensor([0]),
        torch.as_tensor(pixel_idx).long(), None, ALPHA,
        draws=draws(model, jax.random.PRNGKey(key), len(pixel_idx)))
    return {k: float(v) for k, v in losses.items()}


def step_metrics(model, losses, jlosses, jgrads, jnew):
    """The port's step (``model`` just after it, gradients kept) against
    JAX's (``jgrads``, ``jnew``: ``jax_train_step``'s), leaf by leaf.  Returns
    ``loss_rel`` per loss term and per parameter ``grad_excess`` (the
    largest ``|g - g_jax| - (atol + rtol |g_jax|)`` at ``EXACT``'s gradient
    bounds, NaN counted as +inf), ``grad_rel`` (``|g - g_jax| / |g_jax|``
    in the 2-norm) and, over the entries whose JAX gradient exceeds the
    gradient atol, ``update_abs`` (the largest difference of the updated
    values), ``updated`` and ``within`` (how many differ by at most
    ``EXACT['update_atol']``: Adam's first step moves an entry by about
    lr * sign(g), so one whose gradient changed sign lands 2 lr away).
    ``whole`` holds the relative error of all gradients together and the
    share of updated entries within the atol."""
    assert set(losses) == set(jlosses), (set(losses), set(jlosses))
    tol = EXACT
    out = {"loss_rel": {k: abs(losses[k] - jlosses[k]) / max(abs(jlosses[k]), 1e-30)
                        for k in jlosses},
           "leaves": {}}
    diff_sq = want_sq = updated = within = 0
    for name, p in model.named_parameters():
        transpose = name.endswith(".w") or name.endswith(".v")
        grad = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        grad, new = (grad.T, p.detach().numpy().T) if transpose else (grad, p.detach().numpy())
        want_g, want_new = jgrads[name], jnew[name]
        if name.endswith("table"):  # the JAX page image, as rows
            want_g, want_new = (as_rows(a, *p.shape) for a in (want_g, want_new))
        d = np.abs(grad - want_g)
        excess = np.nan_to_num(d - (tol["grad_atol"] + tol["grad_rtol"] * np.abs(want_g)),
                               nan=np.inf)
        dn, wn = float(np.linalg.norm(d)), float(np.linalg.norm(want_g))
        sel = np.abs(want_g) > tol["grad_atol"]
        up = np.nan_to_num(np.abs(new[sel] - want_new[sel]), nan=np.inf)
        out["leaves"][name] = {
            "grad_excess": float(excess.max()),
            "grad_rel": dn / wn if wn > 0 else (0.0 if dn == 0 else np.inf),
            "update_abs": float(up.max()) if up.size else 0.0,
            "updated": int(up.size), "within": int((up <= tol["update_atol"]).sum())}
        diff_sq, want_sq = diff_sq + dn ** 2, want_sq + wn ** 2
        updated, within = updated + up.size, within + int((up <= tol["update_atol"]).sum())
    out["whole"] = {"grad_rel": float(np.sqrt(diff_sq / want_sq)),
                    "update_share": within / max(updated, 1)}
    return out


def assert_step(metrics, loose=False):
    """``step_metrics`` held at ``EXACT``: every loss term, every gradient
    entry and every updated entry; or at ``LOOSE``: every loss term, the
    whole gradient's relative error and the share of updated entries."""
    bounds = LOOSE if loose else EXACT
    for k, rel in metrics["loss_rel"].items():
        assert rel <= bounds["loss_rtol"], (k, rel)
    if loose:
        whole = metrics["whole"]
        assert whole["grad_rel"] <= LOOSE["grad_rel"], whole
        assert whole["update_share"] >= LOOSE["update_share"], whole
        return
    for name, leaf in metrics["leaves"].items():
        assert leaf["grad_excess"] <= 0, (name, "gradient", leaf)
        assert leaf["update_abs"] <= EXACT["update_atol"], (name, "update", leaf)


def check_exact_step(jmodel, params, model, scene_np, pixel_idx, tv_weight=0.0, loose=False):
    """One step on both sides (the port's from its current weights, which
    are ``params``): losses, clipped gradients and updated parameters, at
    ``EXACT``, or with ``loose`` at ``LOOSE`` (``assert_step``)."""
    jlosses, jgrads, jnew = jax_train_step(jmodel, tv_weight)(params, scene_np, pixel_idx)
    fm.reset_launch_counts()
    losses = port_step(model, scene_np, pixel_idx, tv_weight=tv_weight)
    assert_step(step_metrics(model, losses, jlosses, jgrads, jnew), loose)
    # the CPU runs the kernel's plain twin: no CUDA launch is counted
    assert all(c["launches"] == 0 for c in fm.launch_counts.values())
    return losses


def jax_inputs(scene, img_idx, pixel_idx):
    return {"uv": scene["uv"][pixel_idx][None],
            "intrinsics": scene["intrinsics"][img_idx],
            "pose": scene["pose"][img_idx],
            "object_mask": scene["mask"][img_idx][:, pixel_idx]}


def forward_pair(jmodel, params, model, scene_np, pixel_idx, seed):
    rng = jax.random.PRNGKey(seed)
    inputs = jax_inputs(scene_np, np.asarray([1], np.int32), pixel_idx)
    jout = jax.jit(lambda p: jmodel.apply(p, inputs, rng, training=True))(params)
    with torch.no_grad():
        out = model({k: torch.as_tensor(np.asarray(v)) for k, v in inputs.items()},
                    training=True, draws=draws(model, rng, len(pixel_idx)))
    agree = np.mean(out["network_object_mask"].numpy() == np.asarray(jout["network_object_mask"]))
    return jout, out, agree
