"""One flagship-shaped train step of the PyTorch port against the JAX package.

A small fusion-eligible conf (implicit dims [128]*8 so ``supports_fusion``
holds and the port's tracer goes through ``fused_sdf_raw``, here its plain
twin on the CPU), and the flagship itself at full width (8x512 SDF MLP,
4x512 rendering MLP, 256 features, 100 tracer steps) on a few rays: the
same weights (``from_jax_params``), the same pixels and the same random
draws: the JAX step's draws are regenerated from its key and injected into
the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.loss import IDRLossConfig as JLossConfig
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.data.scene_dataset import rgb_to_pm1 as j_rgb_to_pm1
from hashmodnffbanks_idr_tpu.testing import flagship_conf as j_flagship_conf
from hashmodnffbanks_idr_tpu.testing import synthetic_scene
from hashmodnffbanks_idr_tpu.train.trainer import build_train_step as j_build_train_step

from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device
from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
from hashmodnffbanks_idr_tpu_torch.weights import _flatten, from_jax_params

N_RAYS = 64
ALPHA = 50.0


def _patch(conf, mode, view, narrow=True):
    if narrow:
        conf.put("model.implicit_network.dims", [128] * 8)
        conf.put("model.rendering_network.dims", [64, 64])
        conf.put("model.feature_vector_size", 32)
        conf.put("model.ray_tracer.n_steps", 28)      # hierarchical stride 9
    conf.put("model.tracer_fast", mode)
    conf.put("model.tracer_exact_fused", True)
    conf.put("model.rendering_network.viewdirs_embed_type", view)
    return conf


def _setup(mode, view="StyleModNFFB", narrow=True, n_rays=N_RAYS):
    jconf = _patch(j_flagship_conf(num_pixels=n_rays), mode, view, narrow).get_config("model")
    jmodel = JIDRNetwork(jconf)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = IDRNetwork(_patch(flagship_conf(num_pixels=n_rays), mode, view,
                              narrow).get_config("model"), device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(from_jax_params(params_np, model))
    scene_np = synthetic_scene(n_views=2, img_res=(32, 32), seed=0)
    pixel_idx = np.random.default_rng(3).permutation(32 * 32)[:n_rays]
    return jmodel, params, model, scene_np, pixel_idx


def _draws(model, rng, guided, n_rays=N_RAYS):
    """The uniform draws the JAX step takes from ``rng`` (renderer.py:165,
    ray_tracing.py:368-393, renderer.py:189-191), for injection."""
    rng_trace, rng_eik = jax.random.split(rng)
    cfg = model.ray_tracer
    stride = sweep_stride(cfg, guided, on_cuda=False)
    n_c, n_f = (cfg.n_steps - 1) // stride + 1, 3 * (stride - 1)
    rng_c, rng_f = jax.random.split(rng_trace)
    bb = model.object_bounding_sphere
    return {
        "coarse": np.array(jax.random.uniform(rng_c, (n_c,))),
        "fine": np.array(jax.random.uniform(rng_f, (n_f,))),
        "eik": np.array(jax.random.uniform(rng_eik, (n_rays // 2, 3), minval=-bb, maxval=bb)),
    }


def _jax_inputs(scene, img_idx, pixel_idx):
    return ({"uv": scene["uv"][pixel_idx][None],
             "intrinsics": scene["intrinsics"][img_idx],
             "pose": scene["pose"][img_idx],
             "object_mask": scene["mask"][img_idx][:, pixel_idx]},
            j_rgb_to_pm1(scene["rgb"][img_idx][:, pixel_idx]))


@pytest.mark.parametrize("view", ["StyleModNFFB", "SHEncoder"])
def test_exact_fused_step_matches_jax(view):
    """Loss, clipped gradients and Adam-updated parameters of one step, with
    the flagship's deep view embedder and with SH (every conf's)."""
    _check_exact_step(*_setup("exact", view), n_rays=N_RAYS)


def test_full_width_step_matches_jax():
    """The flagship step at its published widths (``flagship_conf``
    unnarrowed) on 16 rays, at the width-128 case's tolerances."""
    n_rays = 16
    _check_exact_step(*_setup("exact", narrow=False, n_rays=n_rays), n_rays=n_rays)


def _check_exact_step(jmodel, params, model, scene_np, pixel_idx, n_rays):
    """One step on both sides.  The JAX gradients are read back from its
    Adam state: after one step ``mu = (1 - b1) * clipped_grad``."""
    rng = jax.random.PRNGKey(7)
    img_idx = np.asarray([0], np.int32)
    jloss_cfg = JLossConfig(eikonal_weight=0.1, mask_weight=200.0, alpha=ALPHA)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    state = {"params": params, "opt_state": optimizer.init(params)}
    scene_j = {k: jnp.asarray(v) for k, v in scene_np.items()}
    new_state, jlosses = j_build_train_step(jmodel, jloss_cfg, optimizer)(
        state, scene_j, jnp.asarray(img_idx), jnp.asarray(pixel_idx), rng,
        jnp.asarray(ALPHA, jnp.float32))
    to_np = lambda tree: dict(_flatten(jax.tree_util.tree_map(np.asarray, tree)))
    jgrads = {k: v / 0.1 for k, v in to_np(new_state["opt_state"][1][0].mu).items()}
    jnew = to_np(new_state["params"])

    fm.reset_launch_counts()
    losses = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), make_optimizer(model))(
        scene_to_device(scene_np, "cpu"), torch.as_tensor(img_idx).long(),
        torch.as_tensor(pixel_idx).long(), None, ALPHA,
        draws=_draws(model, rng, guided=False, n_rays=n_rays))
    for k in ("loss", "rgb_loss", "eikonal_loss", "mask_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)

    for name, p in model.named_parameters():
        transpose = name.endswith(".w") or name.endswith(".v")
        grad = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        grad, new = (grad.T, p.detach().numpy().T) if transpose else (grad, p.detach().numpy())
        np.testing.assert_allclose(grad, jgrads[name], rtol=1e-3, atol=1e-5, err_msg=name)
        sel = np.abs(jgrads[name]) > 1e-5
        np.testing.assert_allclose(new[sel], jnew[name][sel], rtol=0, atol=1e-6, err_msg=name)
    # the CPU runs the kernel's plain twin: no CUDA launch is counted
    assert all(c["launches"] == 0 for c in fm.launch_counts.values())


def test_mixed_step_agrees_with_jax():
    jmodel, params, model, scene_np, pixel_idx = _setup("mixed")
    rng = jax.random.PRNGKey(11)
    img_idx = np.asarray([1], np.int32)
    inputs, _ = _jax_inputs(scene_np, img_idx, pixel_idx)
    jout = jax.jit(lambda p: jmodel.apply(p, inputs, rng, training=True))(params)

    draws = _draws(model, rng, guided=True)
    out = model({k: torch.as_tensor(np.asarray(v)) for k, v in inputs.items()},
                training=True, draws=draws)
    agree = np.mean(out["network_object_mask"].numpy() == np.asarray(jout["network_object_mask"]))
    assert agree >= 0.95, agree

    scene = scene_to_device(scene_np, "cpu")
    img_t, pix_t = torch.as_tensor(img_idx).long(), torch.as_tensor(pixel_idx).long()
    loss_cfg = IDRLossConfig(eikonal_weight=0.1, mask_weight=200.0, alpha=ALPHA)
    losses = build_train_step(model, loss_cfg, make_optimizer(model))(
        scene, img_t, pix_t, None, ALPHA, draws=draws)
    assert all(np.isfinite(float(v)) for v in losses.values())
