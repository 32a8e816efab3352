"""Shared set-up of the train-step parity tests of the hash-grid and
classic-encoder configurations (tests/test_torch_ngp_step.py,
tests/test_torch_classic_step.py): the narrowed confs, the same weights on both
sides (``from_jax_params``), the JAX step's draws for injection, and one
step held against JAX (losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-5,
the Adam update atol 1e-6, as tests/test_torch_train_step.py holds the
flagship).
"""

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


def check_exact_step(jmodel, params, model, scene_np, pixel_idx, tv_weight=0.0):
    """One step on both sides: losses, clipped gradients (read back from
    JAX's Adam state: after one step ``mu = (1 - b1) * clipped_grad``) and
    the updated parameters."""
    n_rays = len(pixel_idx)
    rng = jax.random.PRNGKey(7)
    img_idx = np.asarray([0], np.int32)
    jloss_cfg = JLossConfig(eikonal_weight=0.1, mask_weight=200.0, alpha=ALPHA,
                            tv_weight=tv_weight)
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
    losses = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA, tv_weight),
                              make_optimizer(model))(
        scene_to_device(scene_np, "cpu"), torch.as_tensor(img_idx).long(),
        torch.as_tensor(pixel_idx).long(), None, ALPHA,
        draws=draws(model, rng, n_rays))
    assert set(losses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)

    for name, p in model.named_parameters():
        transpose = name.endswith(".w") or name.endswith(".v")
        grad = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        grad, new = (grad.T, p.detach().numpy().T) if transpose else (grad, p.detach().numpy())
        want_g, want_new = jgrads[name], jnew[name]
        if name.endswith("table"):  # the JAX page image, as rows
            want_g, want_new = (as_rows(a, *p.shape) for a in (want_g, want_new))
        np.testing.assert_allclose(grad, want_g, rtol=1e-3, atol=1e-5, err_msg=name)
        sel = np.abs(want_g) > 1e-5
        np.testing.assert_allclose(new[sel], want_new[sel], rtol=0, atol=1e-6, err_msg=name)
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
