"""The port's sphere tracer against the JAX package, same rays and the same
injected uniform draws.

On an analytic SDF both see identical SDF values, so the hit masks must be
identical and distances/points agree to atol 1e-5.  On a small network the
two SDFs differ in float32 rounding, so >= 99% of the masks agree and the
distances of agreeing rays to atol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.networks import ImplicitNetwork as JImplicitNetwork
from hashmodnffbanks_idr_tpu.models.ray_tracing import RayTracerConfig as JCfg
from hashmodnffbanks_idr_tpu.models.ray_tracing import ray_trace as j_ray_trace

from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork
from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import (RayTracerConfig, ray_trace,
                                                              sweep_stride)
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params


def make_rays(n_side, radius=2.0, spread=0.5):
    """Camera at (0, 0, radius) looking at the origin; an n_side^2 fan of
    rays, some hitting a centred object and some missing."""
    a = np.linspace(-spread, spread, n_side)
    ax, ay = np.meshgrid(a, a)
    dirs = np.stack([np.sin(ax), np.sin(ay), -np.cos(ax) * np.cos(ay)], -1).reshape(1, -1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.asarray([[0.0, 0.0, radius]], np.float32), dirs.astype(np.float32)


def draws_from_key(cfg, rng, guided):
    """The uniform draws JAX's tracer takes from ``rng``."""
    stride = sweep_stride(cfg, guided, on_cuda=False)
    if stride is None:
        return {"dense": np.array(jax.random.uniform(rng, (cfg.n_steps,)))}
    rng_c, rng_f = jax.random.split(rng)
    n_c = (cfg.n_steps - 1) // stride + 1
    return {"coarse": np.array(jax.random.uniform(rng_c, (n_c,))),
            "fine": np.array(jax.random.uniform(rng_f, (3 * (stride - 1),)))}


def run_both(cfg_kw, jsdf, sdf, cam, dirs, obj_mask, training, guide=None):
    cfg, jcfg = RayTracerConfig(**cfg_kw), JCfg(**cfg_kw)
    rng = jax.random.PRNGKey(3)
    jguide = tsguide = None
    if guide is not None:
        jguide = {"march": guide[0], "coarse": guide[0]}
        tsguide = {"march": guide[1], "coarse": guide[1]}
    jres = jax.jit(lambda c, m, d: j_ray_trace(jcfg, jsdf, c, m, d, rng, training=training,
                                               sdf_guidance=jguide))(cam, obj_mask, dirs)
    with torch.no_grad():
        res = ray_trace(cfg, sdf, torch.from_numpy(cam), torch.from_numpy(obj_mask),
                        torch.from_numpy(dirs), training=training, sdf_guidance=tsguide,
                        draws=draws_from_key(cfg, rng, guide is not None))
    return jres, res


def sphere(r):
    return (lambda x: jnp.linalg.norm(x, axis=-1) - r,
            lambda x: torch.linalg.vector_norm(x, dim=-1) - r)


def shell(r, w):
    return (lambda x: jnp.abs(jnp.linalg.norm(x, axis=-1) - r) - w,
            lambda x: torch.abs(torch.linalg.vector_norm(x, dim=-1) - r) - w)


# (tracer config, SDFs, share of object-mask pixels).  The shell keeps every
# pixel in the object mask: a ray through it with the mask off takes the
# min-SDF point of its sweep, and the shell's front and back minima tie to
# ~1e-7, below float32 agreement of the two implementations.
CASES = {
    "sphere": (dict(sphere_tracing_iters=20, n_steps=64, line_step_iters=3), sphere(0.5), 0.7),
    "dense": (dict(sphere_tracing_iters=20, n_steps=64, line_step_iters=3,
                   hierarchical_sweep=False), sphere(0.5), 0.7),
    "shell_sampler": (dict(sphere_tracing_iters=5, n_steps=100), shell(0.6, 0.05), 1.0),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_analytic_trace_matches_jax(case, training):
    cfg_kw, (jsdf, sdf), obj_share = CASES[case]
    cam, dirs = make_rays(12)
    obj_mask = np.random.default_rng(0).random(dirs.shape[1]) < obj_share
    jres, res = run_both(cfg_kw, jsdf, sdf, cam, dirs, obj_mask, training)
    np.testing.assert_array_equal(res.network_object_mask.numpy(),
                                  np.asarray(jres.network_object_mask))
    assert res.network_object_mask.any() and not res.network_object_mask.all()
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), rtol=0, atol=1e-5)


def test_guided_trace_matches_jax():
    """The 'mixed' wiring: a biased guidance SDF for the march's phase A and
    the coarse sweep probes, exact decisions."""
    jsdf, sdf = sphere(0.5)
    jguide, guide = sphere(0.52)
    cam, dirs = make_rays(12)
    obj_mask = np.ones(dirs.shape[1], bool)
    jres, res = run_both(dict(sphere_tracing_iters=20, n_steps=100, line_step_iters=3),
                         jsdf, sdf, cam, dirs, obj_mask, True, guide=(jguide, guide))
    np.testing.assert_array_equal(res.network_object_mask.numpy(),
                                  np.asarray(jres.network_object_mask))
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(jres.dists), rtol=0, atol=1e-5)


def test_network_trace_matches_jax():
    kw = dict(feature_vector_size=32, d_in=3, d_out=1, dims=[64] * 6, geometric_init=True,
              bias=0.6, skip_in=[4], weight_norm=True, multires=6,
              embed_type="StyleModNFFB", log2_max_hash_size=5, max_points_per_entry=2,
              base_resolution=16, desired_resolution=512, bound=0.45)
    jnet, net = JImplicitNetwork(**kw), ImplicitNetwork(**kw)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0))
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), net))
    cam, dirs = make_rays(16, spread=0.4)
    obj_mask = np.random.default_rng(1).random(dirs.shape[1]) > 0.2
    jres, res = run_both(dict(sphere_tracing_iters=10, n_steps=28, line_step_iters=3),
                         lambda x: jnet.sdf(params, x), net.sdf, cam, dirs, obj_mask, True)
    m, jm = res.network_object_mask.numpy(), np.asarray(jres.network_object_mask)
    assert m.sum() > 20
    assert np.mean(m == jm) >= 0.99
    agree = m == jm
    np.testing.assert_allclose(res.dists.numpy()[agree], np.asarray(jres.dists)[agree],
                               rtol=0, atol=1e-4)
