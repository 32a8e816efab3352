"""The anchor witness (scripts/anchor_witness.py) at narrow widths.

Arm A (the JAX package at float32) and arm C (the port) take three
consecutive steps from the same weights and the same inputs (``plan``:
images, pixels and keys from one numpy stream; the runners' LR and alpha):
the loss terms of every step agree within 1e-3 relative, and every
parameter after the third step within 3e-4, three Adam steps of lr 1e-4:
a component whose gradient is near 0 may step either way.  In each tensor
the median difference stays below 1e-8 and at most 2% of the entries
differ by more than 1e-6.  The conf is the anchor's at narrow widths, its
milestones moved to epoch 1 so that the third step takes the second
epoch's LR and alpha.

Arm B's rounding (``bf16_passes``) is not a no-op: a product, its
gradient and a gradient's gradient move by bf16 rounding, while the same
product outside the context stays bit for bit what plain JAX gives.
``jax.default_matmul_precision("bfloat16")`` cannot stand in for it: on
the CPU the product keeps its bits.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.testing import synthetic_scene
from hashmodnffbanks_idr_tpu_torch.weights import _flatten

_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                     "anchor_witness.py")
_spec = importlib.util.spec_from_file_location("anchor_witness", _path)
witness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(witness)


def _narrow_conf_text(n_rays=64):
    """The anchor's conf at narrow widths, its milestones at epoch 1."""
    conf = parse_file(witness.CONF)
    conf.put("train.num_pixels", n_rays)
    conf.put("model.implicit_network.dims", [64] * 8)
    conf.put("model.rendering_network.dims", [64, 64])
    conf.put("model.feature_vector_size", 32)
    conf.put("model.ray_tracer.n_steps", 28)
    conf.put("train.sched_milestones", [1])
    conf.put("train.alpha_milestones", [1])
    return conf.dump()


def test_jax_and_port_agree_over_three_steps():
    text = _narrow_conf_text()
    scene = synthetic_scene(n_views=2, img_res=(32, 32), seed=0)
    params = witness.init_params(text, seed=0)
    jarm = witness.JaxArm(text, params, steps_per_epoch=2)
    parm = witness.PortArm(text, jarm.params_numpy(), steps_per_epoch=2)
    steps = list(witness.plan(1, 1, 2, 32 * 32, 64))[:3]
    assert [s[0] for s in steps] == [0, 0, 1]  # the third step takes epoch 1's LR and alpha
    for epoch, count, img, pixels, key in steps:
        jl = jarm.step(scene, epoch, img, pixels, key)
        pl = parm.step(scene, epoch, img, pixels, key, count)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=1e-3, err_msg=f"step {count}: {k}")
    jp = dict(_flatten(jarm.params_numpy()))
    for name, p in parm.model.named_parameters():
        new = p.detach().numpy()
        want = jp[name].T if name.endswith(".w") or name.endswith(".v") else jp[name]
        diff = np.abs(new - want)
        assert diff.max() <= 3e-4, (name, diff.max())
        assert np.median(diff) <= 1e-8 and (diff > 1e-6).mean() <= 0.02, name


def test_bf16_passes_round_every_dot():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)

    def rnd(v):
        return np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32), np.float64)

    def loss(a, b):
        return jnp.sum((a @ b) * w)

    def eikonal_like(a, b):
        inner = jax.grad(lambda aa: jnp.sum(jnp.tanh(aa @ b)))(a)
        return jnp.sum(inner ** 2)

    plain = np.asarray(jax.jit(lambda a, b: a @ b)(a, b))
    plain2 = np.asarray(jax.jit(jax.grad(eikonal_like, argnums=1))(a, b))
    # why the emulation rounds by itself: on the CPU the precision setting
    # changes no product
    with jax.default_matmul_precision("bfloat16"):
        np.testing.assert_array_equal(np.asarray(jax.jit(lambda a, b: a @ b)(a, b)), plain)
    with witness.bf16_passes():
        prod = np.asarray(jax.jit(lambda a, b: a @ b)(a, b))
        einsum = np.asarray(jax.jit(lambda a, b: jnp.einsum("ij,jk->ik", a, b))(a, b))
        grad_a = np.asarray(jax.jit(jax.grad(loss))(a, b))
        second = np.asarray(jax.jit(jax.grad(eikonal_like, argnums=1))(a, b))
    after = np.asarray(jax.jit(lambda a, b: a @ b)(a, b))

    exact = a.astype(np.float64) @ b
    rounded = rnd(a) @ rnd(b)
    # the product is that of the rounded operands, accumulated in float32
    assert np.abs(prod - rounded).max() <= 1e-5
    assert np.abs(einsum - rounded).max() <= 1e-5
    # and it is not the float32 product: bf16 rounding moves it
    assert np.abs(prod - exact).max() >= 1e-2 > np.abs(plain - exact).max()
    # the gradient's dot rounds its cotangent and its saved operand
    assert np.abs(grad_a - rnd(w) @ rnd(b).T).max() <= 1e-5
    assert np.abs(grad_a - w.astype(np.float64) @ b.T).max() >= 1e-2
    # a gradient's gradient moves too
    assert np.abs(second - plain2).max() >= 1e-3 * np.abs(plain2).max()
    # outside the context JAX is itself again, bit for bit
    np.testing.assert_array_equal(after, plain)
