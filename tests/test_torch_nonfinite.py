"""The edges where a train step can turn non-finite, in both packages.

``sample_network`` divides by ``grad . dir`` on every valid surface ray
(JAX ``models/sample_network.py``).  The renderer hands it
``sdf_output - sdf_output.detach()``, which is exactly 0, so a valid ray
whose ``grad . dir`` is 0 gives 0 / 0.  So does one whose ``grad . dir`` is
subnormal, in JAX because XLA flushes subnormals to 0, in the port because
its ``sample_network`` flushes the denominator (without that it gave a
finite point whose gradient overflowed).  A tiny normal one gives a finite
point and a gradient of 1e20.  The
guided secant can meet a bracket whose two bf16 guidance values are equal
(a plateau of the floor-only guidance), where its prediction divides by 0
and is clamped into the bracket (JAX ``models/ray_tracing.py:_secant``).

Each edge runs through both packages on the same inputs; the port must
give what JAX gives, value for value, NaN where JAX gives NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu.models import ray_tracing as j_rt
from hashmodnffbanks_idr_tpu.models.sample_network import sample_network as j_sample_network

from hashmodnffbanks_idr_tpu_torch.models import ray_tracing as rt
from hashmodnffbanks_idr_tpu_torch.models.sample_network import sample_network

# grad . dir of ray 0; rays 1-2 are ordinary surface rays, ray 3 is masked out
DOTS = {"zero": 0.0, "subnormal": 1e-40, "tiny": 1e-20}


def _rays(dot0):
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(4, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    grad = rng.normal(size=(4, 3)).astype(np.float32)
    # ray 0 along x: grad . dir is exactly dot0
    dirs[0] = (1.0, 0.0, 0.0)
    grad[0, 0] = dot0
    return {"out": rng.normal(size=(4, 1)).astype(np.float32) * 1e-3,
            "grad": grad, "dists": np.full((4, 1), 2.0, np.float32),
            "cam": np.tile(np.float32([[0.0, 0.0, 3.0]]), (4, 1)), "dirs": dirs,
            "valid": np.array([True, True, True, False])}


def _jax_side(r):
    def points(out):
        return j_sample_network(out, jax.lax.stop_gradient(out), r["grad"], r["dists"],
                                r["cam"], r["dirs"], valid_mask=jnp.asarray(r["valid"]))

    pts = points(jnp.asarray(r["out"]))
    grad = jax.grad(lambda out: jnp.sum(points(out)))(jnp.asarray(r["out"]))
    return np.asarray(pts), np.asarray(grad)


def _port_side(r):
    out = torch.tensor(r["out"], requires_grad=True)
    pts = sample_network(out, out.detach(), torch.tensor(r["grad"]), torch.tensor(r["dists"]),
                         torch.tensor(r["cam"]), torch.tensor(r["dirs"]),
                         valid_mask=torch.tensor(r["valid"]))
    pts.sum().backward()
    return pts.detach().numpy(), out.grad.numpy()


@pytest.mark.parametrize("edge", sorted(DOTS))
def test_sample_network_edge_matches_jax(edge):
    """A valid ray with ``grad . dir`` 0, subnormal or tiny: the point and
    its gradient as JAX gives them, NaN and inf where JAX gives them; the
    other rays finite and equal."""
    r = _rays(DOTS[edge])
    jp, jg = _jax_side(r)
    tp, tg = _port_side(r)
    np.testing.assert_array_equal(np.isnan(tp), np.isnan(jp))
    np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
    np.testing.assert_array_equal(np.isinf(tg), np.isinf(jg))
    fin_p, fin_g = np.isfinite(jp), np.isfinite(jg)
    np.testing.assert_allclose(tp[fin_p], jp[fin_p], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg[fin_g], jg[fin_g], rtol=1e-6)
    assert np.isfinite(jp[1:]).all() and np.isfinite(jg[1:]).all()
    if edge != "tiny":
        assert np.isnan(jp[0]).all()  # 0 / 0: the step's loss turns NaN in both


SECANT_CASES = {
    # both bracket values equal and positive, equal and negative, both 0
    "equal_positive": 0.0078125,
    "equal_negative": -0.0078125,
    "equal_zero": 0.0,
}


@pytest.mark.parametrize("case", sorted(SECANT_CASES))
def test_guided_secant_with_equal_bracket_values_matches_jax(case):
    """Four guided iterations on a bf16 plateau (the guide returns the
    bracket's own value everywhere), then the exact re-validation and four
    exact iterations: the root as JAX finds it, finite."""
    v = np.float32(SECANT_CASES[case])
    n = 8
    rng = np.random.default_rng(1)
    cam = np.tile(np.float32([[0.0, 0.0, 3.0]]), (n, 1))
    dirs = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    z_low = (1.5 + 0.1 * rng.random(n)).astype(np.float32)
    z_high = (z_low + 0.5).astype(np.float32)
    bracket = np.full(n, v, np.float32)
    active = np.arange(n) % 4 != 3
    cfg = dict(n_secant_steps=8, prune_secant_iters=4)

    def exact(p):
        return p[:, 2] - 1.0  # the plane z = 1: the root at distance 2, inside every bracket

    j_cfg = j_rt.RayTracerConfig(**cfg)
    j_z = j_rt._secant(j_cfg, exact, jnp.asarray(bracket),
                       jnp.asarray(bracket), jnp.asarray(z_low), jnp.asarray(z_high),
                       jnp.asarray(cam), jnp.asarray(dirs), jnp.asarray(active),
                       sdf_guide=lambda p: jnp.full(p.shape[:1], v))
    t_z = rt._secant(rt.RayTracerConfig(**cfg), exact, torch.tensor(bracket),
                     torch.tensor(bracket), torch.tensor(z_low), torch.tensor(z_high),
                     torch.tensor(cam), torch.tensor(dirs), torch.tensor(active),
                     sdf_guide=lambda p: torch.full(p.shape[:1], float(v)))
    j_z = np.asarray(j_z)
    assert np.isfinite(j_z).all()
    np.testing.assert_allclose(t_z.numpy(), j_z, rtol=0, atol=1e-6)
