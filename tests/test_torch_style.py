"""The port's ``ops/style.py`` against the JAX package's on the same numpy
inputs: AdaIN, Gram matrix and style loss at 1e-6, CORAL at 1e-4 (its
``eigh`` differs in rounding between the frameworks), and
``StyleModulation`` on bridged weights (``weights.from_jax_params``),
forward at 1e-6 and its gradient, with none through the attention.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.ops import style as jstyle

from hashmodnffbanks_idr_tpu_torch.ops import style
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays])


@pytest.mark.parametrize("shape", [(2, 4, 50), (3, 5, 6, 7), (1, 2, 1)])
def test_adain_matches_jax(shape):
    """(N, C, *spatial) with one and several trailing dims; a single
    spatial element takes the unbiased estimator's max(n - 1, 1)."""
    c = RNG.normal(0, 1, shape).astype(np.float32)
    s = RNG.normal(3, 2, shape).astype(np.float32)
    (jc, js), (tc, ts) = _both(c, s)
    np.testing.assert_allclose(style.adaptive_instance_normalization(tc, ts).numpy(),
                               np.asarray(jstyle.adaptive_instance_normalization(jc, js)),
                               rtol=1e-6, atol=1e-6)
    m, sd = style._mean_std(tc)
    jm, jsd = jstyle._mean_std(jc)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C", [3, 8])
def test_coral_matches_jax(C):
    src = RNG.normal(0, 1, (C, 400)).astype(np.float32)
    tgt = (RNG.normal(0, 1, (C, C)) @ RNG.normal(0, 1, (C, 300)) + 2.0).astype(np.float32)
    (js, jt), (ts, tt) = _both(src, tgt)
    got = style.coral(ts, tt).numpy()
    np.testing.assert_allclose(got, np.asarray(jstyle.coral(js, jt)), rtol=1e-4, atol=1e-4)


def test_coral_clamps_a_singular_covariance():
    """A rank-deficient source (two equal rows): eigenvalues below eps are
    clamped, as in JAX, and the result stays finite."""
    src = RNG.normal(0, 1, (4, 200)).astype(np.float32)
    src[1] = src[0]
    tgt = RNG.normal(1, 2, (4, 200)).astype(np.float32)
    (js, jt), (ts, tt) = _both(src, tgt)
    got = style.coral(ts, tt).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jstyle.coral(js, jt)), rtol=1e-4, atol=1e-4)


def test_gram_and_style_loss_match_jax():
    f = RNG.normal(0, 1, (6, 40)).astype(np.float32)
    g = RNG.normal(0, 1, (6, 40)).astype(np.float32)
    (jf, jg), (tf, tg) = _both(f, g)
    np.testing.assert_allclose(style.gram_matrix(tf).numpy(), np.asarray(jstyle.gram_matrix(jf)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(style.style_loss(tf, tg)),
                               float(jstyle.style_loss(jf, jg)), rtol=1e-6)
    assert float(style.style_loss(tf, tf)) == 0.0


@pytest.mark.parametrize("n", [1, 2])
def test_style_modulation_matches_jax(n):
    """``StyleModulation`` (L=3, 28 features) on the JAX module's weights:
    content (3n, 28), style (84, n); the forward at 1e-6 and the gradient of
    a scalar of it to 1e-5 of its largest element.  The attention gets no
    gradient on either side."""
    jmod = jstyle.StyleModulation()
    params = jmod.init(jax.random.PRNGKey(3))
    mod = style.StyleModulation()
    mod.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), mod))
    content = RNG.normal(0, 1, (3 * n, 28)).astype(np.float32)
    sty = RNG.normal(0.5, 2, (84, n)).astype(np.float32)
    w = RNG.normal(0, 1, (3, 28) if n == 1 else (n, 3, 28)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jmod.apply(p, jnp.asarray(content), jnp.asarray(sty)) * w)

    out = mod(torch.as_tensor(content), torch.as_tensor(sty))
    jout = jmod.apply(params, jnp.asarray(content), jnp.asarray(sty))
    assert out.shape == jout.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)

    (out * torch.as_tensor(w)).sum().backward()
    jgrad = jax.grad(jloss)(params)
    for k, got in (("w", mod.linear_transform.w.grad.numpy().T),
                   ("b", mod.linear_transform.b.grad.numpy())):
        want = np.asarray(jgrad["linear_transform"][k])
        # float32 rounding through the norm: both sides sit within 1e-5 of
        # the largest element of the float64 gradient
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=k)
    assert mod.attention.w.grad is None and mod.attention.b.grad is None
    assert not np.asarray(jgrad["attention"]["w"]).any()


def test_style_modulation_init_is_torch_default():
    mod = style.StyleModulation(feature_vector_size=16).reset_parameters(
        torch.Generator().manual_seed(0))
    for lin in (mod.linear_transform, mod.attention):
        bound = 1.0 / np.sqrt(16)
        assert lin.w.abs().max() <= bound and lin.b.abs().max() <= bound
        assert lin.w.abs().max() > 0.5 * bound
