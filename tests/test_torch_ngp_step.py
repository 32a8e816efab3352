"""Train steps of the instant-ngp grid configuration against the JAX package.

``testing.ngp_conf``: HashGridTcnn, 6 levels x 2 features, log2 15 (the
page-path table).  The pruned preset (K=3 of 6 levels, so the pruned encode
and its level-mean fill run) with two guided secant iterations, narrowed
(SDF MLP 8x128, so the port's tracer runs the fused kernel's plain twin),
in 'exact' mode: losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-5, the
Adam update atol 1e-6 (tests/torch_step_parity.py); the same step in
'mixed': hit masks agree on >= 95% of rays and the step is finite.  The
bench.py log2=15 preset at full width on 16 rays, at the same tolerances.
"""

import jax
import numpy as np
import torch

from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.testing import ngp_conf, scene_to_device
from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer

from torch_step_parity import (ALPHA, N_RAYS, check_exact_step, draws, forward_pair, ngp_k3,
                               setup)


def test_ngp_pruned_exact_step_matches_jax():
    """f32 pruned guidance (the pruned encode with its level-mean fill) for
    the march, the coarse probes and two secant steps; decisions on the
    fused f32 path."""
    jmodel, params, model, scene_np, pixel_idx = setup(ngp_k3("exact"))
    _, guidance = model._tracer_sdfs()
    assert set(guidance) == {"march", "coarse", "secant"}
    check_exact_step(jmodel, params, model, scene_np, pixel_idx)


def test_ngp_full_width_step_matches_jax():
    """The log2=15 preset (prune 16/16/4: floor-corner guidance) at its
    published widths."""
    conf = ngp_conf("ngp_log2_15", num_pixels=16)
    conf.put("model.tracer_exact_fused", True)
    check_exact_step(*setup(conf))


def test_ngp_pruned_mixed_step_agrees_with_jax():
    """bf16 pruned guidance (the plain twin here, JAX's jnp bf16 path off the
    TPU), f32 decisions; then a finite train step."""
    jmodel, params, model, scene_np, pixel_idx = setup(ngp_k3("mixed"))
    _, _, agree = forward_pair(jmodel, params, model, scene_np, pixel_idx, seed=11)
    assert agree >= 0.95, agree
    losses = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), make_optimizer(model))(
        scene_to_device(scene_np, "cpu"), torch.tensor([1]), torch.as_tensor(pixel_idx).long(),
        None, ALPHA, draws=draws(model, jax.random.PRNGKey(12), N_RAYS))
    assert all(np.isfinite(float(v)) for v in losses.values())
