"""Train steps with the grid TV loss, the classic encoders and the ablation
rendering modes, and the 'fast' tracer, against the JAX package.

Narrowed steps (SDF MLP 8x128, tests/torch_step_parity.py) held at the
flagship step's tolerances (losses rtol 1e-4, gradients rtol 1e-3 / atol
1e-5, the Adam update atol 1e-6): the grid TV term (``tv_weight > 0``, at
the traced points, into the table) on the pruned ngp preset; the dummy
conf's FourierFeatures SDF encoder with the classic ``nerfpos`` view
embedding; and the ablation study's 'no_view_dir' and 'no_normal' modes on
NerfPos SDF encoders.

The 'fast' tracer runs every tracer query in bf16.  Off the TPU the JAX
renderer takes its jnp bf16 path, which rounds the skip input after scaling
it; here its bf16 queries go through ``make_fast_sdf(..., interpret=True)``
instead (``jax_kernel_guidance``), the Pallas kernel that the port's fused
kernel replaces and whose rounding its plain twin follows.  Hit masks agree on >= 99% of rays; hit
distances differ by bf16 noise in the secant's root: median <= 2e-3, max
<= 2e-2 (on rays at distance 1.4-2).
"""

import numpy as np
import pytest

from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf

from torch_step_parity import (N_RAYS, check_exact_step, classic_conf, forward_pair,
                               jax_kernel_guidance, narrow, ngp_k3, setup)


@pytest.mark.parametrize("case", ["tv_ngp", "nerfpos_view", "no_view_dir", "no_normal"])
def test_classic_and_tv_steps_match_jax(case):
    """dtu_no_view_dir.conf builds no view embedder (multires_view 0);
    dtu_no_normal.conf feeds raw views, since only mode 'idr' embeds them."""
    conf, tv = {
        "tv_ngp": (ngp_k3("exact"), 0.1),
        "nerfpos_view": (classic_conf("exact", "idr", "FourierFeatures", "NerfPos", 4, 9), 0.0),
        "no_view_dir": (classic_conf("exact", "no_view_dir", "NerfPos", "NerfPos", 0, 6), 0.0),
        "no_normal": (classic_conf("exact", "no_normal", "NerfPos", "NerfPos", 4, 6), 0.0),
    }[case]
    losses = check_exact_step(*setup(conf), tv_weight=tv)
    assert ("tv_loss" in losses) == (tv > 0)


def test_fast_tracer_matches_jax_kernel_path():
    conf = narrow(flagship_conf(num_pixels=N_RAYS), "fast", view="StyleModNFFB")
    jmodel, params, model, scene_np, pixel_idx = setup(conf, perturb=False)
    with jax_kernel_guidance(jmodel):
        jout, out, agree = forward_pair(jmodel, params, model, scene_np, pixel_idx, seed=13)
    assert agree >= 0.99, agree
    hit = out["network_object_mask"].numpy() & np.asarray(jout["network_object_mask"])
    diff = np.abs(out["dists"].numpy()[hit] - np.asarray(jout["dists"])[hit])
    assert hit.sum() > 0 and np.median(diff) <= 2e-3 and diff.max() <= 2e-2, diff
