"""Train steps of the instant-ngp grid configuration against the JAX package.

``testing.ngp_conf``: HashGridTcnn, 6 levels x 2 features, log2 15 (the
page-path table).  The pruned preset (K=3 of 6 levels, so the pruned encode
and its level-mean fill run) with two guided secant iterations, narrowed
(SDF MLP 8x128, so the port's tracer runs the fused kernel's plain twin),
in 'exact' mode: losses rtol 1e-4, gradients rtol 1e-3 / atol 1e-5, the
Adam update atol 1e-6 (tests/torch_step_parity.py).  The bench.py log2=15
preset at full width on 16 rays, at the same tolerances.

The same two presets in 'mixed' (bf16 guidance, f32 decisions), narrowed,
the log2=15 one with the floor-only guidance and four guided secant steps
of ``dtu_shaped_hashgridtcnn.conf`` (``check_mixed_step``).  With the
port's guidance in JAX's tracer the traces agree ray for ray and the step
holds the exact bounds tensor by tensor (on the log2=15 preset without the
one ray whose float32 camera ray takes another root there).  Through
JAX's kernel path the hit masks are equal ray for ray and the step holds
``torch_step_parity.LOOSE``: loss terms within 5e-2, the whole gradient
within 0.2 relative, 95% of the updated entries within 1e-6.  The two
guidances differ by bf16 rounding flips (about half of the raw SDFs, up
to 1.8e-3, from the same weights and inputs), which move a third of the
rays' guided secant roots and fallback points (ROADMAP §3, "Bounded
limits"; scripts/mixed_parity_report.py).
"""

from torch_step_parity import check_exact_step, check_mixed_step, narrow, ngp_k3, setup
from hashmodnffbanks_idr_tpu_torch.testing import ngp_conf


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
    """bf16 pruned guidance (K=3 levels, two guided secant steps).  With the
    same guidance the step holds the exact step's bounds."""
    check_mixed_step(*setup(ngp_k3("mixed")), loose=True, same_guidance_step=True)


def test_ngp_floor_guided_mixed_step_agrees_with_jax():
    """The log2=15 preset's floor-only guidance over all 16 levels with four
    guided secant steps, as ``dtu_shaped_hashgridtcnn.conf`` runs it.  With
    the same guidance the step holds the exact step's bounds."""
    check_mixed_step(*setup(narrow(ngp_conf("ngp_log2_15", num_pixels=64), "mixed")),
                     loose=True, same_guidance_step=True)
