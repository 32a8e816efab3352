"""The port's sharded train step on a 2x2 ('data', 'model') mesh of four
gloo ranks on the CPU, against the one-rank port step and the JAX
one-device step.

The narrow flagship conf (``flagship_conf(small=True)``), 64 rays of a
32x32 two-view scene, and ``min_table_rows=8`` so that both NFFB tables
(192 and 64 rows) are row-sharded over 'model', as the JAX toy dry run
shards them.  One spawn of four ranks runs every case; each case starts
from the same bridged weights:

* ``jax``: the JAX step's draws injected (the JAX counterpart of this file
  is tests/test_sharding_equivalence.py);
* ``generator``: the draws from a seeded generator on every rank;
* ``no_hit``: rank 3's rays all fall outside the object mask, so its
  shard has no surface hit;
* ``cameras``: the trainable-camera step (pose table + SparseAdam);
* ``nonfinite``: the camera step at alpha NaN, whose loss and gradient
  are NaN: every rank skips its update.
"""

import math

import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.loss import IDRLossConfig as JLossConfig
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.testing import flagship_conf as j_flagship_conf
from hashmodnffbanks_idr_tpu.testing import synthetic_scene
from hashmodnffbanks_idr_tpu.train.trainer import build_train_step as j_build_train_step

from hashmodnffbanks_idr_tpu_torch.geometry.cameras import rot_to_quat
from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import sweep_stride
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.parallel import multihost
from hashmodnffbanks_idr_tpu_torch.parallel.sharding import REPLICATED, ROWS, param_sharding
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, ngp_conf
from hashmodnffbanks_idr_tpu_torch.weights import _flatten, from_jax_params

import torch_dist_workers as workers

N_RAYS = 64
WORLD, N_MODEL = 4, 2
ALPHA = workers.ALPHA
CASES = ("jax", "generator", "no_hit", "cameras")
STEPS = CASES + ("nonfinite",)   # every step the ranks take


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_draws(model, rng, n_rays):
    """The uniform draws the JAX step takes from ``rng`` (renderer.py:165,
    ray_tracing.py:164 or :368-393, renderer.py:186-191), for injection."""
    rng_trace, rng_eik = jax.random.split(rng)
    cfg = model.ray_tracer
    stride = sweep_stride(cfg, False, on_cuda=False)
    bb = model.object_bounding_sphere
    draws = {"eik": np.array(jax.random.uniform(rng_eik, (n_rays // 2, 3),
                                                minval=-bb, maxval=bb))}
    if stride is None:
        draws["dense"] = np.array(jax.random.uniform(rng_trace, (cfg.n_steps,)))
    else:
        rng_c, rng_f = jax.random.split(rng_trace)
        draws["coarse"] = np.array(jax.random.uniform(rng_c, ((cfg.n_steps - 1) // stride + 1,)))
        draws["fine"] = np.array(jax.random.uniform(rng_f, (3 * (stride - 1),)))
    return draws


@pytest.fixture(scope="module")
def run():
    jconf = j_flagship_conf(num_pixels=N_RAYS, small=True)
    jmodel = JIDRNetwork(jconf.get_config("model"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    # spread the table and the layers that read the encoding (which the
    # geometric init leaves at 1e-4 and zero) as training would, so that the
    # SDF table gets a gradient (tests/torch_step_parity.py:setup)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    impl = params["implicit_network"]
    t = impl["embed"]["grid"]["table"]
    impl["embed"]["grid"]["table"] = t + 0.02 * jax.random.normal(keys[0], t.shape)
    for key, lin in zip(keys[1:], (impl["lin"][0], impl["lin"][4])):
        lin["v"] = lin["v"] + 0.1 * jax.random.normal(key, lin["v"].shape)
    conf = flagship_conf(num_pixels=N_RAYS, small=True)
    model = IDRNetwork(conf.get_config("model"), device="cpu")
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, params), model)
    model.load_state_dict(state)
    scene = synthetic_scene(n_views=2, img_res=(32, 32), seed=0)
    pixel_idx = np.random.default_rng(3).permutation(32 * 32)[:N_RAYS]
    # no_hit: rank 3 renders the last 16 rays, all outside image 0's mask
    inside, outside = (np.flatnonzero(scene["mask"][0] == m) for m in (True, False))
    rng = np.random.default_rng(4)
    no_hit = np.concatenate([rng.permutation(inside)[:48], rng.permutation(outside)[:16]])
    pose = scene["pose"]
    pose_vecs = np.concatenate([rot_to_quat(pose[:, :3, :3]), pose[:, :3, 3]], 1)
    jrng = jax.random.PRNGKey(7)
    cases = {
        "jax": {"img_idx": [0], "pixel_idx": pixel_idx,
                "draws": _jax_draws(model, jrng, N_RAYS)},
        "generator": {"img_idx": [1], "pixel_idx": pixel_idx[::-1].copy(), "seed": 5},
        "no_hit": {"img_idx": [0], "pixel_idx": no_hit, "seed": 6},
        "cameras": {"img_idx": [1], "pixel_idx": pixel_idx,
                    "pose_vecs": pose_vecs.astype(np.float32), "seed": 8},
        "nonfinite": {"img_idx": [1], "pixel_idx": pixel_idx, "alpha": float("nan"),
                      "pose_vecs": pose_vecs.astype(np.float32), "seed": 9},
    }
    single = {}
    for name, case in cases.items():
        m = IDRNetwork(conf.get_config("model"), device="cpu")
        m.load_state_dict(state)
        single[name] = workers.run_step(m, scene, case)
    args = (conf.dump(), state, scene, [cases[c] for c in STEPS], N_MODEL, 8)
    try:
        ranks = multihost.spawn(workers.sharded_steps, WORLD, args=args, device="cpu",
                                timeout=240)
    except RuntimeError as e:  # a lost race for the port: once more on another
        if "address already in use" not in str(e).lower():
            raise
        ranks = multihost.spawn(workers.sharded_steps, WORLD, args=args, device="cpu",
                                timeout=240)
    sharded = {c: [r[i] for r in ranks] for i, c in enumerate(STEPS)}
    return types.SimpleNamespace(jmodel=jmodel, params=params, scene=scene, cases=cases,
                                 single=single, sharded=sharded, jrng=jrng, state=state)


def _full_table(rank_outs, name):
    """A sharded table's value/gradient rows from the ranks of 'model'
    group 0 (ranks 0 and 1), whole."""
    return {k: np.concatenate([rank_outs[r]["shards"][name][k] for r in range(N_MODEL)])
            for k in ("value", "grad")}


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_single_rank(run, case):
    """Losses to rtol 2e-4 / atol 1e-6 and every parameter after the step
    to rtol 5e-4 / atol 2e-6 (tests/test_sharding_equivalence.py's bounds),
    on every rank; the cameras' table and SparseAdam state too."""
    single = run.single[case]
    assert single["losses"]["rgb_loss"] > 0, "no ray hit the surface: the case means little"
    for r, out in enumerate(run.sharded[case]):
        for k, v in single["losses"].items():
            np.testing.assert_allclose(out["losses"][k], v, rtol=2e-4, atol=1e-6,
                                       err_msg=f"rank {r} loss {k}")
        for n, p in single["params"].items():
            np.testing.assert_allclose(out["params"][n], p, rtol=5e-4, atol=2e-6,
                                       err_msg=f"rank {r} param {n}")
        if case == "cameras":
            np.testing.assert_allclose(out["pose_vecs"], single["pose_vecs"],
                                       rtol=5e-4, atol=2e-6)
            for k in ("m", "v"):
                np.testing.assert_allclose(out["cam_opt"][k], single["cam_opt"][k],
                                           rtol=5e-4, atol=2e-6)
            assert int(out["cam_opt"]["step"]) == 1
            assert np.abs(out["pose_vecs"] - run.cases[case]["pose_vecs"]).max() > 0


def test_sharded_step_matches_jax(run):
    """The sharded step against the JAX one-device step on the same weights
    and draws, at tests/test_torch_train_step.py's bounds for the narrow
    step: losses rtol 1e-4, clipped gradients rtol 1e-3 / atol 1e-5 (JAX's
    read back from Adam: mu = 0.1 * grad after one step), the updated
    parameters atol 1e-6.  A sharded table's gradient and value are its
    two ranks' rows put together."""
    case = run.cases["jax"]
    jloss_cfg = JLossConfig(eikonal_weight=0.1, mask_weight=200.0, alpha=ALPHA)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    # the JAX step donates its state: give it a copy
    params = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), run.params)
    state = {"params": params, "opt_state": optimizer.init(params)}
    scene_j = {k: jnp.asarray(v) for k, v in run.scene.items()}
    new_state, jlosses = j_build_train_step(run.jmodel, jloss_cfg, optimizer)(
        state, scene_j, jnp.asarray(case["img_idx"], jnp.int32),
        jnp.asarray(case["pixel_idx"], jnp.int32), run.jrng, jnp.asarray(ALPHA, jnp.float32))
    to_np = lambda tree: dict(_flatten(jax.tree_util.tree_map(np.asarray, tree)))
    jgrads = {k: v / 0.1 for k, v in to_np(new_state["opt_state"][1][0].mu).items()}
    jnew = to_np(new_state["params"])

    outs = run.sharded["jax"]
    for k in ("loss", "rgb_loss", "eikonal_loss", "mask_loss"):
        for out in outs:
            np.testing.assert_allclose(out["losses"][k], float(jlosses[k]), rtol=1e-4,
                                       err_msg=k)
    for name, new in outs[0]["params"].items():
        if name in outs[0]["shards"]:
            tab = _full_table(outs, name)
            grad, new = tab["grad"], tab["value"]
            np.testing.assert_array_equal(new, outs[0]["params"][name])
        else:
            grad = outs[0]["grads"][name]
        if name.endswith(".w") or name.endswith(".v"):
            grad, new = grad.T, new.T
        np.testing.assert_allclose(grad, jgrads[name], rtol=1e-3, atol=1e-5, err_msg=name)
        sel = np.abs(jgrads[name]) > 1e-5
        np.testing.assert_allclose(new[sel], jnew[name][sel], rtol=0, atol=1e-6, err_msg=name)


def test_tables_are_row_sharded(run):
    """Each rank holds exactly half the rows of each table, the half of its
    'model' coordinate, with Adam moments of that shape (the counterpart of
    test_table_grads_are_model_sharded); the rows equal the one-rank
    step's."""
    single = run.single["jax"]
    names = ("implicit_network.embedder.grid.table", "rendering_network.view_embedder.grid.table")
    for r, out in enumerate(run.sharded["jax"]):
        assert sorted(out["shards"]) == sorted(names)
        for n in names:
            s = out["shards"][n]
            half = s["full_rows"] // N_MODEL
            lo = (r % N_MODEL) * half
            assert s["rows"] == (lo, lo + half)
            for k in ("value", "grad", "exp_avg", "exp_avg_sq"):
                assert s[k].shape == (half, 2), (n, k, s[k].shape)
            np.testing.assert_allclose(s["value"], single["params"][n][lo:lo + half],
                                       rtol=5e-4, atol=2e-6)
            # Adam's first moment after one step: 0.1 x the clipped gradient
            np.testing.assert_allclose(s["exp_avg"], 0.1 * s["grad"], rtol=1e-6, atol=1e-12)
    # the gradient reaches the SDF table (the view table's is zero, in JAX too)
    assert np.abs(_full_table(run.sharded["jax"], names[0])["grad"]).max() > 0


def test_no_hit_shard_finishes_and_matches(run):
    """Rank 3's rays all lie outside the mask (no surface hit there, its
    rendering-network gradient is zeros): the step neither hangs nor
    diverges, and every rank holds the same parameters."""
    case = run.cases["no_hit"]
    assert not run.scene["mask"][0][case["pixel_idx"][48:]].any()
    outs = run.sharded["no_hit"]
    for n in outs[0]["params"]:
        for out in outs[1:]:
            np.testing.assert_array_equal(out["params"][n], outs[0]["params"][n], err_msg=n)


def test_a_nonfinite_step_is_skipped(run):
    """At alpha NaN the loss and every gradient are NaN: the one-rank step
    and every rank of the sharded one skip the update (as
    optax.apply_if_finite would), so the parameters, the table shards, the
    pose table and its SparseAdam state stay as they were, and the skip is
    counted."""
    case = run.cases["nonfinite"]
    for r, out in enumerate([run.single["nonfinite"]] + run.sharded["nonfinite"]):
        assert math.isnan(out["losses"]["loss"]), r
        assert out["skipped"] == 1, r
        for n, p in out["params"].items():
            np.testing.assert_array_equal(p, run.state[n].numpy(), err_msg=f"{r} {n}")
        for n, s in out["shards"].items():
            lo, hi = s["rows"]
            np.testing.assert_array_equal(s["value"], run.state[n].numpy()[lo:hi])
            assert s["exp_avg"] is None and s["exp_avg_sq"] is None, (r, n)
        np.testing.assert_array_equal(out["pose_vecs"], case["pose_vecs"])
        assert int(out["cam_opt"]["step"]) == 0
        assert not out["cam_opt"]["m"].any() and not out["cam_opt"]["v"].any()
    assert len(run.sharded["nonfinite"][0]["shards"]) == 2


def _placements(model, n_model, **kw):
    mesh = types.SimpleNamespace(shape=(2, n_model), mesh_dim_names=("data", "model"))
    return {n: s for n, s in param_sharding(model, mesh, **kw).items() if s == ROWS}


def test_param_sharding_rule_on_the_ports_shapes():
    """JAX's rule (parallel/sharding.py:46-60) on (rows, C) tables: the
    flagship's 192- and 64-row tables stay replicated at the default 1024
    rows and shard at 8; the ngp log2=15 SDF table (168,768 x 2) shards at
    the default; rows that n_model does not divide stay replicated."""
    model = IDRNetwork(flagship_conf(num_pixels=64, small=True).get_config("model"),
                       device="cpu")
    assert _placements(model, 2) == {}
    assert set(_placements(model, 2, min_table_rows=8)) == {
        "implicit_network.embedder.grid.table", "rendering_network.view_embedder.grid.table"}
    assert set(_placements(model, 5, min_table_rows=8)) == set()
    ngp = IDRNetwork(ngp_conf("ngp_log2_15", num_pixels=64).get_config("model"), device="cpu")
    assert dict(ngp.named_parameters())["implicit_network.embedder.table"].shape == (168768, 2)
    assert set(_placements(ngp, 2)) == {"implicit_network.embedder.table"}
    everything = param_sharding(ngp, types.SimpleNamespace(
        shape=(2, 2), mesh_dim_names=("data", "model")))
    assert sum(s == REPLICATED for s in everything.values()) == len(everything) - 1


def test_runner_under_a_mesh_matches_unsharded(tmp_path):
    """``IDRTrainRunner(mesh=...)`` on a 1x2 mesh trains as the unsharded
    runner does from the same seed: the narrowed dummy conf of
    tests/test_torch_runner.py with the instant-ngp log2=15 grid, whose
    168,768-row SDF table the default rule row-shards; a batch of all 3
    views x 64 pixels split over two gloo ranks; epoch 0, one step.  The
    logged losses and the parameters agree at the sharded step's bounds.
    (One step: Adam turns the rounding of a near-zero gradient into an
    update of up to the learning rate, so later steps are not held to
    these bounds.)  Rank 0 alone writes the run; its checkpoint holds
    every Adam moment whole and resumes an unsharded runner."""
    import json
    import os

    from hashmodnffbanks_idr_tpu_torch.train.trainer import IDRTrainRunner
    from test_torch_runner import _write_setup

    args = _write_setup(tmp_path, **{"model.embedding_network.embed_type": "HashGridTcnn",
                                     "model.embedding_network.log2_max_hash_size": 15})
    kw = dict(conf=args[1], data_root=args[3], nepochs=0, batch_size=3, log_tensorboard=False)
    ranks = multihost.spawn(workers.sharded_runner, 2,
                            args=({**kw, "exps_folder_name": str(tmp_path / "sharded")}, 2),
                            device="cpu", timeout=240)
    assert ranks[1]["rows"] == {"implicit_network.embedder.table": (84384, 168768)}
    single = IDRTrainRunner(**kw, exps_folder_name=str(tmp_path / "single"), device="cpu")
    single.run()

    def scalars(rundir):
        with open(os.path.join(rundir, "logs", "scalars.jsonl")) as f:
            return [json.loads(line) for line in f]

    assert not os.path.exists(os.path.join(ranks[1]["rundir"], "logs")) or \
        ranks[1]["rundir"] == ranks[0]["rundir"]
    got, want = scalars(ranks[0]["rundir"]), scalars(single.rundir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0]
    assert single.step_count == 1
    for g, w in zip(got, want):
        for k in ("loss", "rgb_loss", "eikonal_loss", "mask_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-6, err_msg=k)
    for r in ranks:
        for n, p in single.model.named_parameters():
            np.testing.assert_allclose(r["params"][n], p.detach().numpy(), rtol=5e-4,
                                       atol=2e-6, err_msg=n)
    # the checkpoint: moments whole, in the unsharded optimizer's layout
    ck = torch.load(os.path.join(ranks[0]["rundir"], "checkpoints", "latest.pt"),
                    weights_only=True)
    ref = single.optimizer.state_dict()
    assert sorted(ck["optimizer"]["state"]) == sorted(ref["state"])
    for i, st in ref["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(ck["optimizer"]["state"][i][k].numpy(), st[k].numpy(),
                                       rtol=5e-4, atol=1e-9, err_msg=f"{i} {k}")
    resumed = IDRTrainRunner(**kw, exps_folder_name=str(tmp_path / "sharded"),
                             is_continue=True, device="cpu")
    assert resumed.start_epoch == 0 and resumed.step_count == 1


def _draws_model_and_inputs(mode, n_steps, ngp=False):
    if ngp:  # the level-pruned guide of ngp15-full, at a small table
        conf = ngp_conf("ngp_log2_15", num_pixels=N_RAYS)
        conf.put("model.embedding_network.log2_max_hash_size", 10)
        conf.put("model.implicit_network.dims", [64] * 8)
        conf.put("model.rendering_network.dims", [64, 64])
    else:
        conf = flagship_conf(num_pixels=N_RAYS, small=True)
    conf.put("model.ray_tracer.n_steps", n_steps)
    conf.put("model.tracer_fast", mode)
    model = IDRNetwork(conf.get_config("model"), device="cpu")
    scene = synthetic_scene(n_views=2, img_res=(32, 32), seed=0)
    pix = np.random.default_rng(3).permutation(32 * 32)[:N_RAYS]
    inputs = {"uv": torch.as_tensor(scene["uv"][pix][None]),
              "intrinsics": torch.as_tensor(scene["intrinsics"][:1]),
              "pose": torch.as_tensor(scene["pose"][:1]),
              "object_mask": torch.as_tensor(scene["mask"][:1, pix])}
    return model, inputs


@pytest.mark.parametrize("mode,n_steps,ngp,n_fine", [
    ("exact", 32, False, None), ("exact", 28, False, 24), ("mixed", 28, False, 24),
    ("exact", 28, True, 6)])
def test_draw_uniforms_are_the_forwards_own_draws(mode, n_steps, ngp, n_fine):
    """``IDRNetwork.draw_uniforms`` takes from a generator what the training
    forward would take itself, in the same order: the dense sweep (32 steps
    admit no stride), the hierarchical one (28: stride 9), 'mixed' (a
    coarse guide) and the level-pruned coarse guide of the ngp preset
    (stride 3); injected, they give the same forward."""
    model, inputs = _draws_model_and_inputs(mode, n_steps, ngp)
    draws = model.draw_uniforms(torch.Generator().manual_seed(9), N_RAYS, "cpu")
    assert ("dense" in draws) == (n_fine is None) and draws["eik"].shape == (N_RAYS // 2, 3)
    assert n_fine is None or draws["fine"].shape == (n_fine,)
    own = model(inputs, generator=torch.Generator().manual_seed(9), training=True)
    injected = model(inputs, generator=None, training=True, draws=draws)
    for k in ("points", "dists", "network_object_mask", "grad_theta", "rgb_values"):
        assert torch.equal(own[k], injected[k]), k


@pytest.mark.parametrize("missing", ["coarse", "fine", "eik"])
def test_a_missing_draw_raises(missing):
    """Injected draws that lack one the forward needs raise; the forward
    never makes up the missing one from a generator."""
    model, inputs = _draws_model_and_inputs("exact", 28)
    draws = model.draw_uniforms(torch.Generator().manual_seed(9), N_RAYS, "cpu")
    del draws[missing]
    with pytest.raises(KeyError, match=missing):
        model(inputs, generator=torch.Generator().manual_seed(9), training=True, draws=draws)
