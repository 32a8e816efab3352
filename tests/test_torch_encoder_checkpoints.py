"""The weight bridge and the runner for the hash-grid and classic encoders,
on the CPU.

A JAX runner checkpoint (the JAX package's ``save_checkpoint`` of the optax
``chain(clip_by_global_norm, adam)`` state after two updates) of each
encoder family loads into the port through ``load_jax_checkpoint``: the
instant-ngp table stored as the JAX page image (page count rounded up to 8,
the tail trimmed), NFFB's ngp grid (FFBTcnn), the Fourier-feature ``B``,
and NerfPos, which has no leaves.  Parameters, moments and step land
exactly.  And the port's runner trains a narrowed hash-grid conf with the
grid TV loss on and logs ``tv_loss``.
"""

import json
import os
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse_file as j_parse_file
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.ops import hashgrid as jhg
from hashmodnffbanks_idr_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt
from hashmodnffbanks_idr_tpu_torch.train import exp_runner
from hashmodnffbanks_idr_tpu_torch.train.trainer import make_optimizer
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

DUMMY_CONF = str(pathlib.Path(__file__).resolve().parents[1]
                 / "hashmodnffbanks_idr_tpu/config/confs/dummy.conf")
NARROW = {
    "model.implicit_network.dims": [128] * 8,
    "model.rendering_network.dims": [64, 64],
    "model.feature_vector_size": 32,
    "model.ray_tracer.n_steps": 28,
    "train.num_pixels": 64,
    "dataset.img_res": [32, 32],
}
# each encoder family on dummy.conf (FourierFeatures SDF encoder, NerfPos
# views): the SDF encoder, its table size, and the view encoder
FAMILIES = {
    "ngp_pages": ("HashGridTcnn", 15, "NerfPos"),
    "ffbtcnn": ("FFBTcnn", 12, "HashGridCUDA"),
    "fourier": ("FourierFeatures", 5, "FourierFeatures"),
    "nerfpos": ("NerfPos", 5, "NerfPos"),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _conf_file(root, embed, log2, view, **extra):
    conf = parse_file(DUMMY_CONF)
    for k, v in {**NARROW, "model.embedding_network.embed_type": embed,
                 "model.embedding_network.log2_max_hash_size": log2,
                 "model.rendering_network.viewdirs_embed_type": view, **extra}.items():
        conf.put(k, v)
    path = root / "narrow.conf"
    path.write_text(conf.dump())
    return path


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_checkpoint_of_each_encoder_loads(tmp_path, family):
    path = _conf_file(tmp_path, *FAMILIES[family])
    jmodel = JIDRNetwork(j_parse_file(str(path)).get_config("model"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    if family == "ngp_pages":
        table = params["implicit_network"]["embed"]["table"]
        spec = jmodel.implicit_network.embedder.spec
        assert jhg.table_is_pages(table, spec)
        assert table.size > spec.padded_total_rows() * spec.level_dim  # pages rounded to 8
    # the JAX runner's optimizer: Adam on a schedule of the step count
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(learning_rate=lambda c: 1e-4))
    opt_state = opt.init(params)
    leaves, tree = jax.tree_util.tree_flatten(params)
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        g = jax.tree_util.tree_unflatten(
            tree, [jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 1e-3)
                   for x in leaves])
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    j_save_checkpoint(str(tmp_path), 3, {"params": params, "opt_state": opt_state, "epoch": 0})

    model = IDRNetwork(parse_file(str(path)).get_config("model"), device="cpu")
    optimizer = make_optimizer(model)
    assert ckpt.load_jax_checkpoint(str(tmp_path / "3.msgpack"), model, optimizer) == \
        {"epoch": 3, "step": 2}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    adam = opt_state[1][0]
    want_p = from_jax_params(to_np(params), model)
    want_mu, want_nu = from_jax_params(to_np(adam.mu), model), from_jax_params(to_np(adam.nu), model)
    names = [name for name, _ in model.named_parameters()]
    assert not any("embedder" in n for n in names) if family == "nerfpos" else \
        any("embedder" in n for n in names)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[name]), name
        assert torch.equal(optimizer.state[p]["exp_avg"], want_mu[name]), name
        assert torch.equal(optimizer.state[p]["exp_avg_sq"], want_nu[name]), name


def test_runner_trains_a_hash_grid_conf_with_tv_loss(tmp_path):
    """``loss.tv_weight > 0`` adds the grid TV term, which the runner logs."""
    dummy_cli.main(["--out", str(tmp_path / "data" / "dummy" / "scan0"), "--views", "2",
                    "--size", "32"])
    path = _conf_file(tmp_path, "HashGridTcnn", 12, "NerfPos", **{
        "loss.tv_weight": 0.01, "model.ray_tracer.prune_levels_march": 3,
        "model.ray_tracer.prune_levels_coarse": 3, "model.ray_tracer.prune_secant_iters": 2})
    runner = exp_runner.main(["--conf", str(path), "--data_root", str(tmp_path / "data"),
                              "--exps_folder_name", str(tmp_path / "exps"), "--platform", "cpu",
                              "--no_tensorboard", "--nepoch", "1"])
    assert runner.loss_cfg.tv_weight == 0.01
    with open(os.path.join(runner.rundir, "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["tv_loss"]) and r["tv_loss"] > 0 for r in rows)
