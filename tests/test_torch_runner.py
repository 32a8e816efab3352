"""The port's training runner, CLI and checkpoints on the CPU, on the repo's
dummy StyleModNFFB conf narrowed to seconds (SDF MLP 8x128, rendering 64,
64 rays, 28 tracer steps, a 3-view 32x32 dummy scene): the schedules against
the JAX package's, the per-step LR against JAX's optax schedule, the CLI's
checkpoints, an exact ``--is_continue``, a JAX msgpack checkpoint loaded
into the port, and the whole path with neither cv2 nor msgpack importable.
"""

import json
import os
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse_file as j_parse_file
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.train import schedule as jschedule
from hashmodnffbanks_idr_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt
from hashmodnffbanks_idr_tpu_torch.train import exp_runner, schedule
from hashmodnffbanks_idr_tpu_torch.train.trainer import IDRTrainRunner, make_optimizer
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

DUMMY_CONF = str(pathlib.Path(__file__).resolve().parents[1]
                 / "hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf")
NARROW = {
    "model.implicit_network.dims": [128] * 8,
    "model.rendering_network.dims": [64, 64],
    "model.feature_vector_size": 32,
    "model.ray_tracer.n_steps": 28,
    "model.tracer_fast": "mixed",
    "train.num_pixels": 64,
    "dataset.img_res": [32, 32],
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The runs here are many small ops; with every test worker running
    torch's default thread pool on the same cores they crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_setup(root, **extra):
    """The narrowed dummy scene (through the port's CLI) and conf under
    ``root``; returns the CLI's common arguments."""
    dummy_cli.main(["--out", str(root / "data" / "dummy" / "scan0"), "--views", "3",
                    "--size", "32"])
    conf = parse_file(DUMMY_CONF)
    for k, v in {**NARROW, **extra}.items():
        conf.put(k, v)
    conf_path = root / "narrow.conf"
    conf_path.write_text(conf.dump())
    return ["--conf", str(conf_path), "--data_root", str(root / "data"),
            "--exps_folder_name", str(root / "exps"), "--platform", "cpu", "--no_tensorboard"]


def _scalars(runner):
    with open(os.path.join(runner.rundir, "logs", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """A 2-epoch CLI run (epochs 0, 1, 2: nine steps) with LR milestones at
    epochs 1 and 2, each step's LR recorded."""
    root = tmp_path_factory.mktemp("runner")
    args = _write_setup(root, **{"train.sched_milestones": [1, 2], "train.sched_factor": 0.5})
    lrs = []
    real_init = IDRTrainRunner.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        step = self._step_fn

        def recorded(*s_args, **s_kw):
            lrs.append(self.optimizer.param_groups[0]["lr"])
            return step(*s_args, **s_kw)

        self._step_fn = recorded

    IDRTrainRunner.__init__ = recording_init
    try:
        fm.reset_launch_counts()
        runner = exp_runner.main(args + ["--nepoch", "2"])
    finally:
        IDRTrainRunner.__init__ = real_init
    return root, args, runner, lrs


def test_schedules_match_jax():
    conf = parse_file(DUMMY_CONF)
    lr, ms, f = 1e-4, conf.get_list("train.sched_milestones"), conf.get_float("train.sched_factor")
    ams, af = conf.get_list("train.alpha_milestones"), conf.get_float("train.alpha_factor")
    for epoch in range(2001):
        assert schedule.multistep_lr(lr, ms, f, epoch) == jschedule.multistep_lr(lr, ms, f, epoch)
        assert (schedule.annealed_alpha(50.0, ams, af, epoch)
                == jschedule.annealed_alpha(50.0, ams, af, epoch))


def test_runner_lr_follows_jax_schedule(two_epochs):
    """Every step's LR is JAX's ``lr * factor ** sum(count >= ms)`` on the
    optimizer's count, with ``ms = milestones * steps_per_epoch``
    (JAX train/trainer.py:252-258), evaluated through optax."""
    _, _, runner, lrs = two_epochs
    assert runner.steps_per_epoch == 3 and len(lrs) == 9
    ms = np.asarray([1, 2]) * runner.steps_per_epoch

    def lr_sched(count):
        return 1e-4 * (0.5 ** jnp.sum(count >= jnp.asarray(ms)))

    adam = optax.adam(learning_rate=lr_sched)
    state = adam.init({"x": jnp.zeros(())})
    for count, got in enumerate(lrs):
        # a constant gradient of 1 makes Adam's step -lr, so the update
        # shows the LR optax applied at this count
        upd, state = adam.update({"x": jnp.ones(())}, state)
        np.testing.assert_allclose(got, -float(upd["x"]), rtol=1e-4)  # f32 Adam
        np.testing.assert_allclose(got, float(lr_sched(count)), rtol=1e-6)
        assert runner.lr_at(count) == got
    assert lrs == [1e-4] * 3 + [5e-5] * 3 + [2.5e-5] * 3


def test_cli_writes_checkpoints_and_logs(two_epochs):
    _, _, runner, _ = two_epochs
    files = sorted(os.listdir(runner.checkpoints_path))
    assert files == ["0.pt", "2.pt", "latest.pt"]
    rows = _scalars(runner)
    assert [r["step"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("loss", "rgb_loss", "eikonal_loss",
                                               "mask_loss", "rays_per_s"))
        assert r["alpha"] == 50.0
        # the CPU runs the kernel's plain twin: no launch is counted
        assert r["fused_sdf_raw_bf16_launches"] == r["fused_sdf_raw_f32_launches"] == 0
    assert os.path.exists(os.path.join(runner.rundir, "runconf.conf"))
    assert runner.expname == "dummy_stylemodnffb_0"  # conf scan_id 0 appended


def test_is_continue_restores_exactly(two_epochs):
    root, args, first, _ = two_epochs
    conf = os.path.join(first.rundir, "runconf.conf")
    resumed = IDRTrainRunner(conf, nepochs=3, exps_folder_name=str(root / "exps"),
                             is_continue=True, data_root=str(root / "data"),
                             log_tensorboard=False, device="cpu")
    assert resumed.start_epoch == 2 and resumed.step_count == 9
    saved = torch.load(os.path.join(first.checkpoints_path, "latest.pt"), weights_only=True)
    assert saved["epoch"] == 2 and saved["step"] == 9
    want = dict(first.model.named_parameters())
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p, want[name]), name
        assert torch.equal(saved["model"][name], want[name]), name
        s, w = resumed.optimizer.state[p], first.optimizer.state[want[name]]
        if not w:  # never received a gradient (the density's beta)
            assert not s, name
            continue
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], w[k]), (name, k)
        assert float(s["step"]) == 9
    resumed.run()
    assert [r["step"] for r in _scalars(resumed)] == [2, 3]
    assert resumed.step_count == 15
    assert sorted(os.listdir(resumed.checkpoints_path)) == ["3.pt", "latest.pt"]


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A checkpoint written by the JAX package's ``save_checkpoint`` from the
    JAX runner's ``optax.chain(clip_by_global_norm, adam(schedule))`` state
    after two updates: params, moments, step and epoch land in the port,
    and one more Adam update agrees with optax's."""
    conf_text = parse_file(DUMMY_CONF)
    for k, v in NARROW.items():
        conf_text.put(k, v)
    (tmp_path / "c.conf").write_text(conf_text.dump())
    jmodel = JIDRNetwork(j_parse_file(str(tmp_path / "c.conf")).get_config("model"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(learning_rate=lambda c: 1e-4))
    opt_state = opt.init(params)

    def grads(seed):  # global norm 0.5: the clip leaves them as they are
        leaves, tree = jax.tree_util.tree_flatten(params)
        rng = np.random.default_rng(seed)
        g = [rng.normal(size=x.shape).astype(np.float32) for x in leaves]
        norm = np.sqrt(sum(float((x ** 2).sum()) for x in g))
        return jax.tree_util.tree_unflatten(tree, [jnp.asarray(x * 0.5 / norm) for x in g])

    for seed in (1, 2):
        updates, opt_state = opt.update(grads(seed), opt_state, params)
        params = optax.apply_updates(params, updates)
    j_save_checkpoint(str(tmp_path), 7, {"params": params, "opt_state": opt_state, "epoch": 0})

    model = IDRNetwork(parse_file(str(tmp_path / "c.conf")).get_config("model"), device="cpu")
    optimizer = make_optimizer(model)
    got = ckpt.load_jax_checkpoint(str(tmp_path / "7.msgpack"), model, optimizer)
    assert got == {"epoch": 7, "step": 2}
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    adam = opt_state[1][0]
    want_p = from_jax_params(to_np(params), model)
    want_mu, want_nu = from_jax_params(to_np(adam.mu), model), from_jax_params(to_np(adam.nu), model)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[name]), name
        st = optimizer.state[p]
        assert torch.equal(st["exp_avg"], want_mu[name]), name
        assert torch.equal(st["exp_avg_sq"], want_nu[name]), name
        assert float(st["step"]) == 2

    g3 = grads(3)
    updates, _ = opt.update(g3, opt_state, params)
    want_next = from_jax_params(to_np(optax.apply_updates(params, updates)), model)
    g3_port = from_jax_params(to_np(g3), model)
    for name, p in model.named_parameters():
        p.grad = g3_port[name]
    optimizer.step()
    for name, p in model.named_parameters():  # the two updates round differently
        np.testing.assert_allclose(p.detach().numpy(), want_next[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_runner_path_needs_neither_cv2_nor_msgpack(tmp_path, monkeypatch):
    """With ``cv2`` and ``msgpack`` hidden (``import`` raises), the port's
    dummy CLI writes the scene, ``SceneDataset`` loads it and the CLI trains
    one epoch; only ``load_jax_checkpoint`` needs msgpack."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    args = _write_setup(tmp_path)
    ds = SceneDataset(False, "dummy", [32, 32], 0, data_root=str(tmp_path / "data"))
    assert ds.rgb_images.shape == (3, 1024, 3) and ds.object_masks.any()
    runner = exp_runner.main(args + ["--nepoch", "0"])
    assert [r["step"] for r in _scalars(runner)] == [0]
    assert sorted(os.listdir(runner.checkpoints_path)) == ["0.pt", "latest.pt"]
    with pytest.raises(ImportError):
        ckpt.load_jax_checkpoint(os.path.join(runner.checkpoints_path, "0.pt"),
                                 runner.model, runner.optimizer)


def test_unported_runner_options_raise(tmp_path):
    """The multi-host flags raise; ``--train_cameras`` is ported and trains
    (tests/test_torch_cameras.py holds it against JAX)."""
    args = _write_setup(tmp_path)
    with pytest.raises(NotImplementedError):
        exp_runner.main(args + ["--num_processes", "2"])
    runner = exp_runner.main(args + ["--train_cameras", "--nepoch", "0"])
    assert runner.pose_vecs.shape == (3, 7) and int(runner.cam_opt["step"]) == 3
