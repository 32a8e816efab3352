"""Trainable cameras through the port's runner, checkpoints and eval, on the
CPU, on the repo's dummy StyleModNFFB conf narrowed as in
tests/test_torch_runner.py (a 3-view 32x32 dummy scene with its noisy
``cameras_linear_init.npz``):

* ``exp_runner --train_cameras``: the pose table starts from
  ``get_pose_init``, trains, is saved with its SparseAdam state, and
  ``--is_continue`` restores both bit for bit;
* ``load_jax_checkpoint`` of a JAX runner checkpoint with cameras gives the
  same pose table and SparseAdam state, bit for bit;
* ``Evaluator.render_view`` from trained poses against the JAX evaluator:
  hit masks >= 99%, rgb and dists within 1e-4 where both hit;
* ``run_eval --eval_cameras`` on a ``trained`` expname: JAX's translation
  errors, scale and alignment within 1e-6, its rotation errors within 1e-3
  deg (float32 rounding, see the test), and exactly JAX's
  ``camera_alignment`` of the port's rotations.
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
from hashmodnffbanks_idr_tpu.eval import run_eval as j_run_eval
from hashmodnffbanks_idr_tpu.eval.evaluator import Evaluator as JEvaluator
from hashmodnffbanks_idr_tpu.eval.evaluator import camera_alignment as j_camera_alignment
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from hashmodnffbanks_idr_tpu.train.trainer import sparse_adam_init as j_sparse_adam_init
from hashmodnffbanks_idr_tpu.train.trainer import sparse_adam_update as j_sparse_adam_update

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset
from hashmodnffbanks_idr_tpu_torch.eval import run_eval
from hashmodnffbanks_idr_tpu_torch.eval.evaluator import Evaluator
from hashmodnffbanks_idr_tpu_torch.geometry.cameras import quat_to_rot
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt
from hashmodnffbanks_idr_tpu_torch.train import exp_runner
from hashmodnffbanks_idr_tpu_torch.train.trainer import (IDRTrainRunner, make_optimizer,
                                                         sparse_adam_init)
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

DUMMY_CONF = str(pathlib.Path(__file__).resolve().parents[1]
                 / "hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf")
NARROW = {
    "train.expname": "dummy_trained_cameras",
    "model.implicit_network.dims": [64] * 8,
    "model.rendering_network.dims": [64, 64],
    "model.feature_vector_size": 32,
    "model.ray_tracer.n_steps": 28,
    "model.tracer_fast": "exact",
    "train.num_pixels": 64,
    "dataset.img_res": [32, 32],
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Many small ops: with every test worker on torch's default thread pool
    they crawl (as in tests/test_torch_runner.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cameras")
    dummy_cli.main(["--out", str(root / "data" / "dummy" / "scan0"), "--views", "3",
                    "--size", "32"])
    conf = parse_file(DUMMY_CONF)
    for k, v in NARROW.items():
        conf.put(k, v)
    conf_path = root / "narrow_trained.conf"
    conf_path.write_text(conf.dump())
    return {"root": root, "conf_path": str(conf_path), "data_root": str(root / "data")}


def _jax_model(conf_path, seed=0):
    jmodel = JIDRNetwork(j_parse_file(conf_path).get_config("model"))
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(seed))


def _trained_cameras(pose0, n_steps=3, seed=0):
    """A pose table and JAX SparseAdam state after a few updates, as a
    trained run would leave them."""
    rng = np.random.default_rng(seed)
    pose, state = jnp.asarray(pose0), j_sparse_adam_init(jnp.asarray(pose0))
    for i in range(n_steps):
        g = jnp.asarray(rng.normal(size=pose0.shape).astype(np.float32))
        pose, state = j_sparse_adam_update(pose, g, state, jnp.asarray([i % len(pose0)]),
                                           1e-2)
    return pose, state


def test_runner_trains_cameras_and_resumes_exactly(scene):
    args = ["--conf", scene["conf_path"], "--data_root", scene["data_root"],
            "--exps_folder_name", str(scene["root"] / "exps_run"), "--platform", "cpu",
            "--no_tensorboard", "--train_cameras"]
    first = exp_runner.main(args + ["--nepoch", "1"])
    init = SceneDataset(True, "dummy", [32, 32], 0,
                        data_root=scene["data_root"]).get_pose_init()
    pose = first.pose_vecs.detach()
    assert pose.shape == (3, 7) and torch.isfinite(pose).all()
    assert not torch.equal(pose, torch.from_numpy(init))  # every image was a step's
    assert int(first.cam_opt["step"]) == first.step_count == 6
    saved = torch.load(os.path.join(first.checkpoints_path, "latest.pt"), weights_only=True)
    assert torch.equal(saved["pose_vecs"], pose)
    assert {k: v.dtype for k, v in saved["cam_opt"].items()} == {
        "m": torch.float32, "v": torch.float32, "step": torch.int32}
    first_ckpt = torch.load(os.path.join(first.checkpoints_path, "0.pt"), weights_only=True)
    assert torch.equal(first_ckpt["pose_vecs"], torch.from_numpy(init))
    assert int(first_ckpt["cam_opt"]["step"]) == 0

    resumed = IDRTrainRunner(os.path.join(first.rundir, "runconf.conf"), nepochs=2,
                             exps_folder_name=str(scene["root"] / "exps_run"),
                             train_cameras=True, is_continue=True,
                             data_root=scene["data_root"], log_tensorboard=False, device="cpu")
    assert resumed.start_epoch == 1 and resumed.step_count == 6
    assert torch.equal(resumed.pose_vecs.detach(), pose) and resumed.pose_vecs.requires_grad
    for k in ("m", "v", "step"):
        assert torch.equal(resumed.cam_opt[k], first.cam_opt[k]), k
    resumed.run()
    assert int(resumed.cam_opt["step"]) == resumed.step_count == 12
    assert not torch.equal(resumed.pose_vecs.detach(), pose)


def test_jax_checkpoint_with_cameras_loads_into_the_port(scene, tmp_path):
    jmodel, params = _jax_model(scene["conf_path"])
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(learning_rate=lambda c: 1e-4))
    init = SceneDataset(True, "dummy", [32, 32], 0,
                        data_root=scene["data_root"]).get_pose_init()
    pose, cam_state = _trained_cameras(init)
    j_save_checkpoint(str(tmp_path), 4, {"params": params, "opt_state": opt.init(params),
                                         "pose_vecs": pose, "cam_opt": cam_state, "epoch": 0})

    model = IDRNetwork(parse_file(scene["conf_path"]).get_config("model"), device="cpu")
    cameras = {"pose_vecs": torch.zeros(3, 7, requires_grad=True)}
    cameras["cam_opt"] = sparse_adam_init(cameras["pose_vecs"])
    got = ckpt.load_jax_checkpoint(str(tmp_path / "4.msgpack"), model, make_optimizer(model),
                                   cameras=cameras)
    assert got["epoch"] == 4 and got["step"] == 0
    np.testing.assert_array_equal(got["pose_vecs"].numpy(), np.asarray(pose))
    np.testing.assert_array_equal(cameras["pose_vecs"].detach().numpy(), np.asarray(pose))
    for k in ("m", "v"):
        np.testing.assert_array_equal(cameras["cam_opt"][k].numpy(), np.asarray(cam_state[k]))
    assert cameras["cam_opt"]["step"].dtype == torch.int32
    assert int(cameras["cam_opt"]["step"]) == int(cam_state["step"]) == 3


@pytest.fixture(scope="module")
def trained_pair(scene):
    """The same weights and trained pose table on both sides."""
    jmodel, params = _jax_model(scene["conf_path"], seed=1)
    model = IDRNetwork(parse_file(scene["conf_path"]).get_config("model"), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    init = SceneDataset(True, "dummy", [32, 32], 0,
                        data_root=scene["data_root"]).get_pose_init()
    pose, cam_state = _trained_cameras(init, n_steps=5, seed=2)
    return jmodel, params, model, np.array(pose), cam_state


@pytest.mark.parametrize("idx", [0, 2])
def test_render_view_with_trained_poses_matches_jax(scene, trained_pair, idx):
    _, params, model, pose, _ = trained_pair
    conf, jconf = parse_file(scene["conf_path"]), j_parse_file(scene["conf_path"])
    ev = Evaluator(conf, model, data_root=scene["data_root"], pose_vecs=torch.tensor(pose))
    jev = JEvaluator(jconf, params, train_cameras=True, pose_vecs=pose,
                     data_root=scene["data_root"], tile=1024)
    got, want = ev.render_view(idx), jev.render_view(idx)
    fixed = Evaluator(conf, model, data_root=scene["data_root"]).render_view(idx)
    assert got["mask"].any() and not got["mask"].all()
    assert not np.array_equal(got["mask"], fixed["mask"])  # the trained pose was used
    assert (got["mask"] == want["mask"]).mean() >= 0.99
    both = got["mask"] & want["mask"]
    np.testing.assert_allclose(got["rgb"][both], want["rgb"][both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["dists"][both], want["dists"][both], rtol=0, atol=1e-4)


def test_run_eval_eval_cameras_matches_jax(scene, trained_pair, tmp_path):
    """Both CLIs on their own checkpoints of the same weights and poses: a
    ``trained`` expname renders from the checkpoint's poses and
    ``--eval_cameras`` writes the same camera accuracy.  Translation errors,
    scale and alignment agree within 1e-6.  Both sides turn the float32
    quaternions into float32 rotations; XLA contracts that arithmetic into
    FMAs and torch does not, and arccos near 1 magnifies the last bit (about
    1e-4 deg at these 1-2 deg errors), so the rotation errors agree within
    1e-3 deg, and exactly when JAX's ``camera_alignment`` is given the
    port's rotations."""
    jmodel, params, model, pose, cam_state = trained_pair
    expname = "dummy_trained_cameras_0"
    jdir = tmp_path / "jax_exps" / expname / "2026_01_01_00_00_00" / "checkpoints"
    j_save_checkpoint(str(jdir), 3, {"params": params, "pose_vecs": jnp.asarray(pose),
                                     "cam_opt": cam_state, "epoch": 0})
    cameras = {"pose_vecs": torch.from_numpy(pose), "cam_opt": {
        k: torch.from_numpy(np.array(v)) for k, v in cam_state.items()}}
    pdir = tmp_path / "port_exps" / expname / "2026_01_01_00_00_00" / "checkpoints"
    ckpt.save_checkpoint(str(pdir), 3, model, make_optimizer(model), 9, cameras=cameras)

    common = ["--conf", scene["conf_path"], "--data_root", scene["data_root"],
              "--resolution", "32", "--eval_cameras"]
    j_run_eval.main(common + ["--exps_folder", str(tmp_path / "jax_exps"),
                              "--evals_folder", str(tmp_path / "jax_evals")])
    res = run_eval.main(common + ["--platform", "cpu", "--exps_folder",
                                  str(tmp_path / "port_exps"), "--evals_folder",
                                  str(tmp_path / "port_evals")])
    assert res["epoch"] == 3
    with open(tmp_path / "jax_evals" / expname / "camera_accuracy.json") as f:
        want = json.load(f)
    with open(os.path.join(res["eval_dir"], "camera_accuracy.json")) as f:
        got = json.load(f)
    assert set(got) == set(want) and got["rot_err_mean"] > 0.5
    for k in ("t_err_mean", "t_err_median", "scale"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    for k in ("rotation", "translation"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0, atol=1e-6)
    for k in ("rot_err_mean", "rot_err_median"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)

    gt = SceneDataset(True, "dummy", [32, 32], 0,
                      data_root=scene["data_root"]).get_gt_pose(scaled=True)
    pred_R = quat_to_rot(torch.from_numpy(pose[:, :4])).numpy()
    same_R = j_camera_alignment(pred_R, gt[:, :3, :3], pose[:, 4:], gt[:, :3, 3])
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(same_R[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
        np.testing.assert_allclose(np.asarray(res["camera_accuracy"][k]), np.asarray(got[k]),
                                   rtol=0, atol=0, err_msg=k)
    line = (pathlib.Path(res["eval_dir"]) / "camera_accuracy.txt").read_text()
    assert line.startswith(f"camera accuracy: rot mean {got['rot_err_mean']:.3f}deg")
