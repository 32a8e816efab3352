"""Trainable cameras in the port against the JAX package, on the CPU.

* pose-7 geometry: ``pose7_to_matrix``, ``get_camera_params`` with (B, 7)
  poses and ``get_depth`` within 1e-6; the pose-7 gradient of the rays
  against ``jax.grad`` within 1e-5;
* SparseAdam: ``sparse_adam_update`` against JAX's and against
  ``torch.optim.SparseAdam`` over seven steps with a repeated row and a
  two-image step that touches one image twice, within 1e-6;
* the ``train_cameras`` step against JAX's ``build_train_step(train_cameras=
  True)`` with the same weights, poses and injected draws: loss terms rtol
  1e-4; the network's clipped gradients and the pose table's unclipped
  gradient rtol 1e-3 / atol 1e-5 (read back from JAX's Adam and SparseAdam
  first moments); the updated network and poses within 1e-6, the
  SparseAdam moments rtol 1e-3 / atol 1e-9 and its step exactly.  Narrow
  (SDF 8x128) with one image and with one image twice, and at full width
  (``headtohead_ours_trained_cameras_400.conf``'s model, 8x512, 16 rays).
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse_file as j_parse_file
from hashmodnffbanks_idr_tpu.geometry import cameras as jcam
from hashmodnffbanks_idr_tpu.models.loss import IDRLossConfig as JLossConfig
from hashmodnffbanks_idr_tpu.train.trainer import build_train_step as j_build_train_step
from hashmodnffbanks_idr_tpu.train.trainer import sparse_adam_init as j_sparse_adam_init
from hashmodnffbanks_idr_tpu.train.trainer import sparse_adam_update as j_sparse_adam_update

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.geometry import cameras as cam
from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device
from hashmodnffbanks_idr_tpu_torch.train.trainer import (build_train_step, make_optimizer,
                                                         sparse_adam_init, sparse_adam_update)
from hashmodnffbanks_idr_tpu_torch.weights import _flatten

from torch_step_parity import ALPHA, draws, narrow, setup

CONF_DIR = pathlib.Path(__file__).resolve().parents[1] / "hashmodnffbanks_idr_tpu/config/confs"
TRAINED_CONF = CONF_DIR / "headtohead_ours_trained_cameras_400.conf"


def _pose7(n, seed=0):
    """n cam-to-world poses as quaternion + translation, near a radius-2
    orbit, with unnormalised quaternions (the table drifts off the unit
    sphere as it trains; ``quat_to_rot`` normalises)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)) * 0.3 + np.array([1.0, 0.0, 0.0, 0.0])
    q *= rng.uniform(0.8, 1.2, size=(n, 1))
    t = rng.normal(size=(n, 3))
    t = 2.0 * t / np.linalg.norm(t, axis=-1, keepdims=True)
    return np.concatenate([q, t], axis=1).astype(np.float32)


def _intrinsics(n, res=16):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 1] = 1.3 * res, 1.2 * res, 0.5
    K[0, 2] = K[1, 2] = res / 2.0
    return np.tile(K[None], (n, 1, 1))


def test_pose7_to_matrix_matches_jax():
    pose = _pose7(5)
    got = cam.pose7_to_matrix(torch.from_numpy(pose)).numpy()
    want = np.asarray(jcam.pose7_to_matrix(jnp.asarray(pose)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 3], np.tile([0.0, 0.0, 0.0, 1.0], (5, 1)))


def test_get_camera_params_and_depth_pose7_match_jax():
    B, P = 3, 40
    pose = _pose7(B, seed=1)
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 16, size=(B, P, 2)).astype(np.float32)
    intr = _intrinsics(B)
    dirs, loc = cam.get_camera_params(*(torch.from_numpy(a) for a in (uv, pose, intr)))
    jdirs, jloc = jcam.get_camera_params(*(jnp.asarray(a) for a in (uv, pose, intr)))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(loc.numpy(), pose[:, 4:])
    np.testing.assert_array_equal(np.asarray(jloc), pose[:, 4:])
    # a (B, 7) pose and its (B, 4, 4) matrix give the same rays
    mat_dirs, _ = cam.get_camera_params(torch.from_numpy(uv), cam.pose7_to_matrix(
        torch.from_numpy(pose)), torch.from_numpy(intr))
    np.testing.assert_allclose(mat_dirs.numpy(), dirs.numpy(), rtol=0, atol=1e-7)

    pts = rng.normal(size=(B, P, 3)).astype(np.float32)
    for p in (pose, np.array(jcam.pose7_to_matrix(jnp.asarray(pose)))):
        got = cam.get_depth(torch.from_numpy(pts), torch.from_numpy(p)).numpy()
        want = np.asarray(jcam.get_depth(jnp.asarray(pts), jnp.asarray(p)))
        assert got.shape == (B, P, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pose7_gradient_matches_jax():
    """d/d(pose7) of a weighted sum of the rays, the camera centres and the
    depths: the path the camera gradient takes through ``quat_to_rot``."""
    B, P = 2, 30
    pose = _pose7(B, seed=3)
    rng = np.random.default_rng(4)
    uv = rng.uniform(0, 16, size=(B, P, 2)).astype(np.float32)
    intr = _intrinsics(B)
    pts = rng.normal(size=(B, P, 3)).astype(np.float32)
    w_dirs = rng.normal(size=(B, P, 3)).astype(np.float32)
    w_loc = rng.normal(size=(B, 3)).astype(np.float32)
    w_depth = rng.normal(size=(B, P, 1)).astype(np.float32)

    def objective(mod, xp, p):
        d, c = mod.get_camera_params(xp.asarray(uv), p, xp.asarray(intr))
        z = mod.get_depth(xp.asarray(pts), p)
        return ((d * xp.asarray(w_dirs)).sum() + (c * xp.asarray(w_loc)).sum()
                + (z * xp.asarray(w_depth)).sum())

    want = np.asarray(jax.grad(lambda p: objective(jcam, jnp, p))(jnp.asarray(pose)))
    p = torch.tensor(pose, requires_grad=True)
    objective(cam, torch, p).backward()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-5)


def test_sparse_adam_matches_jax_and_torch():
    """Seven steps: single rows, a row repeated across steps, and two-image
    steps, one of which touches image 1 twice (its gradient is the sum)."""
    V, lr = 5, 1e-3
    rng = np.random.default_rng(0)
    pose0 = rng.normal(size=(V, 7)).astype(np.float32)

    emb = torch.nn.Embedding(V, 7, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(pose0))
    ref = torch.optim.SparseAdam(emb.parameters(), lr=lr)

    pose_j = jnp.asarray(pose0)
    state_j = j_sparse_adam_init(pose_j)
    pose = torch.tensor(pose0)
    state = sparse_adam_init(pose)

    steps = [[0], [2], [2], [1, 1], [4], [3, 0], [2]]
    for rows in steps:
        g_rows = rng.normal(size=(len(rows), 7)).astype(np.float32)
        dense = np.zeros((V, 7), np.float32)
        np.add.at(dense, rows, g_rows)

        ref.zero_grad()
        emb(torch.tensor(rows)).backward(torch.from_numpy(g_rows))
        ref.step()
        pose_j, state_j = j_sparse_adam_update(pose_j, jnp.asarray(dense), state_j,
                                               jnp.asarray(rows, jnp.int32), lr)
        sparse_adam_update(pose, torch.from_numpy(dense), state, torch.tensor(rows), lr)

        np.testing.assert_allclose(pose.numpy(), np.asarray(pose_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pose.numpy(), emb.weight.detach().numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(state["m"].numpy(), np.asarray(state_j["m"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(state["v"].numpy(), np.asarray(state_j["v"]), rtol=0,
                                   atol=1e-6)
        assert int(state["step"]) == int(state_j["step"])
    assert int(state["step"]) == len(steps) and state["step"].dtype == torch.int32
    # rows never touched keep their moments at zero and their values
    untouched = [r for r in range(V) if not any(r in s for s in steps)]
    for r in untouched:
        assert not state["m"][r].any() and np.array_equal(pose[r].numpy(), pose0[r])


def _pose_table(scene_np, seed=5):
    """The scene's poses as a (V, 7) table, moved off them a little as a
    linear init is (``SceneDataset.get_pose_init``'s layout)."""
    poses = scene_np["pose"]
    q = cam.rot_to_quat(poses[:, :3, :3].astype(np.float64))
    table = np.concatenate([q, poses[:, :3, 3]], axis=1)
    rng = np.random.default_rng(seed)
    return (table + 0.01 * rng.normal(size=table.shape)).astype(np.float32)


def check_camera_step(jmodel, params, model, scene_np, pixel_idx, img_idx, lr_cam=1e-4):
    """One ``train_cameras`` step on both sides from the same weights,
    poses and draws.  JAX's gradients are read back from its optimizers'
    first moments after one step: Adam's ``mu = 0.1 * clipped grad`` and
    SparseAdam's ``m = 0.1 * pose grad`` on the touched rows."""
    rng = jax.random.PRNGKey(7)
    B, P = len(img_idx), len(pixel_idx)
    pose0 = _pose_table(scene_np)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    state = {"params": params, "opt_state": optimizer.init(params),
             "pose_vecs": jnp.asarray(pose0), "cam_opt": j_sparse_adam_init(jnp.asarray(pose0))}
    scene_j = {k: jnp.asarray(v) for k, v in scene_np.items()}
    jstep = j_build_train_step(jmodel, JLossConfig(0.1, 200.0, ALPHA), optimizer,
                               train_cameras=True, batch_size=B, lr_cam=lr_cam)
    new_state, jlosses = jstep(state, scene_j, jnp.asarray(img_idx, jnp.int32),
                               jnp.asarray(pixel_idx), rng, jnp.asarray(ALPHA, jnp.float32))
    to_np = lambda tree: dict(_flatten(jax.tree_util.tree_map(np.asarray, tree)))
    jgrads = {k: v / 0.1 for k, v in to_np(new_state["opt_state"][1][0].mu).items()}
    jnew = to_np(new_state["params"])
    jcam_opt = {k: np.asarray(v) for k, v in new_state["cam_opt"].items()}

    fm.reset_launch_counts()
    pose_vecs = torch.tensor(pose0, requires_grad=True)
    cam_opt = sparse_adam_init(pose_vecs)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), make_optimizer(model),
                            pose_vecs=pose_vecs, cam_opt=cam_opt, lr_cam=lr_cam)
    losses = step(scene_to_device(scene_np, "cpu"), torch.as_tensor(img_idx).long(),
                  torch.as_tensor(pixel_idx).long(), None, ALPHA,
                  draws=draws(model, rng, B * P))
    for k in ("loss", "rgb_loss", "eikonal_loss", "mask_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, err_msg=k)

    # the network's gradient was clipped (its global norm is 1 after the
    # clip), so a pose gradient that went through the clip would differ
    clipped_norm = np.sqrt(sum(float((g ** 2).sum()) for g in jgrads.values()))
    np.testing.assert_allclose(clipped_norm, 1.0, rtol=1e-5)
    for name, p in model.named_parameters():
        transpose = name.endswith(".w") or name.endswith(".v")
        grad = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        grad, new = (grad.T, p.detach().numpy().T) if transpose else (grad, p.detach().numpy())
        np.testing.assert_allclose(grad, jgrads[name], rtol=1e-3, atol=1e-5, err_msg=name)
        sel = np.abs(jgrads[name]) > 1e-5
        np.testing.assert_allclose(new[sel], jnew[name][sel], rtol=0, atol=1e-6, err_msg=name)

    touched = np.zeros(len(pose0), bool)
    touched[list(img_idx)] = True
    pose_grad = pose_vecs.grad.numpy()
    assert not pose_grad[~touched].any() and np.abs(pose_grad[touched]).max() > 1e-4
    np.testing.assert_allclose(pose_grad[touched], jcam_opt["m"][touched] / 0.1,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(pose_vecs.detach().numpy(), np.asarray(new_state["pose_vecs"]),
                               rtol=0, atol=1e-6)
    assert not np.array_equal(pose_vecs.detach().numpy()[touched], pose0[touched])
    np.testing.assert_array_equal(pose_vecs.detach().numpy()[~touched], pose0[~touched])
    for k in ("m", "v"):
        np.testing.assert_allclose(cam_opt[k].numpy(), jcam_opt[k], rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    assert int(cam_opt["step"]) == int(jcam_opt["step"]) == 1
    # the CPU runs the kernel's plain twin: no CUDA launch is counted
    assert all(c["launches"] == 0 for c in fm.launch_counts.values())


@pytest.mark.parametrize("img_idx", [[0], [1, 1]], ids=["one_image", "one_image_twice"])
def test_train_cameras_step_matches_jax(img_idx):
    conf = narrow(flagship_conf(num_pixels=48), "exact")
    check_camera_step(*setup(conf, perturb=False), img_idx=img_idx)


def test_full_width_train_cameras_step_matches_jax():
    """The trained-camera conf's model at its published widths (8x512 SDF,
    4x512 rendering, 256 features, SH views, 100 tracer steps), on 16 rays
    with the exact tracer through the fused kernel's plain twin."""
    conf = parse_file(str(TRAINED_CONF))
    conf.put("train.num_pixels", 16)
    conf.put("model.tracer_fast", "exact")
    conf.put("model.tracer_exact_fused", True)
    assert j_parse_file(str(TRAINED_CONF)).get_list("model.implicit_network.dims") == [512] * 8
    check_camera_step(*setup(conf, perturb=False), img_idx=[0])
