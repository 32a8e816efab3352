"""The graphed train step's update on the CPU: its program run eagerly
(``build_train_step(graphed=True)`` without capture: the same static
buffers, draws taken before the program, the same masked update) against
the eager step, its Adam state, the update skipped for a non-finite
gradient, a tensor learning rate and alpha, and the learning rate through a
checkpoint.  The launched graph is held against the eager step on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models import loss as tloss
from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device, synthetic_scene
from hashmodnffbanks_idr_tpu_torch.train import trainer as tr

import torch_step_parity as tsp

ALPHA = 50.0
N_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _step_case(cameras=False, seed=0):
    conf = tsp.narrow(flagship_conf(num_pixels=N_RAYS), "exact", view="SHEncoder")
    model = IDRNetwork(conf.get_config("model"), device="cpu", seed=seed)
    scene_np = synthetic_scene(n_views=3, img_res=(32, 32), seed=0)
    pose_vecs = cam_opt = None
    if cameras:
        from hashmodnffbanks_idr_tpu_torch.geometry.cameras import rot_to_quat
        poses = scene_np["pose"]
        pose_vecs = torch.tensor(np.concatenate(
            [rot_to_quat(poses[:, :3, :3].astype(np.float64)), poses[:, :3, 3]], axis=1),
            dtype=torch.float32, requires_grad=True)
        cam_opt = tr.sparse_adam_init(pose_vecs)
    return model, scene_to_device(scene_np, "cpu"), pose_vecs, cam_opt


def _build(model, pose_vecs, cam_opt, graphed):
    return tr.build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), tr.make_optimizer(model),
                               pose_vecs=pose_vecs, cam_opt=cam_opt, graphed=graphed)


def _state(model, step, pose_vecs, cam_opt):
    """Every tensor a step may write, cloned."""
    out = {f"param/{n}": p.detach().clone() for n, p in model.named_parameters()}
    for i, p in enumerate(step.optimizer.state if hasattr(step, "optimizer") else ()):
        for k, v in step.optimizer.state[p].items():
            out[f"adam/{i}/{k}"] = v.clone()
    if pose_vecs is not None:
        out["pose_vecs"] = pose_vecs.detach().clone()
        out.update({f"cam_opt/{k}": v.clone() for k, v in cam_opt.items()})
    return out


def _bits_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(
            a[k].view(torch.int32) if a[k].dtype == torch.float32 else a[k],
            b[k].view(torch.int32) if b[k].dtype == torch.float32 else b[k]), k


@pytest.fixture(scope="module", params=[False, True], ids=["False", "True"])
def paired_runs(request):
    """Three steps of the eager step and three of the graphed step's
    program, each from the same weights and generator (with cameras when
    the parameter says so), the graphed step taking its draws before its
    program: each one's loss terms, parameters, Adam state, skip count and
    pose table with its SparseAdam state.  Shared by the tests below."""
    cameras = request.param
    results = {}
    for graphed in (False, True):
        model, scene, pose_vecs, cam_opt = _step_case(cameras)
        opt = tr.make_optimizer(model)
        step = tr.build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), opt,
                                   pose_vecs=pose_vecs, cam_opt=cam_opt, graphed=graphed)
        gen = torch.Generator().manual_seed(11)
        losses = []
        for i in range(3):
            pix = torch.randperm(32 * 32, generator=gen)[:N_RAYS]
            losses.append(step(scene, torch.tensor([i % 3]), pix, gen, ALPHA))
        results[graphed] = {
            "losses": losses, "skipped": step.skipped, "pose_vecs": pose_vecs,
            "cam_opt": cam_opt,
            "params": {f"param/{n}": p.detach().clone() for n, p in model.named_parameters()},
            "adam": {f"{n}/{k}": v.clone() for n, p in model.named_parameters()
                     for k, v in opt.state.get(p, {}).items()}}
    return cameras, results


def test_graphed_step_with_finite_gradients_equals_the_eager_step(paired_runs):
    """Three steps from the same weights and generator, the graphed step
    taking its draws before its program: loss terms, parameters, Adam state
    and (with cameras) the pose table and SparseAdam state bit-identical to
    the eager step's, and nothing skipped."""
    cameras, results = paired_runs
    eager, graphed = results[False], results[True]
    assert eager["skipped"] == graphed["skipped"] == 0
    for a, b in zip(eager["losses"], graphed["losses"]):
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _bits_equal(eager["params"], graphed["params"])
    if cameras:
        assert torch.equal(eager["pose_vecs"], graphed["pose_vecs"])
        for k in eager["cam_opt"]:
            assert torch.equal(eager["cam_opt"][k], graphed["cam_opt"][k]), k


def test_graphed_step_adam_state_equals_the_eager_steps(paired_runs):
    """The Adam moments and step counts after the three steps, graphed
    (state made before its first update) against eager (state made by
    Adam): equal bit for bit, for every parameter that has them."""
    _, results = paired_runs
    assert results[False]["adam"]
    _bits_equal(results[False]["adam"], results[True]["adam"])


@pytest.mark.parametrize("cameras,poison", [(False, "nan"), (False, "inf"), (True, "nan"),
                                            (True, "inf"), (True, "camera-nan")])
def test_masked_update_skips_a_nonfinite_step(cameras, poison):
    """A finite step, then one whose gradient is made NaN or inf (a hook on
    the SDF's last layer; with cameras also a NaN pose gradient alone): the
    parameters, Adam's moments and step counts, and with cameras the pose
    table and SparseAdam's state are bit-unchanged, the device counter
    reads one more, the loss terms of the skipped step are kept; the next
    finite step updates again."""
    model, scene, pose_vecs, cam_opt = _step_case(cameras, seed=2)
    step = _build(model, pose_vecs, cam_opt, graphed=True)
    gen = torch.Generator().manual_seed(9)
    pix = torch.randperm(1024, generator=gen)[:N_RAYS]
    step(scene, torch.tensor([0]), pix, gen, ALPHA)
    before = _state(model, step, pose_vecs, cam_opt)
    bad = float("nan") if "nan" in poison else float("inf")
    target = pose_vecs if poison == "camera-nan" else model.implicit_network.lin[-1].v
    handle = target.register_hook(lambda g: torch.full_like(g, bad))
    losses = step(scene, torch.tensor([1]), pix, gen, ALPHA)
    handle.remove()
    _bits_equal(before, _state(model, step, pose_vecs, cam_opt))
    assert step.skipped == 1
    kept = step.last_skipped_terms()
    assert list(kept) == list(losses)
    assert kept == pytest.approx({k: float(v) for k, v in losses.items()})
    step(scene, torch.tensor([2]), pix, gen, ALPHA)
    assert step.skipped == 1
    after = _state(model, step, pose_vecs, cam_opt)
    assert not torch.equal(after["param/implicit_network.lin.0.v"],
                           before["param/implicit_network.lin.0.v"])


def test_tensor_lr_and_alpha_match_float_ones():
    """Adam with a tensor learning rate against a float one (three steps of
    the same gradients, ``set_lr`` changing it between them), and the mask
    loss with a 0-d tensor alpha against a float one: bit-identical."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(5, 7, generator=gen) for _ in range(3)]
    init = torch.randn(5, 7, generator=gen)
    out = {}
    for kind in ("float", "tensor"):
        p = torch.nn.Parameter(init.clone())
        lr = 1e-3 if kind == "float" else torch.tensor(1e-3)
        opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for i, g in enumerate(grads):
            tr.set_lr(opt, 1e-3 * 0.5 ** i)
            p.grad = g.clone()
            opt.step()
        assert torch.is_tensor(opt.param_groups[0]["lr"]) == (kind == "tensor")
        out[kind] = p.detach().clone()
    assert torch.equal(out["float"], out["tensor"])

    sdf = torch.randn(64, 1, generator=gen) * 0.1
    net, obj = torch.rand(64, generator=gen) > 0.5, torch.rand(64, generator=gen) > 0.5
    for alpha in (50.0, 100.0, 800.0):
        want = tloss.mask_loss(sdf, net, obj, alpha, 64.0)
        got = tloss.mask_loss(sdf, net, obj, torch.tensor(alpha), 64.0)
        assert torch.equal(want, got), alpha


def test_checkpoint_keeps_the_optimizers_learning_rate(tmp_path):
    """A checkpoint's optimizer state loaded into an optimizer with a tensor
    learning rate keeps that tensor (the graphed step holds its address)
    and gives it the saved value; a float-rate optimizer stays float."""
    from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt

    model, _, _, _ = _step_case()
    opt = tr.make_optimizer(model, lr=3e-4)
    ckpt.save_checkpoint(str(tmp_path), 1, model, opt, 5)
    params = list(model.parameters())
    lr = torch.tensor(1e-4)
    other = torch.optim.Adam(params, lr=lr)
    ckpt.load_checkpoint(str(tmp_path), "latest", model, other)
    assert other.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(3e-4)
    plain = torch.optim.Adam(params, lr=1e-4)
    ckpt.load_checkpoint(str(tmp_path), "latest", model, plain)
    assert plain.param_groups[0]["lr"] == pytest.approx(3e-4)
