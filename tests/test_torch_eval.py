"""The port's eval path against the JAX package's, on the CPU.

The repo's dummy StyleModNFFB conf narrowed (SDF MLP 8x64, rendering 64,
32 features, 28 tracer steps, exact tracer) on a 3-view 32x32 dummy scene,
with the JAX package's weights bridged into the port (``from_jax_params``):

* ``Evaluator.render_view`` (``training=False``): hit masks agree on >= 99%
  of pixels; rgb and dists within 1e-4 where both hit; ``eval_rendering``'s
  PSNR mean within 1e-2 dB, SSIM within 1e-4, LPIPS within 1e-4;
* ``surface``: SDF grid values within 1e-5; ``get_surface_mesh`` gives the
  same face count with triangle corners within 1e-4 on the geometric-init
  network, ``get_surface_high_res_mesh`` the same surface (see its test),
  ``export_surface`` the same faces in world coordinates (1e-4);
* ``camera_alignment`` to 1e-12 (a copy), ``Decoder`` to 1e-6,
  ``spline_camera_orbit`` to 1e-5;
* end to end: a 2-epoch run of the port's ``exp_runner`` with plots every
  epoch, ``run_eval --platform cpu --resolution 32 --eval_rendering`` (and
  ``--is_uniform_grid``) and ``render_disentangled`` with 2 frames write
  every artifact with finite metrics.
"""

import json
import os
import pathlib

import numpy as np
import jax
import pytest
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse_file as j_parse_file
from hashmodnffbanks_idr_tpu.data.dummy import _look_at
from hashmodnffbanks_idr_tpu.eval import surface as j_surface
from hashmodnffbanks_idr_tpu.eval.disentanglement import spline_camera_orbit as j_orbit
from hashmodnffbanks_idr_tpu.eval.evaluator import Evaluator as JEvaluator
from hashmodnffbanks_idr_tpu.eval.evaluator import camera_alignment as j_camera_alignment
from hashmodnffbanks_idr_tpu.models.decoder import Decoder as JDecoder
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.utils.ply import read_ply as j_read_ply

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
from hashmodnffbanks_idr_tpu_torch.data.image_io import read_png
from hashmodnffbanks_idr_tpu_torch.eval import disentanglement, run_eval, surface
from hashmodnffbanks_idr_tpu_torch.eval.evaluator import Evaluator, camera_alignment
from hashmodnffbanks_idr_tpu_torch.models.decoder import Decoder, pre_train_sphere
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.train import exp_runner
from hashmodnffbanks_idr_tpu_torch.train import trainer as port_trainer
from hashmodnffbanks_idr_tpu_torch.utils.ply import read_ply
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

DUMMY_CONF = str(pathlib.Path(__file__).resolve().parents[1]
                 / "hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf")
NARROW = {
    "model.implicit_network.dims": [64] * 8,
    "model.rendering_network.dims": [64, 64],
    "model.feature_vector_size": 32,
    "model.ray_tracer.n_steps": 28,
    "model.tracer_fast": "exact",
    "train.num_pixels": 64,
    "dataset.img_res": [32, 32],
    "plot.resolution": 24,
}
VIEWS = [0, 1, 2]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Many small ops: with every test worker on torch's default thread pool
    they crawl (as in tests/test_torch_runner.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The narrowed conf, the dummy scene, JAX params and the port model
    holding the same weights."""
    root = tmp_path_factory.mktemp("eval")
    dummy_cli.main(["--out", str(root / "data" / "dummy" / "scan0"), "--views", "3",
                    "--size", "32"])
    conf = parse_file(DUMMY_CONF)
    for k, v in NARROW.items():
        conf.put(k, v)
    conf_path = root / "narrow.conf"
    conf_path.write_text(conf.dump())
    jconf = j_parse_file(str(conf_path))
    jmodel = JIDRNetwork(jconf.get_config("model"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = IDRNetwork(conf.get_config("model"), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    data_root = str(root / "data")
    return {"root": root, "conf_path": str(conf_path), "conf": conf, "jconf": jconf,
            "jmodel": jmodel, "params": params, "model": model, "data_root": data_root,
            "ev": Evaluator(conf, model, data_root=data_root),
            "jev": JEvaluator(jconf, params, data_root=data_root, tile=1024)}


@pytest.mark.parametrize("idx", VIEWS)
def test_render_view_matches_jax(setup, idx):
    got, want = setup["ev"].render_view(idx), setup["jev"].render_view(idx)
    assert got["mask"].any() and not got["mask"].all()
    assert (got["mask"] == want["mask"]).mean() >= 0.99
    both = got["mask"] & want["mask"]
    np.testing.assert_allclose(got["rgb"][both], want["rgb"][both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["dists"][both], want["dists"][both], rtol=0, atol=1e-4)
    assert (got["rgb"][~got["mask"]] == 1.0).all()  # misses render white
    np.testing.assert_array_equal(got["gt_rgb"], want["gt_rgb"])
    np.testing.assert_array_equal(got["gt_mask"], want["gt_mask"])


def test_eval_render_normals_need_no_graph(setup):
    """Under ``torch.no_grad()`` the normals' gradient keeps no graph
    (``create_graph=False``); the outputs are bit-identical to a forward
    run with grad enabled."""
    ev, model = setup["ev"], setup["model"]
    sample, _ = ev.dataset.full_image_inputs(1)
    inputs = {k: torch.as_tensor(np.asarray(sample[k])) for k in
              ("uv", "intrinsics", "pose", "object_mask")}
    outs = []
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            out = model(inputs, generator=torch.Generator().manual_seed(0), training=False)
        assert out["rgb_values"].requires_grad == grad
        outs.append(out)
    for k in ("rgb_values", "network_object_mask", "dists"):
        assert torch.equal(outs[0][k].detach(), outs[1][k]), k


def test_eval_rendering_matches_jax(setup, tmp_path):
    got = setup["ev"].eval_rendering(str(tmp_path / "port"))
    want = setup["jev"].eval_rendering(str(tmp_path / "jax"))
    np.testing.assert_allclose(got["psnr_mean"], want["psnr_mean"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["ssim_mean"], want["ssim_mean"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["lpips_mean"], want["lpips_mean"], rtol=0, atol=1e-4)
    assert got["lpips_weights"] == want["lpips_weights"] == "fallback"
    for name in ("psnrs.csv", "ssims.csv", "lpips.csv"):
        assert (tmp_path / "port" / "metrics" / name).exists()
    for i in VIEWS:
        a = read_png(str(tmp_path / "port" / "renders" / f"{i:03d}.png"))
        b = read_png(str(tmp_path / "jax" / "renders" / f"{i:03d}.png"))
        assert a.shape == b.shape == (32, 64, 3)
        assert (np.abs(a.astype(int) - b.astype(int)) <= 1).mean() >= 0.99


def _jax_sdf(setup):
    p_impl = setup["params"]["implicit_network"]
    return lambda x: setup["jmodel"].implicit_network.sdf(p_impl, x)


def test_surface_grid_values_match_jax(setup):
    pts, _ = surface.grid_points(32, np.array([[-1.0] * 3, [1.0] * 3]))
    got = surface.make_chunked_sdf(setup["model"].implicit_network.sdf, chunk=8192,
                                   device="cpu")(pts)
    want = j_surface.make_chunked_sdf(_jax_sdf(setup), chunk=8192)(pts)
    assert got.dtype == np.float32 and got.shape == (32**3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got < 0).any() and (got > 0).any()


def _ellipsoid_sdfs(setup):
    """The geometric-init SDF is a sphere, whose coarse-mesh PCA frame is
    degenerate (any rotation is principal), so both networks are evaluated
    on anisotropically scaled points: an ellipsoid with a well-defined frame."""
    scale = np.array([1.0, 1.4, 0.75], np.float32)
    net, jsdf = setup["model"].implicit_network, _jax_sdf(setup)
    return lambda x: net.sdf(x * torch.as_tensor(scale)), lambda x: jsdf(x * scale)


def test_surface_mesh_matches_jax(setup):
    sdf, j_sdf = _ellipsoid_sdfs(setup)
    v, f = surface.get_surface_mesh(sdf, resolution=32, device="cpu")
    jv, jf = j_surface.get_surface_mesh(j_sdf, resolution=32)
    assert len(f) == len(jf) > 100
    np.testing.assert_allclose(v[f], jv[jf], rtol=0, atol=1e-4)


def test_export_surface_matches_jax(setup, tmp_path):
    """The uniform-grid mesh that ``run_eval --is_uniform_grid`` writes, in
    world coordinates: the same faces, triangle corners within 1e-4."""
    sdf, j_sdf = _ellipsoid_sdfs(setup)
    transform = np.diag([2.0, 2.0, 2.0, 1.0])
    transform[:3, 3] = [0.1, -0.2, 0.3]
    v, f = surface.export_surface(str(tmp_path / "port.ply"), sdf, resolution=24,
                                  transform=transform, device="cpu")
    jv, jf = j_surface.export_surface(str(tmp_path / "jax.ply"), j_sdf, resolution=24,
                                      transform=transform)
    assert len(f) == len(jf) > 100
    np.testing.assert_allclose(v[f], jv[jf], rtol=0, atol=1e-4)
    rv, rf = read_ply(str(tmp_path / "port.ply"))
    jrv, jrf = j_read_ply(str(tmp_path / "jax.ply"))
    np.testing.assert_allclose(rv[rf], jrv[jrf], rtol=0, atol=1e-4)


def test_surface_high_res_mesh_matches_jax(setup):
    """Widened from "same face count, vertices within 1e-4": the coarse
    100^3 pass's SDF values agree to 7e-7, but where both corners of a grid
    edge are that close to zero the interpolated vertex moves by up to 7e-4,
    which turns the PCA frame by about 1e-3 rad; the fine grid then samples
    other points.  So the two meshes are held as surfaces: face counts
    within 0.1%, and a mean distance from each mesh's vertices to the
    other's of at most 1e-3 (the fine grid's spacing is about 4e-2)."""
    from scipy.spatial import cKDTree

    sdf, j_sdf = _ellipsoid_sdfs(setup)
    v, f = surface.get_surface_high_res_mesh(sdf, resolution=32, device="cpu")
    jv, jf = j_surface.get_surface_high_res_mesh(j_sdf, resolution=32)
    assert len(jf) > 100 and abs(len(f) - len(jf)) <= 1e-3 * len(jf)
    assert cKDTree(jv).query(v)[0].mean() <= 1e-3
    assert cKDTree(v).query(jv)[0].mean() <= 1e-3


def test_camera_alignment_is_the_jax_copy():
    rng = np.random.default_rng(2)
    Rs = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(10)])
    Rs[np.linalg.det(Rs) < 0, :, 0] *= -1
    ts = rng.normal(size=(10, 3))
    pred_R = Rs @ np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pred_t = ts * 0.7 + 0.1 * rng.normal(size=ts.shape)
    got, want = camera_alignment(pred_R, Rs, pred_t, ts), j_camera_alignment(pred_R, Rs, pred_t, ts)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


def test_decoder_matches_jax_and_fits_a_sphere():
    jdec = JDecoder(3, [32, 32], 1)
    jparams = jdec.init(jax.random.PRNGKey(0))
    dec = Decoder(3, [32, 32], 1)
    dec.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), dec))
    pts = np.random.default_rng(0).uniform(-1, 1, (500, 3)).astype(np.float32)
    with torch.no_grad():
        got = dec(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdec.apply(jparams, pts)), rtol=0, atol=1e-6)

    dec = Decoder(3, [32, 32], 1).reset_parameters(torch.Generator().manual_seed(0))
    loss = pre_train_sphere(dec, torch.Generator().manual_seed(1), iters=300, radius=0.3,
                            lr=1e-3)
    assert loss < 0.01
    with torch.no_grad():
        inside, outside = dec(torch.tensor([[0.0, 0.0, 0.0], [0.45, 0.0, 0.0]]))[:, 0]
    assert inside < 0 < outside


def test_spline_camera_orbit_matches_jax():
    poses = []
    for phi in np.linspace(0, 1.5 * np.pi, 4):
        pos = 2.0 * np.array([np.cos(phi), 0.3, np.sin(phi)])
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = _look_at(pos).T
        P[:3, 3] = pos
        poses.append(P)
    poses = np.stack(poses)
    got, want = disentanglement.spline_camera_orbit(poses, 7), j_orbit(poses, 7)
    assert got.shape == (7, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_swap_appearance_takes_only_the_rendering_network(setup):
    geo = setup["model"].state_dict()
    app = {k: v + 1.0 for k, v in geo.items()}
    out = disentanglement.swap_appearance(geo, app)
    assert out.keys() == geo.keys()
    for k, v in out.items():
        assert v is (app[k] if k.startswith("rendering_network.") else geo[k]), k


def test_plot_failure_does_not_stop_training(setup, tmp_path, monkeypatch, capsys):
    """A failing plot is printed with its traceback and training goes on
    (JAX train/trainer.py:313-317)."""
    import hashmodnffbanks_idr_tpu_torch.eval.plots as plots

    def broken(*a, **k):
        raise RuntimeError("plot broke")

    monkeypatch.setattr(plots, "plot_epoch", broken)
    conf = parse_file(setup["conf_path"])
    conf.put("train.plot_freq", 1)
    runner = port_trainer.IDRTrainRunner(conf, nepochs=1, exps_folder_name=str(tmp_path),
                                         data_root=setup["data_root"], log_tensorboard=False,
                                         device="cpu")
    runner.run()
    captured = capsys.readouterr()
    assert "[plot @1] failed" in captured.out and "plot broke" in captured.err
    assert sorted(os.listdir(runner.checkpoints_path)) == ["0.pt", "1.pt", "latest.pt"]


def test_end_to_end_train_eval_disentangle(setup, tmp_path):
    conf = parse_file(setup["conf_path"])
    conf.put("train.plot_freq", 1)
    conf_path = tmp_path / "plots.conf"
    conf_path.write_text(conf.dump())
    exps, evals = str(tmp_path / "exps"), str(tmp_path / "evals")
    runner = exp_runner.main(["--conf", str(conf_path), "--nepoch", "2", "--data_root",
                              setup["data_root"], "--exps_folder_name", exps, "--platform",
                              "cpu", "--no_tensorboard"])
    want = sorted(f"{k}_{e}.{x}" for e in (1, 2) for k, x in (
        ("rendering", "png"), ("depth", "png"), ("surface", "ply"), ("surface", "html"),
        ("cameras", "ply")))
    assert sorted(os.listdir(runner.plots_dir)) == want
    grid = read_png(os.path.join(runner.plots_dir, "rendering_2.png"))
    assert grid.shape == (32, 96, 3)

    res = run_eval.main(["--conf", str(conf_path), "--data_root", setup["data_root"],
                         "--platform", "cpu", "--resolution", "32", "--eval_rendering",
                         "--eval_cameras", "--exps_folder", exps, "--evals_folder", evals])
    assert res["epoch"] == 2
    assert os.path.basename(res["mesh"]) == "surface_world_coordinates_2.ply"
    assert os.path.getsize(res["mesh"]) > 1000
    with open(os.path.join(res["eval_dir"], "metrics", "summary.json")) as f:
        summary = json.load(f)
    for k in ("psnr_mean", "ssim_mean", "lpips_mean", "mesh_s", "render_s"):
        assert np.isfinite(summary[k]), k
    assert summary["lpips_weights"] == "fallback" and summary["epoch"] == 2
    for name in ("psnrs.csv", "ssims.csv", "lpips.csv"):
        rows = (pathlib.Path(res["eval_dir"]) / "metrics" / name).read_text().split()
        assert len(rows) == 3 and all(np.isfinite(float(r.split(",")[1])) for r in rows)

    uniform = run_eval.main(["--conf", str(conf_path), "--data_root", setup["data_root"],
                             "--platform", "cpu", "--resolution", "24", "--is_uniform_grid",
                             "--exps_folder", exps, "--evals_folder", str(tmp_path / "uni")])
    v, f = read_ply(uniform["mesh"])
    assert len(f) > 100 and uniform["metrics"] is None

    out = disentanglement.main(["--conf", str(conf_path), "--geometry_run_dir", runner.rundir,
                                "--appearance_run_dir", runner.rundir, "--n_frames", "2",
                                "--data_root", setup["data_root"], "--platform", "cpu",
                                "--out_dir", str(tmp_path / "dis")])
    frames = sorted(os.listdir(out))
    assert frames == ["frame_000.png", "frame_001.png"]
    for name in frames:
        img = read_png(os.path.join(out, name))
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
