"""The port's data path against OpenCV and the JAX package: the numpy PNG
reader bit for bit against ``cv2.imread`` (files written by cv2's adaptive
filtering, and files whose rows use each of the five filters), unsupported
PNGs raising, the writer read back by cv2, the dummy generator, and
``SceneDataset`` against the JAX one (pixels exact, cameras atol 1e-6).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hashmodnffbanks_idr_tpu.data.dummy import generate_dummy_scene as j_generate_dummy_scene
from hashmodnffbanks_idr_tpu.data.scene_dataset import SceneDataset as JSceneDataset

from hashmodnffbanks_idr_tpu_torch.data import image_io
from hashmodnffbanks_idr_tpu_torch.data.dummy import generate_dummy_scene
from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset

H, W = 37, 53


def _images():
    """Smooth (so cv2's adaptive filtering picks Average and Paeth rows) and
    random content, in each supported channel count."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([np.sin(xx / 7.0) * 80 + 100 + yy, np.cos(yy / 5.0) * 60 + 120,
                       (xx * 3 + yy * 2) % 256], axis=-1).astype(np.uint8)
    return {
        "smooth_rgb": smooth,
        "smooth_gray": np.ascontiguousarray(smooth[..., 0]),
        "smooth_rgba": np.concatenate([smooth, smooth[..., 1:2]], axis=-1),
        "noise_rgb": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        "noise_gray": rng.integers(0, 256, (H, W), dtype=np.uint8),
        "noise_rgba": rng.integers(0, 256, (H, W, 4), dtype=np.uint8),
    }


def _cv2_unchanged_rgb(path):
    """cv2's IMREAD_UNCHANGED in the file's channel order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _row_filters(path):
    """The filter byte of every row of an 8-bit PNG."""
    data = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        ihdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else ihdr
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, _, color, *_ = ihdr
    stride = 1 + w * {0: 1, 2: 3, 6: 4}[color]
    raw = zlib.decompress(idat)
    return {raw[r * stride] for r in range(h)}


def _check_against_cv2(path, img):
    got = image_io.read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_unchanged_rgb(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(
        image_io.load_rgb(path), cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                                              cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(image_io.load_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


# libpng's filter choices as cv2 exposes them: its default, the adaptive
# choice among all five per row, and each filter alone
CV2_FILTERS = {"default": None, "adaptive": "IMWRITE_PNG_ALL_FILTERS",
               "none": "IMWRITE_PNG_FILTER_NONE", "sub": "IMWRITE_PNG_FILTER_SUB",
               "up": "IMWRITE_PNG_FILTER_UP", "average": "IMWRITE_PNG_FILTER_AVG",
               "paeth": "IMWRITE_PNG_FILTER_PAETH"}


@pytest.mark.parametrize("cv2_filter", list(CV2_FILTERS))
@pytest.mark.parametrize("name", list(_images()))
def test_reader_matches_cv2_on_cv2_written_files(tmp_path, name, cv2_filter):
    img = _images()[name]
    path = str(tmp_path / "cv2.png")
    bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    flag = CV2_FILTERS[cv2_filter]
    assert cv2.imwrite(path, bgr, [] if flag is None else
                       [cv2.IMWRITE_PNG_FILTER, getattr(cv2, flag)])
    if cv2_filter == "adaptive" and name.startswith("smooth"):
        # libpng mixes filters row by row, Average or Paeth among them
        assert {3, 4} & _row_filters(path) and len(_row_filters(path)) > 1
    _check_against_cv2(path, img)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("name", ["smooth_rgb", "noise_gray", "noise_rgba"])
def test_reader_undoes_each_filter(tmp_path, name, filters):
    img = _images()[name]
    if filters == "mixed":
        filters = np.random.default_rng(1).integers(0, 5, H)
    path = str(tmp_path / "f.png")
    image_io.write_png(path, img, filters=filters)
    assert _row_filters(path) == set(np.atleast_1d(filters).tolist())
    _check_against_cv2(path, img)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(color, depth=8, interlace=0, w=4, h=3, bpp=1):
    raw = b"".join(b"\x00" + bytes(w * bpp) for _ in range(h))
    return (image_io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["palette", "gray_alpha", "16bit", "interlaced", "bad_crc",
                                  "not_png", "truncated", "bad_filter"])
def test_unsupported_pngs_raise(tmp_path, case):
    path = str(tmp_path / "bad.png")
    if case == "16bit":
        assert cv2.imwrite(path, np.arange(12, dtype=np.uint16).reshape(3, 4) * 1000)
    else:
        data = {
            "palette": _png(3),
            "gray_alpha": _png(4, bpp=2),
            "interlaced": _png(0, interlace=1),
            "not_png": b"GIF89a" + bytes(40),
            "truncated": _png(0)[:-20],
        }.get(case)
        if case == "bad_crc":
            good = bytearray(_png(0))
            good[20] ^= 1  # inside IHDR's width
            data = bytes(good)
        if case == "bad_filter":
            raw = b"\x07" + bytes(4) + (b"\x00" + bytes(4)) * 2
            data = (image_io.PNG_SIGNATURE
                    + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 3, 8, 0, 0, 0, 0))
                    + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError):
        image_io.read_png(path)


@pytest.mark.parametrize("name", ["smooth_rgb", "noise_gray", "noise_rgba"])
def test_writer_reads_back_through_cv2(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(_cv2_unchanged_rgb(path), img)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same 3-view 32x32 dummy scene written by the JAX generator
    (cv2) and by the port's (image_io)."""
    root = tmp_path_factory.mktemp("scenes")
    kw = dict(n_views=3, image_size=32, seed=0)
    j_generate_dummy_scene(str(root / "jax" / "dummy" / "scan0"), **kw)
    generate_dummy_scene(str(root / "port" / "dummy" / "scan0"), **kw)
    return root


def test_dummy_generator_matches_jax(scenes):
    for sub in ("image", "mask"):
        names = sorted(os.listdir(scenes / "jax/dummy/scan0" / sub))
        assert names == sorted(os.listdir(scenes / "port/dummy/scan0" / sub))
        for n in names:
            want = cv2.imread(str(scenes / "jax/dummy/scan0" / sub / n), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(scenes / "port/dummy/scan0" / sub / n), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{n}")
    for npz in ("cameras.npz", "cameras_linear_init.npz"):
        want, got = (np.load(scenes / side / "dummy/scan0" / npz) for side in ("jax", "port"))
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{npz}:{k}")


def test_scene_dataset_matches_jax(scenes):
    root = str(scenes / "jax")
    jds = JSceneDataset(False, "dummy", [32, 32], 0, data_root=root)
    ds = SceneDataset(False, "dummy", [32, 32], 0, data_root=root)
    assert len(ds) == len(jds) == 3 and ds.total_pixels == 1024
    np.testing.assert_array_equal(ds.rgb_images, jds.rgb_images)
    np.testing.assert_array_equal(ds.object_masks, jds.object_masks)
    assert ds.rgb_images.dtype == np.uint8 and ds.object_masks.dtype == bool
    for got, want in ((ds.uv, jds.uv), (ds.intrinsics_all, jds.intrinsics_all),
                      (ds.pose_all, jds.pose_all), (ds.get_pose_init(), jds.get_pose_init()),
                      (ds.get_gt_pose(), jds.get_gt_pose()),
                      (ds.get_gt_pose(scaled=True), jds.get_gt_pose(scaled=True)),
                      (ds.get_scale_mat(), jds.get_scale_mat())):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    (s, gt), (js, jgt) = ds.full_image_inputs(1), jds.full_image_inputs(1)
    for k in js:
        np.testing.assert_allclose(s[k], js[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(gt["rgb"], jgt["rgb"], rtol=0, atol=1e-6)

    arrays = ds.device_arrays("cpu")
    assert arrays["rgb"].dtype == torch.uint8 and arrays["mask"].dtype == torch.bool
    for k, v in jds.device_arrays().items():
        np.testing.assert_array_equal(arrays[k].numpy(), v, err_msg=k)


def test_scene_dataset_reads_the_port_generator_scene(scenes):
    a = SceneDataset(False, "dummy", [32, 32], 0, data_root=str(scenes / "jax"))
    b = SceneDataset(False, "dummy", [32, 32], 0, data_root=str(scenes / "port"))
    np.testing.assert_array_equal(a.rgb_images, b.rgb_images)
    np.testing.assert_array_equal(a.object_masks, b.object_masks)


def test_scene_dataset_raises_on_missing_files(scenes, tmp_path):
    with pytest.raises(FileNotFoundError):
        SceneDataset(False, "nope", [32, 32], 0, data_root=str(scenes / "jax"))
    scan = tmp_path / "dummy" / "scan0"
    generate_dummy_scene(str(scan), n_views=2, image_size=32)
    os.remove(scan / "mask" / "001.png")
    with pytest.raises(FileNotFoundError):
        SceneDataset(False, "dummy", [32, 32], 0, data_root=str(tmp_path))
    with pytest.raises(ValueError):  # the conf's size differs from the files'
        generate_dummy_scene(str(scan), n_views=2, image_size=16)
        SceneDataset(False, "dummy", [32, 32], 0, data_root=str(tmp_path))
