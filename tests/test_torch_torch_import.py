"""The port's reference-checkpoint importer against the JAX package's.

For each encoder family a ``.pth`` is written in the reference's layout
(``model_state_dict`` with ``lin{l}.weight_v/weight_g/bias``,
``dencity_net.beta`` and ``embed_model.embedder_obj.*``: the torch hash
grid's ``levels.{l}.embedding.weight`` and ``freq_encoding.B``, NFFB's
``grid_enc``, ``ff_lin{l}``, ``out_layer`` and
``StyleAttentionBlock.{linear_transform,attention}``, the Fourier ``B``)
with seeded random values.  It goes through the JAX package's
``torch_import`` plus the weight bridge (``from_jax_params``), and through
the port's ``torch_import``: the two state dicts are equal bit for bit.
A CamParameters file gives the same pose table, and both files load
without unpickling anything but tensors and ints.
"""

import re

import numpy as np
import jax
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.testing import flagship_conf as j_flagship_conf
from hashmodnffbanks_idr_tpu.train import torch_import as jti

from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf
from hashmodnffbanks_idr_tpu_torch.train import torch_import as ti
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

# (embed_type, viewdirs_embed_type): every family the importer maps, and a
# deep view encoder
FAMILIES = [("FFB", "SHEncoder"), ("StyleModNFFB", "StyleModNFFB"),
            ("HashGrid", "HashGrid"), ("FourierFeatures", "SHEncoder"),
            ("NerfPos", "NerfPos")]

# port parameter name -> reference name, for everything but grid tables
_RENAMES = [
    (r"^(implicit_network|rendering_network)\.lin\.(\d+)\.v$", r"\1.lin\2.weight_v"),
    (r"^(implicit_network|rendering_network)\.lin\.(\d+)\.g$", r"\1.lin\2.weight_g"),
    (r"^(implicit_network|rendering_network)\.lin\.(\d+)\.[wb]$", None),
    (r"^implicit_network\.density\.beta$", "implicit_network.dencity_net.beta"),
]


def _reference_name(name):
    name = re.sub(r"^implicit_network\.embedder\.", "implicit_network.embed_model.embedder_obj.",
                  name)
    name = re.sub(r"^rendering_network\.view_embedder\.",
                  "rendering_network.embed_model.embedder_obj.", name)
    name = re.sub(r"embedder_obj\.grid\.", "embedder_obj.grid_enc.", name)
    name = re.sub(r"\.ff\.B$", ".freq_encoding.B", name)
    name = re.sub(r"\.ff_lin\.(\d+)\.", r".ff_lin\1.", name)
    name = re.sub(r"\.style\.", ".StyleAttentionBlock.", name)
    name = re.sub(r"\.lin\.(\d+)\.", r".lin\1.", name)
    name = re.sub(r"\.v$", ".weight_v", name)
    name = re.sub(r"\.g$", ".weight_g", name)
    name = re.sub(r"\.w$", ".weight", name)
    name = re.sub(r"\.b$", ".bias", name)
    return name.replace("density.beta", "dencity_net.beta")


def reference_state_dict(model, seed):
    """The reference's state dict for a model of ``model``'s shapes, with
    seeded random values (tables split into per-level embeddings)."""
    rng = np.random.default_rng(seed)
    sd = {}
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        ref = _reference_name(name)
        if name.endswith(".table"):
            spec = modules[name[:-len(".table")]].spec
            prefix = ref[:-len(".table")]
            for l, size in enumerate(spec.level_sizes()):
                sd[f"{prefix}.levels.{l}.embedding.weight"] = torch.from_numpy(
                    rng.normal(size=(int(size), spec.level_dim)).astype(np.float32))
            continue
        shape = tuple(p.shape)
        if ref.endswith("weight_g"):
            shape = shape + (1,)  # torch weight_norm keeps g as (out, 1)
        sd[ref] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return sd


def _pair(embed, view):
    jconf = j_flagship_conf(num_pixels=64, small=True, embed_type=embed,
                            viewdirs_embed_type=view).get_config("model")
    jmodel = JIDRNetwork(jconf)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = IDRNetwork(flagship_conf(num_pixels=64, small=True, embed_type=embed,
                                     viewdirs_embed_type=view).get_config("model"),
                       device="cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    return jmodel, params, model


@pytest.mark.parametrize("embed,view", FAMILIES, ids=[f"{e}-{v}" for e, v in FAMILIES])
def test_import_matches_jax_bit_for_bit(tmp_path, embed, view):
    jmodel, params, model = _pair(embed, view)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = reference_state_dict(model, seed=len(embed))
    path = str(tmp_path / "2000.pth")
    torch.save({"epoch": 2000, "model_state_dict": sd}, path)

    jparams = jti.import_checkpoint(path, jmodel, params)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), model)
    got = ti.import_checkpoint(path, model)
    assert set(got) == set(want) == set(before)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    # every parameter the reference holds was imported; none other moved
    # (the NerfPos/SH encoders and the density have nothing to import, or
    # the same value as before)
    for k, v in got.items():
        ref = _reference_name(k)
        if ref in sd:
            assert torch.equal(v, sd[ref].reshape(v.shape)), k
        elif not k.endswith(".table"):
            assert torch.equal(v, before[k]), k
    tables = [k for k in got if k.endswith(".table")]
    assert all(not torch.equal(got[k], before[k]) for k in tables)
    if embed in ("FFB", "StyleModNFFB", "HashGrid"):
        assert tables
    model.load_state_dict(got)


def test_cam_parameters_and_model_load(tmp_path):
    """A CamParameters file -> the JAX importer's pose table, bit for bit;
    a ModelParameters file with its epoch loads under ``weights_only`` into
    a fresh model, which then holds the imported tensors."""
    _, _, model = _pair("StyleModNFFB", "SHEncoder")
    rng = np.random.default_rng(9)
    weight = rng.normal(size=(6, 7)).astype(np.float32)
    torch.save({"epoch": 2000, "pose_vecs_state_dict": {"weight": torch.from_numpy(weight)}},
               tmp_path / "cam.pth")
    got = ti.import_pose_vecs(ti.load_pth(str(tmp_path / "cam.pth")))
    want = np.asarray(jti.import_pose_vecs(jti.load_pth(str(tmp_path / "cam.pth"))))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, weight)

    sd = reference_state_dict(model, seed=3)
    torch.save({"epoch": 1500, "model_state_dict": sd}, tmp_path / "model.pth")
    imported = ti.import_checkpoint(str(tmp_path / "model.pth"), model)
    fresh = IDRNetwork(flagship_conf(num_pixels=64, small=True, viewdirs_embed_type="SHEncoder")
                       .get_config("model"), device="cpu", seed=5)
    fresh.load_state_dict(imported)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, imported[k]), k
    ref = "implicit_network.lin0.weight_v"
    assert torch.equal(fresh.state_dict()["implicit_network.lin.0.v"], sd[ref])


def test_mismatched_reference_shape_raises(tmp_path):
    _, _, model = _pair("FourierFeatures", "SHEncoder")
    sd = reference_state_dict(model, seed=1)
    sd["implicit_network.lin0.weight_v"] = sd["implicit_network.lin0.weight_v"].T.contiguous()
    with pytest.raises(ValueError):
        ti.import_model_state({k: v.numpy() for k, v in sd.items()}, model)
