"""Where the mixed tracer's float32 decisions run (``models/renderer.py``,
``IDRNetwork._tracer_sdfs``): on the f32 fused kernel wherever it launches,
by what the code observes (``fused_mlp.kernel_takes``: the network's
parameters on a CUDA device, the architecture the kernel is built for),
else on the float32 layer chain, ``ImplicitNetwork.sdf``.

On the CPU: the rule's predicate for each device and architecture, the
chain on every CPU network, and both branches of the dispatch with the
device read as the card's (the f32 closure then runs its plain twin, which
agrees with the chain).  The tracer modes other than 'mixed' keep their
decision SDFs.  The card's side is in ``tests/test_torch_cuda.py``.  The
file imports nothing of JAX.
"""

import math

import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models import renderer
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf

CUDA = torch.device("cuda")
# the SDF networks' widths in the benchmark's configurations: d_in 59
# (StyleModNFFB), 15 (the hash grid), 31 (FFBTcnn); 8 x 512, 1 + 256 out
FLAGSHIP = [59] + [512] * 8 + [257]


@pytest.mark.parametrize("d_in", [3, 15, 31, 59, 102, 511])
@pytest.mark.parametrize("device", [CUDA, "cuda:1", "cpu"])
def test_kernel_takes_the_standard_architecture_on_a_cuda_device(d_in, device):
    dims = [d_in] + FLAGSHIP[1:]
    assert fm.kernel_takes(dims, (4,), device) == (torch.device(device).type == "cuda")


@pytest.mark.parametrize("dims,skip_in", [
    (FLAGSHIP, (3,)),                        # another skip
    (FLAGSHIP, (4, 6)),                      # two skips
    (FLAGSHIP, ()),                          # no skip
    ([59] + [256] * 8 + [257], (4,)),        # another width, which supports_fusion takes
    ([59] + [512] * 7 + [256, 257], (4,)),   # widths that differ
    ([59] + [512] * 6 + [257], (4,)),        # fewer layers
    ([512] + [512] * 8 + [257], (4,)),       # d_in at the hidden width
])
def test_kernel_takes_no_other_architecture(dims, skip_in):
    assert not fm.kernel_takes(dims, skip_in, CUDA)
    assert not fm.kernel_takes(dims, skip_in, "cpu")


def _model(mode="mixed", dims=None, skip_in=None, exact_fused=False):
    """The flagship model on the CPU (StyleModNFFB, d_in 59; 8 x 512 unless
    ``dims``/``skip_in`` say otherwise), tracer mode ``mode``."""
    conf = flagship_conf(num_pixels=64)
    conf.put("model.tracer_fast", mode)
    conf.put("model.tracer_exact_fused", exact_fused)
    if dims is not None:
        conf.put("model.implicit_network.dims", dims)
    if skip_in is not None:
        conf.put("model.implicit_network.skip_in", skip_in)
    return IDRNetwork(conf.get_config("model"), device="cpu", seed=0)


def _as_on_the_card(monkeypatch):
    """The rule as it reads a network on the card: the predicate given a
    CUDA device in place of the parameters' (CPU) one."""
    real = fm.kernel_takes
    monkeypatch.setattr(renderer.fm, "kernel_takes",
                        lambda dims, skip_in, device: real(dims, skip_in, CUDA))


def _count_fused_calls(monkeypatch):
    calls = []
    real = fm.fused_sdf_raw

    def counted(x, packed):
        calls.append((x.shape[0], packed["w_out"].dtype))
        return real(x, packed)

    monkeypatch.setattr(fm, "fused_sdf_raw", counted)
    return calls


def _points(n=96, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 3, generator=g) * 2 - 1) * 0.6


def test_mixed_decisions_stay_on_the_chain_on_the_cpu():
    """On the CPU the mixed decisions are the layer chain, as before: the
    bound ``sdf`` of the model's own implicit network (so the JAX parity
    tests run the same path bit for bit)."""
    model = _model()
    decide, guidance = model._tracer_sdfs()
    assert decide == model.implicit_network.sdf
    assert set(guidance) == {"march", "coarse"}


def test_mixed_decisions_take_the_f32_kernel_where_it_launches(monkeypatch):
    """With the parameters read as the card's, the standard architecture's
    decisions are the f32 fused closure: each query one ``fused_sdf_raw``
    call with float32 weights, the guidance's calls bf16, and the closure's
    SDF the chain's within the kernel's tolerance (its plain twin here)."""
    _as_on_the_card(monkeypatch)
    model = _model()
    net = model.implicit_network
    calls = _count_fused_calls(monkeypatch)
    with torch.no_grad():
        decide, guidance = model._tracer_sdfs()
        assert decide != net.sdf
        x = _points()
        got = decide(x)
        assert calls == [(x.shape[0], torch.float32)]
        guidance["march"](x)
        assert calls[1:] == [(x.shape[0], torch.bfloat16)]
        want = net.sdf(x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("arch", ["skip 3", "width 256"])
def test_mixed_decisions_keep_the_chain_where_the_kernel_does_not_launch(monkeypatch, arch):
    """An architecture the kernel refuses (another skip, another width)
    keeps the chain, with the parameters read as the card's."""
    _as_on_the_card(monkeypatch)
    kw = {"skip 3": dict(skip_in=[3]), "width 256": dict(dims=[256] * 8)}[arch]
    model = _model(**kw)
    assert not fm.kernel_takes(model.implicit_network.dims, model.implicit_network.skip_in,
                               CUDA)
    decide, _ = model._tracer_sdfs()
    assert decide == model.implicit_network.sdf


def test_other_tracer_modes_keep_their_decisions(monkeypatch):
    """With the parameters read as the card's: 'exact' without
    ``tracer_exact_fused`` keeps the chain and no guidance; 'fast' decides
    with the bf16 closure; 'exact' with it, the f32 closure, as before."""
    _as_on_the_card(monkeypatch)
    calls = _count_fused_calls(monkeypatch)
    x = _points(8)
    exact = _model("exact")
    decide, guidance = exact._tracer_sdfs()
    assert decide == exact.implicit_network.sdf and guidance is None
    with torch.no_grad():
        _model("fast")._tracer_sdfs()[0](x)
        _model("exact", exact_fused=True)._tracer_sdfs()[0](x)
    assert [dtype for _, dtype in calls] == [torch.bfloat16, torch.float32]


def test_mixed_trace_on_the_f32_closure_agrees_with_the_chain(monkeypatch):
    """A mixed training forward of the flagship (64 rays) with the decisions
    on the f32 closure (its plain twin on the CPU) against the chain, same
    weights and draws: the same hit masks, the points within the tracer's
    ``sdf_threshold`` of each other, the same loss to 1e-5."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.testing import scene_to_device, synthetic_scene
    from hashmodnffbanks_idr_tpu_torch.train.trainer import loss_fn

    scene = scene_to_device(synthetic_scene(n_views=1, img_res=(16, 16), seed=0), "cpu")
    pix = torch.randperm(256, generator=torch.Generator().manual_seed(1))[:64]
    outs = []
    for on_card in (False, True):
        with monkeypatch.context() as m:
            if on_card:
                _as_on_the_card(m)
            calls = _count_fused_calls(m)
            model = _model()
            draws = model.draw_uniforms(torch.Generator().manual_seed(2), 64, "cpu")
            captured = {}
            model.register_forward_hook(lambda mod, a, o: captured.update(o))
            loss = loss_fn(model, IDRLossConfig(0.1, 200.0, 50.0), scene,
                           torch.tensor([0]), pix, None, 50.0, draws=draws)["loss"]
            f32 = sum(dtype == torch.float32 for _, dtype in calls)
            outs.append((float(loss.detach()), captured["network_object_mask"],
                         captured["points"].detach(), f32))
    (l0, m0, p0, f0), (l1, m1, p1, f1) = outs
    assert f0 == 0 and f1 > 0
    assert math.isfinite(l0) and abs(l1 - l0) <= 1e-5 * abs(l0)
    assert torch.equal(m0, m1)
    threshold = model.ray_tracer.sdf_threshold
    assert float((p0 - p1).norm(dim=-1).max()) <= threshold
