"""The port's small utilities, on the CPU.

* ``config/gen_confs.py``: the tree it writes is byte for byte the JAX
  generator's (each written into its own temporary directory), and it
  needs an output root;
* ``utils/profiling.py``: ``trace`` writes a Chrome trace and a
  ``key_averages`` table of a CPU window;
* ``utils/debug.py``: off by default; with ``HMNFFB_DEBUG_NANS=1``
  ``assert_finite`` and ``nan_guard`` name the tensor that holds a NaN or
  an infinity, and a backward that makes a NaN raises under the guard.
"""

import json
import os

import pytest
import torch

from hashmodnffbanks_idr_tpu.config import gen_confs as j_gen_confs

from hashmodnffbanks_idr_tpu_torch.config import gen_confs
from hashmodnffbanks_idr_tpu_torch.utils import debug, profiling


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_gen_confs_tree_equals_jax(tmp_path):
    j_gen_confs.main(str(tmp_path / "jax"))
    gen_confs.main(str(tmp_path / "port"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(want) == 9 * 2 + 4 + 2
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    with pytest.raises(TypeError):
        gen_confs.main()  # no default root: the JAX package's confs stay as committed


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "aten::mm" in (tmp_path / "prof" / "key_averages.txt").read_text()
    with profiling.trace(device="cpu") as prof:  # no logdir: nothing written
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert any("mm" in e.key for e in prof.key_averages())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prof"]


def test_debug_is_off_by_default(monkeypatch):
    monkeypatch.delenv("HMNFFB_DEBUG_NANS", raising=False)
    x = torch.tensor([1.0, float("nan")])
    assert debug.assert_finite(x, "x") is x

    def step():
        return {"loss": x}

    assert debug.nan_guard(step) is step


def test_debug_names_the_tensor(monkeypatch):
    monkeypatch.setenv("HMNFFB_DEBUG_NANS", "1")
    ok = torch.tensor([1.0, 2.0])
    assert debug.assert_finite(ok, "ok") is ok
    with pytest.raises(FloatingPointError, match="rgb_values: 1 NaN and 1 infinite of 3"):
        debug.assert_finite(torch.tensor([0.0, float("nan"), float("inf")]), "rgb_values")
    assert debug.assert_finite(torch.tensor([1, 2]), "ints") is not None

    def step(x):
        return {"loss": x.sum(), "terms": (x, x / 0.0)}

    guarded = debug.nan_guard(step)
    with pytest.raises(FloatingPointError, match=r"step\['terms'\]\[1\]"):
        guarded(torch.ones(2))
    out = debug.nan_guard(lambda x: {"loss": x.sum()})(torch.ones(3))
    assert float(out["loss"]) == 3.0


def test_nan_guard_catches_a_nan_backward(monkeypatch):
    monkeypatch.setenv("HMNFFB_DEBUG_NANS", "1")

    def step(x):
        y = torch.sqrt(x)  # d sqrt / dx at 0 is inf, times 0 gives NaN
        (y * 0.0).sum().backward()
        return {"grad": x.grad}

    with pytest.raises(RuntimeError, match="SqrtBackward0"):
        debug.nan_guard(step)(torch.zeros(3, requires_grad=True))
