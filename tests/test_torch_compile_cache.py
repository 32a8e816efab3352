"""The port's kernel build cache (``utils/compile_cache.py``): the
directory follows ``HMNFFB_COMPILE_CACHE`` (the JAX module's variable) and
defaults to ``build/``; the runner turns it on; and ``build_once`` lets
rank 0 of a process group build first while the other ranks wait, shown
with a stub build (there is no ``nvcc`` here) in three gloo ranks.
"""

import pathlib

import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.parallel import multihost
from hashmodnffbanks_idr_tpu_torch.utils import compile_cache

import torch_dist_workers as workers
from test_torch_runner import _write_setup

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fresh(monkeypatch):
    """No directory fixed by an earlier ``enable_compile_cache``."""
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.delenv("HMNFFB_COMPILE_CACHE", raising=False)
    return monkeypatch


def test_default_is_the_repos_build_dir(fresh):
    assert compile_cache.cache_dir() == ROOT / "build"
    assert fm._lib_path().parent == ROOT / "build"


def test_env_variable_is_honoured(fresh, tmp_path):
    fresh.setenv("HMNFFB_COMPILE_CACHE", str(tmp_path / "cache"))
    assert compile_cache.cache_dir() == tmp_path / "cache"
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cache")
    assert (tmp_path / "cache").is_dir()
    # the kernel library and its ptxas report go there
    assert fm._lib_path().parent == tmp_path / "cache"
    assert fm.ptxas_report().parent == tmp_path / "cache"
    # an explicit path wins over the variable
    assert compile_cache.enable_compile_cache(str(tmp_path / "other")) == str(tmp_path / "other")
    assert fm._lib_path().parent == tmp_path / "other"


def test_runner_enables_the_cache(fresh, tmp_path):
    from hashmodnffbanks_idr_tpu_torch.train import exp_runner

    fresh.setenv("HMNFFB_COMPILE_CACHE", str(tmp_path / "kernels"))
    exp_runner.main(_write_setup(tmp_path) + ["--nepoch", "0"])
    assert compile_cache.cache_dir() == tmp_path / "kernels"
    assert (tmp_path / "kernels").is_dir()


def test_rank0_builds_first(tmp_path):
    """Rank 0's stub build sleeps a second before writing the library; the
    other ranks' builds begin only after it is there."""
    out = multihost.spawn(workers.stub_build_order, 3, args=(str(tmp_path), 1.0),
                          device="cpu", timeout=120)
    (r0, seen0, t0), *others = out
    assert r0 == 0 and not seen0
    for rank, seen, t in others:
        assert seen, f"rank {rank} began its build before rank 0's was in the cache"
        assert t >= t0
    assert (tmp_path / "stub.so").read_text() == "0"


def test_build_once_without_a_group_just_builds():
    assert compile_cache.build_once(lambda: 7) == 7
