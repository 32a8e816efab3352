"""The port's entry points (``graft_entry.py``, the counterpart of
``__graft_entry__.py``) on the CPU: the 256-ray flagship eval forward, and
the sharded dry run's four configurations in four gloo ranks on the 2x2
mesh its rule picks, and in one rank (the 1x1 mesh a one-card machine
gets).
"""

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch import graft_entry


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_entry_forward():
    fn, args = graft_entry.entry(device="cpu")
    rgb, mask, dists = fn(*args)
    assert rgb.shape == (256, 3) and mask.shape == (256,) and dists.shape == (256,)
    assert mask.dtype == torch.bool and 0 < int(mask.sum()) < 256
    assert torch.isfinite(rgb).all() and torch.isfinite(dists).all()
    again = fn(*graft_entry.entry(device="cpu")[1])
    for a, b in zip((rgb, mask, dists), again):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def dryrun_2x2():
    return graft_entry.dryrun_multichip(4, device="cpu", timeout=300)


def test_dryrun_2x2_finishes_alike_on_every_rank(dryrun_2x2):
    assert len(dryrun_2x2) == 4
    labels = [r["label"] for r in dryrun_2x2[0]]
    assert labels == list(graft_entry.DRYRUN_LABELS)
    for recs in dryrun_2x2:
        for rec, first in zip(recs, dryrun_2x2[0]):
            assert rec["mesh"] == [2, 2]
            assert np.isfinite(rec["loss"])
            assert rec["loss"] == first["loss"], rec["label"]   # the summed loss


@pytest.mark.parametrize("label,want", [
    ("toy", {"implicit_network.embedder.grid.table": [[192, 2], [96, 2]],
             "rendering_network.view_embedder.grid.table": [[64, 2], [32, 2]]}),
    ("toy-trained-cams", {"implicit_network.embedder.grid.table": [[192, 2], [96, 2]],
                          "rendering_network.view_embedder.grid.table": [[64, 2], [32, 2]]}),
    ("flagship-full", {}),
    ("ngp15-full", {"implicit_network.embedder.table": [[168768, 2], [84384, 2]]}),
])
def test_dryrun_2x2_shards_the_tables_the_rule_picks(dryrun_2x2, label, want):
    """Toy tables sharded at 8 rows, the flagship's replicated at 1024, the
    ngp log2=15 SDF table (168,768 rows) sharded at 1024: half on each
    'model' rank."""
    for recs in dryrun_2x2:
        (rec,) = [r for r in recs if r["label"] == label]
        assert rec["sharded_tables"] == want
        assert rec["n_rays"] == (64 if label.startswith("toy") else 16)


def test_dryrun_one_rank_is_a_1x1_mesh():
    (recs,) = graft_entry.dryrun_multichip(1, device="cpu", labels=("toy", "ngp15-full"),
                                           timeout=300)
    assert [r["mesh"] for r in recs] == [[1, 1], [1, 1]]
    assert recs[1]["sharded_tables"] == {"implicit_network.embedder.table": [[168768, 2]] * 2}
    assert all(np.isfinite(r["loss"]) for r in recs)
