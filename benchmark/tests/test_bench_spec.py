"""The benchmark's cells resolve by name to files of their own, and a cell
added as new files and entries is found without an edit to any file that
is there."""

import hashlib
import json
import shutil

import pytest

from bench_helpers import BENCH, ROOT
from harness import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_to_its_files(workload):
    cell = spec.resolve(ROOT, workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["rays_per_step"] > 0 and cell.traffic["n_views"] > 0
    assert cell.limits and set(cell.limits) <= {
        "loss1_gap", "loss_gap", "rgb_gap", "eikonal_gap", "mask_gap", "grad_gap", "change_gap",
        "rgb_ray_gap", "sdf_ray_gap"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "train_rays_per_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(ROOT, m["name"]))
    # the traffic's model settings are laid over the configuration's conf
    for key, value in cell.traffic.get("model", {}).items():
        assert cell.conf["model"][key] == value


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_configuration_is_its_frozen_conf(config):
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file

    obj = json.loads((ROOT / config["file"]).read_text())
    assert obj["conf"] == parse_file(str(ROOT / obj["conf_file"])).data
    assert obj["reduced"] == config["reduced"]
    assert obj["source"] == config["source"]


def test_cell_added_as_new_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    digests = {p: hashlib.sha256(p.read_bytes()).hexdigest()
               for p in (root / "benchmark").rglob("*") if p.is_file()}

    # a new mix, a new cell's limits, a new metric: files of their own
    (root / "benchmark/traffic/dtu49.rays4096.json").write_text(json.dumps(
        {"scene_id": 0, "n_views": 49, "img_res": [1200, 1600], "rays_per_step": 4096,
         "model": {"tracer_fast": "mixed"}}))
    (root / "benchmark/limits/nffb.dtu49.rays4096.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}}))
    (root / "benchmark/metrics/steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.window.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "nffb.dtu49.rays4096", "config": "idr-stylemodnffb",
                               "traffic": "dtu49.rays4096", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_rays_per_s",
                               "workloads": ["nffb.dtu49.rays4096"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.resolve(root, "nffb.dtu49.rays4096")
    assert cell.traffic["rays_per_step"] == 4096
    assert cell.limits["loss_gap"] == 1.0
    assert "steps_seen" in [m["name"] for m in cell.per_layer]
    ctx = type("C", (), {"window": type("W", (), {"steps": 7})})
    assert spec.metric_reader(root, "steps_seen")(ctx) == 7.0
    # the old cells do not take the new cell's metric
    assert "steps_seen" not in [m["name"] for m in spec.resolve(root, WORKLOADS[0]).per_layer]
    for p, digest in digests.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == digest, p


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve(ROOT, "no.such.cell")


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.-]{1,16}$"


def test_benchmark_json_keeps_its_shape():
    import re

    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all((ROOT / p).is_dir() for p in b["paths"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(NAME, c["name"]) and len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        assert all(re.match(NAME, k) for k in c["reduced"])
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.match(NAME, w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(WORKLOADS) if "workloads" in m else True
