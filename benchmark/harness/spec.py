"""Cells resolved by name from ``BENCHMARK.json``: each cell's configuration
file, traffic mix, correctness limits and per-layer metric readers are
files of their own, found by the names the benchmark gives them:

  configs[].file                       the configuration (``file`` key)
  benchmark/traffic/<traffic>.json     the traffic mix
  benchmark/limits/<workload>.json     the limits of the comparison
  benchmark/metrics/<metric>.py        a per-layer metric's reader

so that a cell, a configuration, a mix or a metric is added as new files
and entries, without an edit to a file that is there."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict                 # the configuration file's object
    traffic_name: str
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def conf(self) -> Dict:
        """The conf as it is run: the configuration's conf with the traffic
        mix's model settings (the tracer) laid over it."""
        conf = json.loads(json.dumps(self.config["conf"]))
        for key, value in self.traffic.get("model", {}).items():
            conf["model"][key] = value
        return conf


def load_benchmark(root: Path) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(root: Path, workload: str, bench: Optional[Dict] = None) -> Cell:
    """The cell named ``workload``, with every file it names read."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = root / BENCH_DIR / "limits" / f"{workload}.json"
    limits = {}
    if limits_path.exists():
        with open(limits_path) as f:
            limits = json.load(f)["limits"]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(root: Path, name: str) -> Callable:
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = root / BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
