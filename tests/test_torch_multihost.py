"""The port's multi-process bring-up on the CPU, the counterpart of
tests/test_multihost.py: local gloo processes join one process group over
a localhost coordinator and run ``parallel/bringup.py`` (the cross-rank
all-reduce, the data-sharded train-shaped step, and with ``--n-model`` the
table-sharded step against its dense oracle); and the training CLI's
multi-host flags join two processes.

Each process has its own 240 s timeout and one torch thread
(``OMP_NUM_THREADS=1``: the test workers share the cores); a lost race for
the free port is retried once on another, as tests/test_multihost.py does.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import torch_dist_workers as workers
from hashmodnffbanks_idr_tpu_torch.parallel import multihost
from hashmodnffbanks_idr_tpu_torch.parallel.multihost import free_port

from test_torch_runner import _write_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
PORT_RACE = ("address already in use", "Address already in use", "EADDRINUSE")


def _run(cmd_of_rank, n_procs):
    procs = [subprocess.Popen(cmd_of_rank(i), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=ROOT, env=ENV)
             for i in range(n_procs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


def _run_retrying(make_cmd, n_procs):
    procs, outs = _run(make_cmd(free_port()), n_procs)
    if any(p.returncode != 0 for p in procs) and any(s in o for o in outs for s in PORT_RACE):
        procs, outs = _run(make_cmd(free_port()), n_procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outs


def _bringup(n_procs, n_model=1):
    def make_cmd(port):
        return lambda i: [sys.executable, "-m", "hashmodnffbanks_idr_tpu_torch.parallel.bringup",
                          "--coordinator", f"localhost:{port}", "--num-processes", str(n_procs),
                          "--process-id", str(i), "--n-model", str(n_model),
                          "--platform", "cpu", "--timeout", "120"]
    return _run_retrying(make_cmd, n_procs)


def _values(outs, key):
    return {line.split(f"{key}=")[1].split()[0]
            for out in outs for line in out.splitlines()
            if line.startswith("BRINGUP_OK") and f"{key}=" in line}


def test_two_process_bringup():
    outs = _bringup(2)
    for out in outs:
        assert "BRINGUP_OK procs=2 devices=2 psum=2" in out, out
        assert "threads=1" in out, out
    # one global loss on both ranks => the shards really joined
    assert len(_values(outs, "loss")) == 1


def test_four_process_model_axis_spans_processes():
    """Four ranks, the 'model' axis across all of them: the table step's row
    gather and reduce-scattered gradient cross every rank, and the gradient
    equals the dense oracle (checked in every process)."""
    outs = _bringup(4, n_model=4)
    for out in outs:
        assert "BRINGUP_OK procs=4 devices=4 psum=4" in out, out
        assert "span=4" in out, out
    assert len(_values(outs, "tableshard_loss")) == 1
    assert len(_values(outs, "loss")) == 1


def test_cli_multihost_flags_join_two_processes(tmp_path):
    """``exp_runner --coordinator --num_processes 2 --process_id i`` joins
    both processes; as the JAX CLI does, it builds no mesh, and rank 0 alone
    writes the run directory."""
    args = _write_setup(tmp_path)

    def make_cmd(port):
        return lambda i: [sys.executable, "-m", "hashmodnffbanks_idr_tpu_torch.train.exp_runner",
                          *args, "--nepoch", "0", "--coordinator", f"localhost:{port}",
                          "--num_processes", "2", "--process_id", str(i)]
    outs = _run_retrying(make_cmd, 2)
    assert "training " in outs[0] and "training " not in outs[1]
    exps = tmp_path / "exps"
    (expdir,) = list(exps.iterdir())
    (rundir,) = list(expdir.iterdir())
    assert sorted(os.listdir(rundir / "checkpoints")) == ["0.pt", "latest.pt"]
    with open(rundir / "logs" / "scalars.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0]


def test_spawn_defaults_to_the_card():
    """``spawn`` with no device asks for the card, as every entry point
    does: one rank on the card where there is one, else a raise before any
    process starts."""
    if torch.cuda.is_available():
        assert multihost.spawn(workers.device_type, 1) == ["cuda"]
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.spawn(workers.device_type, 1)
