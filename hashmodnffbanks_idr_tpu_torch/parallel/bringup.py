"""Multi-process bring-up check: join the process group, build the global
mesh, run a cross-rank all-reduce and one sharded train-shaped step.

Counterpart of ``scripts/multihost_bringup.py``.  Run the same command in
every process, ``--process-id`` differing; e.g. two local CPU processes:

    python -m hashmodnffbanks_idr_tpu_torch.parallel.bringup --platform cpu \\
        --coordinator localhost:12345 --num-processes 2 --process-id 0 &
    ... --process-id 1

On the card drop ``--platform cpu`` (NCCL, one card per process).  On
success every process prints one line:

    BRINGUP_OK procs=<n> devices=<n> psum=<n> loss=<float>[ tableshard_loss=<float> span=<m>] threads=<t>

The train-shaped step is a linear model and a per-ray squared error whose
64-ray batch is split over the ranks, each rank drawing its own rows
(``host_fold_rng``); the loss and the gradient are summed over the ranks,
and the loss must equal the dense loss of the gathered batch.  With
``--n-model > 1`` a second step row-shards a (64, 4) table over a 'model'
axis that spans the ranks (``parallel.sharding.ShardedTables``, the
trainer's own machinery): the row gather and the reduce-scattered
gradient cross ranks, and the gradient must equal the dense numpy oracle
(rtol 1e-4 / atol 1e-6).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import multihost
from .sharding import ROWS, ShardedTables, param_sharding, ray_sharding


class _Table(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table)


def data_step(dev: torch.device, global_rays: int = 64) -> float:
    """The data-sharded step; returns the loss summed over the ranks."""
    local = multihost.host_batch_slice(global_rays)
    gen = multihost.host_fold_rng(0)
    x_local = torch.randn((local, 3), generator=gen).to(dev)
    y_local = (x_local ** 2).sum(-1, keepdim=True)
    w = torch.zeros((3, 1), device=dev, requires_grad=True)
    loss = ((x_local @ w - y_local) ** 2).sum() / global_rays   # this rank's share
    loss.backward()
    dist.all_reduce(w.grad)
    loss = loss.detach()
    dist.all_reduce(loss)
    x = multihost.make_global_ray_array(x_local)
    y = multihost.make_global_ray_array(y_local)
    dense = float(((x @ w.detach() - y) ** 2).mean())
    if not np.isclose(float(loss), dense, rtol=1e-5):
        raise AssertionError(f"sharded loss {float(loss)} != dense {dense}")
    if not (np.isfinite(float(loss)) and float(w.grad.norm()) > 0):
        raise AssertionError("data step: non-finite loss or zero gradient")
    return float(loss)


def table_step(dev: torch.device, n_model: int, rows: int = 64, C: int = 4,
               n_rays: int = 32) -> float:
    """The table-sharded step on a (world / n_model) x n_model mesh; returns
    its loss.  The table, indices and targets are the same on every rank."""
    if n_model < 2:
        raise ValueError("the 'model' axis must span more than one rank")
    mesh = multihost.global_mesh(n_model=n_model)
    gen = torch.Generator().manual_seed(3)
    tab = torch.randn((rows, C), generator=gen)
    idx = torch.randint(0, rows, (n_rays,), generator=torch.Generator().manual_seed(4))
    y = torch.randn((n_rays, 1), generator=torch.Generator().manual_seed(5))
    model = _Table(tab.clone()).to(dev)
    names = [n for n, s in param_sharding(model, mesh, min_table_rows=8).items() if s == ROWS]
    if names != ["table"]:
        raise AssertionError(f"the table is not row-sharded: {names}")
    tables = ShardedTables(model, mesh, names)
    with torch.no_grad():   # the forward's table comes from every rank's rows
        model.table.zero_()
    tables.gather()
    sl = ray_sharding(mesh, n_rays)
    idx_l, y_l = idx[sl].to(dev), y[sl].to(dev)
    emb = model.table[idx_l]
    loss = ((emb.sum(-1, keepdim=True) - y_l) ** 2).sum() / n_rays
    loss.backward()
    tables.reduce_grads()
    grad = tables.gather_rows("table", tables.shards["table"].grad).cpu().numpy()
    loss = loss.detach()
    dist.all_reduce(loss)
    # the dense oracle (scripts/multihost_bringup.py:166-174)
    t, i, yy = tab.numpy(), idx.numpy(), y.numpy()
    want = np.zeros((rows, C), np.float32)
    r = (t[i].sum(-1, keepdims=True) - yy) * (2.0 / n_rays)
    np.add.at(want, i, np.repeat(r, C, axis=1))
    if not np.allclose(grad, want, rtol=1e-4, atol=1e-6):
        raise AssertionError(f"sharded table gradient differs from the oracle by "
                             f"{np.abs(grad - want).max()}")
    if not np.isfinite(float(loss)):
        raise AssertionError("table step: non-finite loss")
    return float(loss)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--n-model", type=int, default=1)
    p.add_argument("--platform", default=None, help="'cpu' for gloo ranks (default: the card)")
    p.add_argument("--timeout", type=float, default=multihost.DEFAULT_TIMEOUT_S,
                   help="seconds the join waits for every process")
    args = p.parse_args(argv)

    # a single process needs no coordinator: a group of one at a local port
    coordinator = args.coordinator or f"localhost:{multihost.free_port()}"
    dev = multihost.join(coordinator, args.num_processes, args.process_id,
                         device=args.platform, timeout=args.timeout)
    try:
        n = dist.get_world_size()
        mesh = multihost.global_mesh(n_model=1)
        psum = multihost.all_hosts_psum_check(mesh)
        loss = data_step(dev)
        table_line = ""
        if args.n_model > 1:
            tloss = table_step(dev, args.n_model)
            table_line = f" tableshard_loss={tloss:.6f} span={args.n_model}"
        print(f"BRINGUP_OK procs={n} devices={mesh.size()} psum={psum:.0f} "
              f"loss={loss:.6f}{table_line} threads={torch.get_num_threads()}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
