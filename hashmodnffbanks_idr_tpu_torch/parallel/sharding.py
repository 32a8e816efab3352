"""Device-mesh sharding for ray-parallel + table-parallel training.

Counterpart of ``hashmodnffbanks_idr_tpu/parallel/sharding.py``.  The mesh
is a ``torch.distributed`` ``DeviceMesh`` with the JAX package's axes,
one rank per device:

  * 'data'  -- ray sharding: each rank renders a contiguous slice of the
    step's global ray batch, and the gradients of the replicated
    parameters are summed over the ranks;
  * 'model' -- hash-table sharding: a large ``table`` parameter's rows are
    split over 'model'.  Each rank stores its rows and their Adam moments,
    gathers the full table for the forward, and receives its rows' gradient
    by a reduce-scatter (``ShardedTables``).

XLA's ``P('data')`` replicates a ray batch over 'model', so a JAX 'model'
group renders the same rays on each of its devices.  Here the ray batch is
split over every rank of the mesh ('data'-major), so no rank repeats
another's work; the gradients are the same sums.  The hand-written
collectives live in ``train/trainer.py:build_train_step(mesh=...)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

ROWS = ("model", None)   # JAX's P('model', None): rows split over 'model'
REPLICATED = ()          # JAX's P()

# the non-deprecated names where this torch has them
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A ('data', 'model') mesh over every rank of the default process
    group, rank ``d * n_model + m`` at coordinate (d, m), on the card under
    NCCL and on the CPU otherwise."""
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's index in the flattened mesh, 'data'-major."""
    d, m = mesh.get_coordinate()
    return d * axis_size(mesh, "model") + m


def param_sharding(model: nn.Module, mesh: DeviceMesh,
                   min_table_rows: int = 1024) -> Dict[str, Tuple]:
    """Each parameter's placement (JAX :46-60): a 2-D parameter named
    ``table`` with at least ``max(min_table_rows, n_model)`` rows, a
    multiple of n_model, is ``ROWS``; every other parameter ``REPLICATED``.
    The port's tables are ``(rows, C)``, so the rule reads their rows (the
    JAX package's are page images, padded to 8-page multiples)."""
    n_model = axis_size(mesh, "model")

    def spec(name, p):
        if (name.rsplit(".", 1)[-1] == "table" and p.dim() == 2
                and p.shape[0] >= max(min_table_rows, n_model)
                and p.shape[0] % n_model == 0):
            return ROWS
        return REPLICATED

    return {name: spec(name, p) for name, p in model.named_parameters()}


def ray_sharding(mesh: DeviceMesh, n_rays: int) -> slice:
    """This rank's contiguous slice of a global per-ray batch of ``n_rays``."""
    size = mesh.size()
    if n_rays % size:
        raise ValueError(f"{n_rays} rays do not split over {size} ranks")
    k = n_rays // size
    r = mesh_rank(mesh)
    return slice(r * k, (r + 1) * k)


def constrain_rays(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a global per-ray tensor (leading axis = rays).
    (A replicated tensor is the whole tensor on every rank.)"""
    return x[ray_sharding(mesh, x.shape[0])]


class ShardedTables:
    """The row-sharded tables of ``model``: for each, this rank's rows as a
    leaf ``nn.Parameter`` (what the optimizer steps) beside the module's
    full table, which ``gather`` refills from every rank's rows after an
    update.  ``reduce_grads`` turns each rank's full-table gradient into
    its rows' gradient summed over all ranks."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh, names):
        params = dict(model.named_parameters())
        self.mesh = mesh
        self.n_model = axis_size(mesh, "model")
        self.n_data = axis_size(mesh, "data")
        self.model_group = mesh.get_group("model")
        self.data_group = mesh.get_group("data")
        m = mesh.get_local_rank("model")
        self.full: Dict[str, nn.Parameter] = {n: params[n] for n in names}
        self.rows: Dict[str, slice] = {}
        self.shards: Dict[str, nn.Parameter] = {}
        for n, p in self.full.items():
            k = p.shape[0] // self.n_model
            self.rows[n] = slice(m * k, (m + 1) * k)
            self.shards[n] = nn.Parameter(p.detach()[self.rows[n]].clone())

    def __len__(self):
        return len(self.full)

    @torch.no_grad()
    def gather(self) -> None:
        for n, p in self.full.items():
            _all_gather(p.data, self.shards[n].data, group=self.model_group)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        for n, p in self.full.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            shard_grad = torch.empty_like(self.shards[n])
            _reduce_scatter(shard_grad, g.contiguous(), group=self.model_group)
            if self.n_data > 1:
                dist.all_reduce(shard_grad, group=self.data_group)
            self.shards[n].grad = shard_grad

    @torch.no_grad()
    def gather_rows(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """A full-table tensor from every 'model' rank's ``rows`` of table
        ``name`` (an Adam moment, for a checkpoint)."""
        out = rows.new_empty(self.full[name].shape)
        _all_gather(out, rows.contiguous(), group=self.model_group)
        return out
