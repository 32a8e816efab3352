"""Multi-process bring-up: process join, global mesh, per-rank data shards.

Counterpart of ``hashmodnffbanks_idr_tpu/parallel/multihost.py``.  Every
process runs the same program with one device: ``initialize`` joins them
into one ``torch.distributed`` process group (NCCL on the card, gloo on
the CPU), the mesh spans every rank, and each rank feeds its own rows of
the per-ray batch.  ``spawn`` starts such a group on one machine, one rank
per device, and returns what each rank's function returned.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import resolve_device
from .sharding import make_mesh

DEFAULT_TIMEOUT_S = 300.0
JOIN_TIMEOUT_S = 120.0  # a spawned rank that has not joined by then fails the group


def join(coordinator: str, num_processes: int, process_id: int, device=None,
         timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group at ``coordinator`` ('host:port' of rank 0) as
    rank ``process_id`` of ``num_processes``, and return this rank's
    device: the card ``process_id % device_count`` for ``device`` None or
    'cuda' (NCCL), else the CPU (gloo; the ranks are taken to share this
    host's cores, so each takes at most its share as torch threads).  A
    rank that does not arrive within ``timeout`` seconds fails the join
    instead of hanging it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, min(torch.get_num_threads(), _cores() // num_processes)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return dev


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join the process group, or skip the join for a single process
    (JAX :30-47).  Returns (rank, world size)."""
    if num_processes and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("a multi-process run needs --coordinator and --process_id")
        join(coordinator, num_processes, process_id, device=device, timeout=timeout)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(n_model: int = 1):
    """('data', 'model') mesh over every rank (each rank passes the same
    ``n_model``)."""
    n = dist.get_world_size()
    if n % n_model:
        raise ValueError(f"{n} ranks do not split into n_model={n_model}")
    return make_mesh(n_data=n // n_model, n_model=n_model)


def host_fold_rng(seed: int) -> torch.Generator:
    """A CPU generator seeded from ``seed`` with this rank folded in, so
    that each rank draws its own pixels for the same step."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    mixed = int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(mixed)


def host_batch_slice(global_batch: int) -> int:
    """Rows this rank supplies of a ``global_batch``-row ray batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over {n} ranks")
    return global_batch // n


def make_global_ray_array(local_rows: torch.Tensor) -> torch.Tensor:
    """The global per-ray tensor from every rank's ``local_rows`` (the same
    row count on each), in rank order: an all-gather."""
    local_rows = local_rows.contiguous()
    n = dist.get_world_size()
    out = local_rows.new_empty((n * local_rows.shape[0], *local_rows.shape[1:]))
    dist.all_gather_into_tensor(out, local_rows)
    return out


def all_hosts_psum_check(mesh) -> float:
    """Collective health check: the all-reduce of one per rank, which must
    equal the mesh size on every rank."""
    dev = mesh.device_type
    ones = torch.ones((), device=torch.cuda.current_device() if dev == "cuda" else "cpu")
    dist.all_reduce(ones)
    total = float(ones)
    if total != mesh.size():
        raise RuntimeError(f"psum check: {total} != {mesh.size()} ranks")
    return total


# ---------------------------------------------------------------------------
# one machine: a process per device
# ---------------------------------------------------------------------------

def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not on Linux
        return os.cpu_count() or 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, fn, args, results):
    try:
        dev = join(f"localhost:{port}", world, rank, device=device, timeout=JOIN_TIMEOUT_S)
        results.put((rank, True, fn(rank, world, dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), device=None,
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``nprocs`` fresh processes
    joined into one process group on this machine (rank r on card
    ``r % device_count`` for ``device`` None or 'cuda', gloo ranks for
    'cpu'), and return the ranks' results in rank order.  Raises before it
    starts a process when CUDA is asked for but absent.  ``fn`` must be
    importable (a module-level function) and return something picklable on
    the CPU.  Raises with the rank's traceback if any rank fails, and kills
    every rank if the group has not finished after ``timeout`` seconds."""
    device = resolve_device(device).type
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, port, device, fn, tuple(args), results),
                         daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks did not finish in {timeout:.0f} s "
                                   f"(finished: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(nprocs)]
