"""Conditional while-nodes: the tracer's loops inside one CUDA graph.

Counterpart of XLA's on-device ``while`` (``jax.lax.while_loop`` in
``hashmodnffbanks_idr_tpu/models/ray_tracing.py:316`` and ``:333``); it
replaces no Pallas kernel.  ``csrc/graph_loops.cu`` holds the ``set_while``
kernel, which sets a while-node's condition on the device to ``pred and
counter < max_iters`` and totals the iterations, and the host functions
that assemble captured graphs into one executable graph.  ``Assembler`` is
what ``utils/graphs.py`` builds a captured program with: a child-graph node
per captured segment, a ``set_while`` node and a while-node per loop, a
``set_while`` node closing each body; ``count_nodes`` counts a captured
graph's nodes by type (``utils/graphs.py`` folds them a step with tracing
on).

The library is built with ``nvcc`` for ``sm_90a`` into the build cache
(``utils/compile_cache.py``) on first use and loaded with ctypes.
``set_while_plain`` is the kernel's math on the host: the loop an eager
step runs reads its predicate there.  Every error of the runtime (a
toolkit or CUDA driver without conditional nodes, a node it refuses, a failed
instantiation) raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ..utils.compile_cache import build_library

_CSRC = Path(__file__).resolve().parent / "csrc" / "graph_loops.cu"

# set_while's runs on the device, folded in from the loops' device totals
# (``utils/graphs.py``): one before each while-node is entered and one at
# the end of each body
launch_counts: Dict[str, int] = {"set_while": 0}
# what ``Assembler.count_nodes`` counts a captured graph's nodes by
NODE_TYPES = ("kernel", "memset", "memcpy", "other")

_lib = None


def set_while_plain(pred: torch.Tensor, counter: torch.Tensor, max_iters: int,
                    total: torch.Tensor, add: int) -> bool:
    """The kernel's math with a host read: ``total += add``, and whether
    the loop runs a (next) body, ``pred and counter < max_iters``."""
    total.add_(add)
    return bool(pred) and int(counter) < max_iters


def load_library() -> ctypes.CDLL:
    """Build ``csrc/graph_loops.cu`` (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library(_CSRC, "graph_loops")))
    ptr, pptr, c_ll = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong
    signatures = {
        "gl_graph_create": [pptr],
        "gl_add_child": [ptr, pptr, ptr],
        "gl_add_while": [ptr, pptr, ptr, ptr, c_ll, ptr, pptr, ctypes.POINTER(ctypes.c_ulonglong)],
        "gl_end_body": [ptr, pptr, ctypes.c_ulonglong, ptr, ptr, c_ll, ptr],
        "gl_count_nodes": [ptr, ctypes.POINTER(ctypes.c_ulonglong)],
        "gl_instantiate": [pptr, ptr],
        "gl_launch": [ptr, ptr],
        "gl_destroy": [ptr, ptr],
    }
    for name, args in signatures.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return lib


def _call(name: str, *args) -> None:
    err = getattr(load_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           "(conditional graph nodes need CUDA 12.4 in toolkit and CUDA driver)")


def _check_scalar(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or t.numel() != 1:
        raise ValueError(f"{name} must be a one-element {dtype} CUDA tensor; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


class _Body:
    """A graph being filled and its last node."""

    def __init__(self, graph: ctypes.c_void_p, handle: int = 0):
        self.graph, self.handle, self.last = graph, handle, ctypes.c_void_p()


class Executable:
    """An instantiated graph; destroyed with its graph when dropped.  It
    holds what its nodes point into: the captured graphs (their memory
    pool) and the loops' tensors."""

    def __init__(self, root: _Body, keep: list):
        self.graph, self.keep = root.graph, keep
        self.exec = ctypes.c_void_p()
        _call("gl_instantiate", ctypes.byref(self.exec), self.graph)

    def launch(self) -> None:
        """One launch on the current stream."""
        _call("gl_launch", self.exec, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def __del__(self):
        if _lib is not None and self.graph:
            _lib.gl_destroy(self.exec, self.graph)
            self.graph = None


class Assembler:
    """Builds one executable graph from captured segments and loops, in the
    order they are appended (``utils/graphs.py:Program.instantiate``)."""

    def __init__(self):
        self.keep: list = []

    def graph(self) -> _Body:
        g = ctypes.c_void_p()
        _call("gl_graph_create", ctypes.byref(g))
        return _Body(g)

    def child(self, body: _Body, captured: "torch.cuda.CUDAGraph") -> None:
        """Append a captured graph (``torch.cuda.CUDAGraph(keep_graph=True)``)."""
        self.keep.append(captured)
        _call("gl_add_child", body.graph, ctypes.byref(body.last),
              ctypes.c_void_p(captured.raw_cuda_graph()))

    def while_loop(self, body: _Body, loop) -> _Body:
        """Append ``loop`` (``pred``, ``counter``, ``max_iters``, ``total``);
        returns its body to fill, then close with ``end_body``."""
        _check_scalar(loop.pred, "pred", torch.bool)
        _check_scalar(loop.counter, "counter", torch.int64)
        _check_scalar(loop.total, "total", torch.int64)
        self.keep.append(loop)
        inner, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        _call("gl_add_while", body.graph, ctypes.byref(body.last), loop.pred.data_ptr(),
              loop.counter.data_ptr(), loop.max_iters, loop.total.data_ptr(),
              ctypes.byref(inner), ctypes.byref(handle))
        return _Body(inner, handle.value)

    def end_body(self, body: _Body, loop) -> None:
        _call("gl_end_body", body.graph, ctypes.byref(body.last), body.handle,
              loop.pred.data_ptr(), loop.counter.data_ptr(), loop.max_iters,
              loop.total.data_ptr())

    def instantiate(self, root: _Body) -> Executable:
        return Executable(root, self.keep)

    @staticmethod
    def count_nodes(captured: "torch.cuda.CUDAGraph") -> Dict[str, int]:
        """The nodes of a captured graph by type (``NODE_TYPES``)."""
        counts = (ctypes.c_ulonglong * len(NODE_TYPES))()
        _call("gl_count_nodes", ctypes.c_void_p(captured.raw_cuda_graph()), counts)
        return dict(zip(NODE_TYPES, counts))
