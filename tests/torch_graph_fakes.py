"""CUDA graph capture and assembly stood in for on the CPU, with the
device's semantics, for the tests of ``utils/graphs.py``.

* ``FakeGraph`` and ``fake_capture`` stand in for ``torch.cuda.CUDAGraph``
  and ``torch.cuda.graph``: the capture records every ATen operation of
  its block (the block still runs once, as the capture's own run), and a
  replay runs them again in order, writing each result into the tensor
  the capture's run produced: a replay of a CUDA graph writes the same
  addresses.  A host read inside a capture raises, as it does on the card.
* ``FakeAssembler`` stands in for ``ops.graph_loops.Assembler``: it
  executes the program's tree as the card runs the assembled graph, a
  segment by replaying its graph, a loop as a while-node whose condition
  ``set_while_plain`` sets before the node and at the end of each body,
  so the predicate is evaluated only after a body (or before the first).
  ``log`` records what ran, in order; ``count_nodes`` counts a fake
  graph's recorded operations as its nodes.
"""

from __future__ import annotations

import contextlib
import itertools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from hashmodnffbanks_idr_tpu_torch.ops import graph_loops as gl
from hashmodnffbanks_idr_tpu_torch.utils import graphs

_HOST_READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.is_nonzero.default}


class _Recording(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            raise RuntimeError("a host read inside the capture (operation not permitted when "
                               "stream is capturing)")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``; ``index`` is its capture's
    place in order."""

    _count = itertools.count()

    def __init__(self, keep_graph=False):
        self.index = next(FakeGraph._count)
        self.ops = []
        self.replays = 0

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                # an in-place op or a view wrote (or aliases) the captured
                # output already; any other result goes to its address
                if isinstance(o, torch.Tensor) and (
                        o.untyped_storage().data_ptr() != n.untyped_storage().data_ptr()):
                    o.copy_(n)


@contextlib.contextmanager
def fake_capture(graph, pool=None, stream=None):
    rec = _Recording()
    with rec:
        yield
    graph.ops = rec.ops


def install(monkeypatch) -> None:
    """Capture with the fakes (``graphs.capture_program`` then records)."""
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", fake_capture)


class _Body:
    def __init__(self):
        self.nodes = []
        self.go = False


class _Executable:
    def __init__(self, root: _Body):
        self.root = root

    def launch(self):
        for node in self.root.nodes:
            node()


class FakeAssembler:
    """Runs the assembled graph's nodes as the card would (see the module
    docstring); ``log`` holds ("segment", graph index), ("enter", loop),
    ("iteration", loop) and ("exit", loop) in the order they ran."""

    def __init__(self):
        self.log = []

    def graph(self) -> _Body:
        return _Body()

    def child(self, body: _Body, graph: FakeGraph) -> None:
        def node():
            self.log.append(("segment", graph.index))
            graph.replay()
        body.nodes.append(node)

    def while_loop(self, body: _Body, loop) -> _Body:
        inner = _Body()

        def node():
            self.log.append(("enter", loop.name))
            inner.go = gl.set_while_plain(loop.pred, loop.counter, loop.max_iters, loop.total, 0)
            while inner.go:
                self.log.append(("iteration", loop.name))
                for n in inner.nodes:
                    n()
            self.log.append(("exit", loop.name))
        body.nodes.append(node)
        return inner

    def end_body(self, inner: _Body, loop) -> None:
        def node():
            inner.go = gl.set_while_plain(loop.pred, loop.counter, loop.max_iters, loop.total, 1)
        inner.nodes.append(node)

    def instantiate(self, root: _Body) -> _Executable:
        return _Executable(root)

    @staticmethod
    def count_nodes(graph: FakeGraph) -> dict:
        """A captured graph's recorded operations as its nodes: fills as
        memsets, copies as memcpys, every other operation a kernel."""
        kinds = {torch.ops.aten.fill_.Scalar: "memset", torch.ops.aten.zero_.default: "memset",
                 torch.ops.aten.copy_.default: "memcpy"}
        out = dict.fromkeys(gl.NODE_TYPES, 0)
        for func, *_ in graph.ops:
            out[kinds.get(func, "kernel")] += 1
        return out
