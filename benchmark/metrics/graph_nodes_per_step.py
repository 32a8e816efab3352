"""``graph_nodes_per_step``: the kernel, memset and memcpy nodes the step's
graph ran (``utils/graphs.py`` ``node_counts``: each captured segment's
nodes by type, the span stamps left out, and the ``set_while`` nodes,
folded with the loops' device totals) over the span segment's untraced
steps (``harness/spans.py``), a step."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None or not r.nodes else r.nodes / r.steps
