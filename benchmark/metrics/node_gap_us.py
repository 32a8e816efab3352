"""``node_gap_us``: the device's idle time inside the ``step`` spans over
the device operations run in them (kernels, fills and copies; the span
stamps left out), in the span segment's profiled steps, whose trace is
aligned with the card's span stamps (``harness/spans.py``), in us a
node."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.node_gap_us()
