"""``tracer_device_ms``: the ``tracer`` span (``models/renderer.py``: the
ray tracer under ``no_grad``), timed on the card's clock inside the step's
CUDA graph over the span segment's untraced steps (``harness/spans.py``),
in ms a step."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.ms("tracer")
