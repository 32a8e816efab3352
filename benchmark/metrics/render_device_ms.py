"""``render_device_ms``: the ``render`` span (``models/renderer.py``: the
differentiable forward after the tracer; ``train/trainer.py:loss_fn``: the
loss terms), on the card's clock over the span segment's untraced steps
(``harness/spans.py``), in ms a step."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.ms("render")
