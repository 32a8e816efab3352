"""``backward_device_ms``: the ``backward`` span (``loss.backward()`` in
``train/trainer.py``), on the card's clock over the span segment's untraced
steps (``harness/spans.py``), in ms a step."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.ms("backward")
