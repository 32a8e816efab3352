"""``update_device_ms``: the ``update`` span (``train/trainer.py``: the
clip, the saved state, Adam and the masked restore), on the card's clock
over the span segment's untraced steps (``harness/spans.py``), in ms a
step."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.ms("update")
