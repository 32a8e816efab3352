"""``encoder_fwd_device_ms``: the encoders' forward, the ``encoder.points``
and ``encoder.views`` spans (``models/networks.py``) wherever they run,
tracer included, on the card's clock over the span segment's untraced steps
(``harness/spans.py``), in ms a step.  Their backward is in
``backward_device_ms``."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.ms("encoder.points") + r.ms("encoder.views")
