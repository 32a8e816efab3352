"""``launch_gap_ms``: how long the card waits between one step's graph
work and the next's (the stamp at a ``step`` span's entry, less the last
``step`` exit: ``ops/csrc/spans.cu``), the mean over the span segment's
untraced steps (``harness/spans.py``), in ms a step."""

from harness import spans


def read(ctx):
    r = spans.reading(ctx)
    return None if r is None else r.launch_gap_ms()
