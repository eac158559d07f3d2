"""Engine host loop (`runtime/engine.py` `StreamEngine.flush_controls`):
the staged control edits applied (the span engine.flush_controls):
the median over the traced stretch's ticks of a tick's ms in that
span, on the host's clock; None without it (`portbench/spans.py`)."""

from portbench import spans

LAYER = "engine host loop"
MOVES = "tick_p95_ms"
SPANS = ("engine.flush_controls",)


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx, device=False)
