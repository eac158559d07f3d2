"""Chain, the pitch path (`models/chain.py` `apply`):
`pitch_estimator.apply` and `transform_pitch` (pitch):
the median over the traced stretch's ticks of a tick's ms in
those spans, on the card's clock (event-record nodes of the tick graph);
None without them (`portbench/spans.py`)."""

from portbench import spans

LAYER = "chain"
MOVES = "audio_s_per_s"
SPANS = ("pitch",)


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx)
