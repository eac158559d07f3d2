"""Chain, the tick's edges (`runtime/engine.py` `engine_tick`,
`donated_tick`): sanitize, input gain and the 48->16 kHz resample
(edge_in), `_build_cond` (cond), the 24->48 kHz resample, output gain,
active mask and `write_back_` (edge_out):
the median over the traced stretch's ticks of a tick's ms in
those spans, on the card's clock (event-record nodes of the tick graph);
None without them (`portbench/spans.py`)."""

from portbench import spans

LAYER = "chain"
MOVES = "audio_s_per_s"
SPANS = ("edge_in", "cond", "edge_out")


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx)
