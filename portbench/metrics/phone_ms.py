"""Chain, the phone path (`models/chain.py` `apply`):
`phone_extractor.apply` (phone) and the VQ k-NN smoothing `_smooth_phone`
(vq):
the median over the traced stretch's ticks of a tick's ms in
those spans, on the card's clock (event-record nodes of the tick graph);
None without them (`portbench/spans.py`)."""

from portbench import spans

LAYER = "chain"
MOVES = "audio_s_per_s"
SPANS = ("phone", "vq")


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx)
