"""Chain, the vocoder's cross-attention into the speaker's K/V
(`models/waveform_generator.py` `_attention`, every block: wg_attn):
the median over the traced stretch's ticks of a tick's ms in
those spans, on the card's clock (event-record nodes of the tick graph);
None without them (`portbench/spans.py`)."""

from portbench import spans

LAYER = "chain"
MOVES = "audio_s_per_s"
SPANS = ("wg_attn",)


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx)
