"""Chain, the vocoder's body (`models/waveform_generator.py` `apply`):
the K/V projection where done there, the pitch embedding and the
in-projections (wg_in), every block's `conv_block` (wg_conv) and
`out_ln` (wg_out); its attention is `attention_ms`:
the median over the traced stretch's ticks of a tick's ms in
those spans, on the card's clock (event-record nodes of the tick graph);
None without them (`portbench/spans.py`)."""

from portbench import spans

LAYER = "chain"
MOVES = "audio_s_per_s"
SPANS = ("wg_in", "wg_conv", "wg_out")


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx)
