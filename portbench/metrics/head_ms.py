"""Kernels, the vocoder's head (`models/waveform_generator.py` `apply`):
the source features and the upsampler head, the fused kernel at T = 1
(`csrc/fused_upsampler*.cu`), the stage loop at T > 1 (head):
the median over the traced stretch's ticks of a tick's ms in
those spans, on the card's clock (event-record nodes of the tick graph);
None without them (`portbench/spans.py`)."""

from portbench import spans

LAYER = "kernels"
MOVES = "audio_s_per_s"
SPANS = ("head",)


def read(record, ctx):
    return spans.median_ms(record, SPANS, ctx)
