"""Chain, the whole tick (`models/chain.py` and the edge ops): the model's
FLOPs per tick (`portbench/flops.py`) over the window's mean tick span on
the card's clock (CUDA events, tracing off) and the published dense peak
of the configuration's compute dtype (989 TFLOP/s bf16, 67 TFLOP/s f32),
in percent.  The profiled stretch's span is not used: under the profiler
the host's launch of the tick's graph takes milliseconds while the card
waits."""

from portbench import yardstick

LAYER = "chain"
MOVES = "audio_s_per_s"


def read(record, ctx):
    if not record.get("trace"):
        return None
    tick_s = sum(record["latency_ms"]) * 1e-3 / len(record["latency_ms"])
    return 100.0 * record["flops_per_tick"] / tick_s / yardstick.PEAK_FLOPS[
        ctx.config["compute_dtype"]]
