"""Tick graph (`runtime/graphs.py`, the replay of `engine_tick`): device
kernels per tick in the profiled stretch (copies and memsets not counted)."""

LAYER = "tick graph"
MOVES = "audio_s_per_s"


def read(record, ctx):
    tr = record.get("trace")
    if not tr or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["ticks"]
