"""Engine host loop (`runtime/engine.py` `StreamEngine.tick`,
`flush_controls`): the median over the window's ticks of the host's time
for `tick` to return, on the benchmark's own clock."""

import numpy as np

LAYER = "engine host loop"
MOVES = "tick_p95_ms"


def read(record, ctx):
    return float(np.median(record["host_ms"]))
