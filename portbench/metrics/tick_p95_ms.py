"""End to end: the 95th percentile over every tick of the window of the
time from the tick's input copy being enqueued to its output being on the
host, on the card's clock (CUDA events around the copy in, the tick and
the copy out).  A tick must deliver its T x 10 ms within T x 10 ms."""

import numpy as np

MOVES = None


def read(record, ctx):
    return float(np.percentile(record["latency_ms"], 95))
