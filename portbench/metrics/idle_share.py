"""Device: the share of a tick in which no kernel runs, in percent: one
minus the kernels' busy time per tick in the profiled stretch (the union
of their intervals; copies count as idle, no kernel runs beside them)
over the window's mean tick span on the card's clock (tracing off: under
the profiler the graph's launch keeps the card waiting for milliseconds)."""

LAYER = "device"
MOVES = "tick_p95_ms"


def read(record, ctx):
    tr = record.get("trace")
    if not tr or not tr["kernels"]:
        return None
    tick_s = sum(record["latency_ms"]) * 1e-3 / len(record["latency_ms"])
    return 100.0 * (1.0 - tr["kernel_busy_s"] / tr["ticks"] / tick_s)
