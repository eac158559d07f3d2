"""End to end: seconds from the harness's start to the window's: imports,
loading and checking the weights, building the engine (the graph's
warm-up and capture, and in a checkout's first run the kernels' nvcc
builds), admitting every stream with its controls, making the input loop,
the warm-up ticks."""

MOVES = None


def read(record, ctx):
    return record["setup_s"]
