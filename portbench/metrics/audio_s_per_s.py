"""End to end: audio seconds converted per wall second over the window,
ticks completed x capacity x T x 10 ms over the window's seconds on the
host's clock (from the first tick's enqueue to the last output on the
host).  At a capacity that holds real time, the streams the card carries."""

MOVES = None


def read(record, ctx):
    audio_s = record["ticks"] * record["capacity"] * record["frames_per_tick"] * 0.01
    return audio_s / record["wall_s"]
