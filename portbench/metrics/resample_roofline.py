"""Kernels, the tick's edge resamplers (`csrc/polyphase_resample.cu`
through `ops/resample.py`: 48->16 kHz at the input, 24->48 kHz at the
output, a launch each a tick): their bound over the kernel's mean device
time a launch in the profiled stretch, in percent.  The bound is the
bytes they must move, each sample read or written once in f32 (the 48 kHz
block in, the 16 kHz block out, the 24 kHz block in, the 48 kHz block
out, both histories read and written, both filter tables), at the H100
SXM's 3.35 TB/s (`portbench/yardstick.py`), shared evenly over a tick's
launches.  None where no kernel of that name ran (the dense product the
port used before it has no name of its own)."""

from portbench import yardstick
from portbench.reference.filters import design_polyphase

LAYER = "kernels"
MOVES = "audio_s_per_s"
KERNEL = "polyphase_resample"  # in the kernel's name; not "fused_upsampler"
EDGE_HOP, IN_HOP, OUT_HOP = 480, 160, 240  # a frame at 48, 16 and 24 kHz
# the two resamplers as (L, M, samples in a frame, samples out a frame)
EDGES = ((1, 3, EDGE_HOP, IN_HOP), (2, 1, OUT_HOP, EDGE_HOP))
LAUNCHES_PER_TICK = len(EDGES)


def bytes_per_tick(capacity: int, frames: int) -> int:
    """Bytes the two resamplers must move in a tick of `frames` frames for
    `capacity` streams."""
    total = 0
    for L, M, n_in, n_out in EDGES:
        K = design_polyphase(L, M, 16, 0.99)[1]
        total += 4 * (capacity * (frames * (n_in + n_out) + 2 * (K - 1)) + L * K)
    return total


def bound_ms_per_tick(capacity: int, frames: int) -> float:
    return bytes_per_tick(capacity, frames) / yardstick.PEAK_BYTES_PER_S * 1e3


def read(record, ctx):
    tr = record.get("trace")
    if not tr:
        return None
    runs = [(total, count) for name, (total, count) in tr["by_name"].items() if KERNEL in name]
    if not runs:
        return None
    per_launch_ms = 1e3 * sum(t for t, _ in runs) / sum(c for _, c in runs)
    bound = bound_ms_per_tick(record["capacity"], record["frames_per_tick"]) / LAUNCHES_PER_TICK
    return 100.0 * bound / per_launch_ms
