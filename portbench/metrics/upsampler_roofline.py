"""Kernels (`csrc/fused_upsampler.cu`, `csrc/fused_upsampler_bf16.cu`
through `models/fused_upsampler.py`): the frozen bound for the cell's
batch and dtype (`portbench/yardstick.py` `bound_ms`) over the kernel's
mean device time per launch in the profiled stretch, in percent.  The
kernel runs only at one frame a tick."""

from portbench import yardstick

LAYER = "kernels"
MOVES = "audio_s_per_s"
KERNEL = "fused_upsampler"  # in the name of both forms' kernels


def read(record, ctx):
    tr = record.get("trace")
    if not tr:
        return None
    runs = [(total, count) for name, (total, count) in tr["by_name"].items() if KERNEL in name]
    if not runs:
        return None
    per_launch_ms = 1e3 * sum(t for t, _ in runs) / sum(c for _, c in runs)
    bound = yardstick.bound_ms(record["capacity"], ctx.config["compute_dtype"])
    return 100.0 * bound / per_launch_ms
