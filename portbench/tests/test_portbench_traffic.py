"""The generator: the same seed gives the same inputs and controls, every
stream is its own, and every seed gives the same sizes."""

import numpy as np
import torch

from portbench import traffic
from portbench.tests.helpers import small_cell, workloads


def _mix(name):
    return small_cell(name, capacity=16).traffic


def test_deterministic_by_seed_and_distinct_per_stream():
    for name in workloads():
        t = _mix(name)
        seed = 2 ** 33 + 5  # more than 32 bits
        a = traffic.make_inputs(t, seed, torch.device("cpu"), pin=False)
        b = traffic.make_inputs(t, seed, torch.device("cpu"), pin=False)
        c = traffic.make_inputs(t, seed + 1, torch.device("cpu"), pin=False)
        assert a.shape == (traffic.loop_ticks(t), 16, 480 * t["frames_per_tick"])
        assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == c.shape
        rows = a.transpose(0, 1).reshape(16, -1)
        # inside the engine's sanitize clamp; a loud voice may peak near 0 dBFS
        assert torch.isfinite(rows).all() and float(rows.abs().max()) < 4.0
        # every stream differs from every other
        assert (torch.cdist(rows, rows) + torch.eye(16) * 1e9).min() > 1e-3
        ca = traffic.stream_controls(t, 8, seed)
        cb = traffic.stream_controls(t, 8, seed)
        assert all(np.array_equal(ca[k], cb[k]) for k in ca)
        assert ca["target_speaker"].min() >= 0 and ca["target_speaker"].max() < 8


def test_voices_have_silences_and_voiced_stretches():
    t = dict(_mix(workloads()[0]), loop_frames=400)
    x = traffic.make_inputs(t, 3, torch.device("cpu"), pin=False)
    frames = x.transpose(0, 1).reshape(16, -1, 480)
    rms = frames.pow(2).mean(-1).sqrt()
    quiet = rms < 1e-2  # the noise floor lies near -60 dBFS
    assert quiet.float().mean() > 0.05 and (~quiet).float().mean() > 0.3


def test_history_repeats_the_loop():
    t = _mix(workloads()[0])
    x = traffic.make_inputs(t, 9, torch.device("cpu"), pin=False)
    loop = x.shape[0]
    h = traffic.history(x, np.array([1, 5]), loop + 3)
    per_tick = h.reshape(2, loop + 3, -1)
    np.testing.assert_array_equal(per_tick[:, loop:], per_tick[:, :3])
    np.testing.assert_array_equal(per_tick[1, :loop], x[:, 5].numpy())
