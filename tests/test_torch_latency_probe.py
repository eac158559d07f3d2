"""The port's latency probe (`beatrice_vst_tpu_torch/scripts/latency_probe.py`)
on the CPU: the burst pairing on synthetic timestamps (missed bursts,
extra and early detections), and one short live run through a
`ModelHost(jit=True)` on klatt8 (2 sessions, capacity 2, auto pacing)
whose report is well formed and detects nine bursts in ten or more.
No timing is asserted: the CPU's speed under a loaded test run is not
the card's."""

import os

import numpy as np
import pytest
import torch

from beatrice_vst_tpu_torch.scripts import latency_probe as probe

torch.set_num_threads(1)

MODEL_DIR = os.path.join(os.path.dirname(__file__), "..", "models_demo", "klatt8")

PAIRINGS = {
    # name: (pushes, detections, latencies ms, missed, extra)
    "clean": ([0.0, 1.0, 2.0], [0.1, 1.2, 2.05], [100, 200, 50], 0, 0),
    "missed": ([0.0, 1.0, 2.0, 3.0], [0.1, 2.1, 3.3], [100, 100, 300], 1, 0),
    "extra": ([0.0, 1.0, 2.0], [0.1, 0.5, 1.1, 2.1, 2.9], [100, 100, 100], 0, 2),
    "early": ([1.0, 2.0], [0.5, 1.15, 2.15], [150, 150], 0, 1),
    "late_last": ([0.0, 1.0], [0.1, 2.5], [100, 1500], 0, 0),
    "unordered": ([0.0, 1.0], [1.25, 0.25], [250, 250], 0, 0),
    "none_detected": ([0.0, 1.0], [], [], 2, 0),
}


@pytest.mark.parametrize("case", sorted(PAIRINGS))
def test_burst_latencies_pair_each_burst_with_its_first_detection(case):
    pushes, detections, latencies, missed, extra = PAIRINGS[case]
    got = probe.burst_latencies(pushes, detections)
    np.testing.assert_allclose(got["latency_ms"], latencies, rtol=0, atol=1e-9)
    assert (got["missed"], got["extra"]) == (missed, extra)


def test_a_short_live_run_detects_the_bursts():
    report = probe.run_probe(MODEL_DIR, sessions=2, seconds=4.0, capacity=2, warmup_s=0.3,
                             device="cpu", log=lambda s: None)
    print(f"\n{report['frame_latency_ms']} at {report['pace_ms']:.1f} ms pacing, "
          f"detection {report['burst_detection_ratio']}")
    assert report["device"] == "cpu" and report["sessions"] == 2
    assert report["burst_detection_ratio"] > 0.9, report
    assert report["bursts_sent"] >= 2 * 2 and report["bursts_measured"] >= 1
    lat = report["frame_latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]
    assert report["pace_ms"] >= 10.0 and report["engine_ticks"] > 0
    assert set(report["scheduler"]) >= {"dispatch_tick_p50_ms", "serve_tick_p50_ms",
                                        "underruns", "streams_active"}
    assert probe.PERIOD_SCALE not in os.environ  # restored
