"""Small cells for the CPU tests: the real configurations and traffic
mixes at 8 streams, a window of a fraction of a second."""

from __future__ import annotations

import copy
import os
import time

from portbench import run, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CAPACITY = 8


def bench() -> dict:
    return spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def small_cell(name: str, capacity: int = CAPACITY, **traffic) -> spec.Cell:
    """BENCHMARK.json's cell `name` at `capacity` streams, every one checked."""
    cell = copy.deepcopy(spec.load_cell(bench(), name, ROOT))
    cell.traffic.update(capacity=capacity, check_streams=capacity, warmup_ticks=2, **traffic)
    return cell


def run_small(cell: spec.Cell, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
              trace: bool = False) -> dict:
    return run.run_cell(ROOT, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                        log=lambda msg: None)


def workloads() -> list:
    return [w["name"] for w in bench()["workloads"]]
