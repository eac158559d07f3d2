"""The benchmark as data: `BENCHMARK.json` at the checkout's root names the
cells and metrics; every configuration, traffic mix, driver, reference and
metric is a file of its own under `portbench/`, found by its name:

  portbench/configs/<config>.json       a configuration (sizes, weights, limits)
  portbench/traffic/<traffic>.json      a traffic mix (parameters of the generator)
  portbench/drivers/<driver>.py         the window a traffic mix names ("driver")
  portbench/reference/<reference>.py    the plain reference a configuration names
  portbench/metrics/<metric>.py         a metric's reader: read(record, ctx)

A later change adds a cell or a metric by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: str) -> Cell:
    """The cell `name` of the benchmark `bench` (BENCHMARK.json's content)."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r}; known: {[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])
