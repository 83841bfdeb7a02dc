"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

- `BENCHMARK.json` at the checkout's root: the cells, the configurations and
  the metrics;
- `benchmark/configs/<config>.json`: one deployment (scene file, film,
  depth, cards), with its source and what was assumed;
- `benchmark/traffic/<traffic>.json`: one mix (integrator mode, render
  options, samples a step);
- `benchmark/workloads/<cell>.json`: the cell's own data, the limits of the
  comparison that decides `correct`;
- `benchmark/metrics/<metric>.py`: one metric's reader, `read(m)` of the
  run's measurements, None where it finds nothing to read.

A cell, configuration, mix or metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """Everything one cell needs: its BENCHMARK.json entry, configuration,
    mix and own data, and the metrics it reports with and without a trace."""
    s = spec()
    entry = next((w for w in s["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg = next(c for c in s["configs"] if c["name"] == entry["config"])

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {
        "entry": entry,
        "config": _json(ROOT / cfg["file"]),
        "traffic": _json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        "own": _json(BENCH / "workloads" / f"{name}.json"),
        "end_to_end": [m for m in s["end_to_end"] if reports(m)],
        "per_layer": [m for m in s["per_layer"] if reports(m)],
    }


def reader(metric: str):
    """The `read` function of benchmark/metrics/<metric>.py."""
    return importlib.import_module(f"benchmark.metrics.{metric}").read
