#!/usr/bin/env python3
"""Run one benchmark cell of pathtracer_tpu_torch once, on the CUDA cards of
this machine, and print its result as one JSON line.

    python3 benchmark/run.py --workload glasstorus.mis --seed 7 --seconds 51 --trace 0

`--trace 0` reports the cell's end-to-end metrics (BENCHMARK.json
`end_to_end`), `--trace 1` its per-layer metrics, read from the program's
counters, the benchmark's spans and torch.profiler traces taken after the
window.  Every run checks the window's film against the plain reference
(benchmark/reference) and prints each compared number beside its limit, as
the last lines of standard error and under `checks`, the last key of the
result line.  A machine with fewer CUDA cards than the cell asks for gets
no result and a non-zero exit.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # the set-up's clock starts with the runner

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def result_line(c: dict, m: dict, trace: bool) -> dict:
    """The result's JSON object from the run's measurements `m`."""
    from benchmark.lib import cells

    metrics = {}
    for spec in c["per_layer"] if trace else c["end_to_end"]:
        value = cells.reader(spec["name"])(m)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    limits = c["own"]["limits"]
    checks = {k: {"value": m["checks"][k], "limit": limits[k]} for k in limits}
    device = {"platform": "gpu", "kind": m["kind"], "count": m["chips"],
              "memory_peak_bytes": m["memory_peak_bytes"], "power_limit": m["power_limit"]}
    out = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
           "attempted": m["window_samples"], "failed": 0, "metrics": metrics, "device": device}
    if trace and m["traces"]:
        t = m["traces"]
        device["busy_s"] = sum(sum(s["busy_s"].values()) / len(s["busy_s"]) for s in t)
        device["window_s"] = sum(s["wall_s"] for s in t)
        merged = {"device_ops": {}, "idle_gaps": {}}
        for s in t:
            for part, key in (("device_ops", "top_ops"), ("idle_gaps", "idle_gaps")):
                for name, sec in s[key]:
                    merged[part][name] = merged[part].get(name, 0.0) + sec
        out["breakdown"] = {part: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
                            for part, d in merged.items()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.lib import cells, harness

    c = cells.cell(args.workload)
    chips = int(c["entry"]["chips"])
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"run.py: cell {args.workload} needs {chips} CUDA card(s); this machine has {have} "
              f"(torch.cuda.is_available() {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    m = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), start=START)
    if not m["graph_route"]:
        print("run.py: the Renderer did not take its CUDA-graph route", file=sys.stderr)
        return 3
    m["kind"] = torch.cuda.get_device_name(0)
    m["power_limit"] = harness.power_limit()
    out = result_line(c, m, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: modules the benchmark must not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(f"run: {args.workload} seed {args.seed}: {m['window_samples']} samples in "
          f"{m['window_s']:.3f} s, set-up {m['setup_s']:.3f} s, card {m['kind']} "
          f"({m['power_limit']}), phases {json.dumps(m['phase_s'])}, step ms by quarter of the window "
          f"{json.dumps(m['quarters_ms'])}, walk {json.dumps(m['walk'])}, "
          f"each step's ms in turn {json.dumps(m['steps_ms'])}",
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
