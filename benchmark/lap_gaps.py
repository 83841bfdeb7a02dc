#!/usr/bin/env python3
"""Where a step's wall time goes, lap by lap: the card's work in each lap
and the card's idle gap before it, from CUDA events recorded around each
lap's graph replay, beside the host's wait at each lap's live-count read.

    python3 benchmark/lap_gaps.py --workload glasstorus.mis --seed 7 --seconds 40

Drives a one-card cell as benchmark/run.py does (same set-up, steps back to
back) with `StaticIteration.replay` and `.live` wrapped, then prints one
JSON line: for each quarter of the window, and for the steps slower and
faster than the window's median, the mean ms a step of wall, card work,
card gap and host read wait.  A diagnostic for the host's two states
(PERF.md); the benchmark's own runs never run it, and the events it adds
make its steps no measure of the cell's rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark.lib import cells
    from pathtracer_tpu_torch.integrator import graphs
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    c = cells.cell(args.workload)
    cfg, mix = c["config"], c["traffic"]
    opts = RenderOptions(sample_mode=SampleMode[mix["mode"].upper()], **mix.get("options", {}))
    r = Renderer(cells.ROOT / cfg["scene"], opts, resolution=tuple(cfg["film"]),
                 trace_depth=cfg["depth"], device="cuda")
    r.set_seed(args.seed)
    r.step(1)

    laps = []  # per lap: (step, event before replay, event after, host read wait s)
    state = {"step": 0, "on": False}
    replay, live = graphs.StaticIteration.replay, graphs.StaticIteration.live

    def timed_replay(self, key):
        if not (state["on"] and key[0] == "lap"):
            return replay(self, key)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self, key)
        b.record()
        laps.append([state["step"], a, b, 0.0])

    def timed_live(self, key):
        t = time.perf_counter()
        n = live(self, key)
        if state["on"]:
            laps[-1][3] = time.perf_counter() - t
        return n

    graphs.StaticIteration.replay, graphs.StaticIteration.live = timed_replay, timed_live
    state["on"] = True
    walls = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        s = time.perf_counter()
        r.step(1)
        walls.append(time.perf_counter() - s)
        state["step"] += 1
    torch.cuda.synchronize()
    n = len(walls)
    work, gap, wait = np.zeros(n), np.zeros(n), np.zeros(n)
    prev = None
    for step, a, b, w in laps:
        work[step] += a.elapsed_time(b)
        if prev is not None and prev[0] == step:
            gap[step] += prev[2].elapsed_time(a)
        wait[step] += w * 1e3
        prev = (step, a, b)
    wall = np.array(walls) * 1e3

    def means(sel):
        return {k: round(float(v[sel].mean()), 3) for k, v in
                (("wall", wall), ("work", work), ("gap_between_laps", gap), ("read_wait", wait))}

    idx = np.arange(n)
    out = {"workload": args.workload, "seed": args.seed, "steps": n, "laps_a_step": len(laps) / n,
           "quarters": [means(q) for q in np.array_split(idx, 4)],
           "slow": means(wall > np.median(wall)), "fast": means(wall <= np.median(wall)),
           "wall_ms": [round(float(x), 3) for x in wall]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
