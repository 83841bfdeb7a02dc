#!/usr/bin/env python3
"""Where a cell's device time and the card's idle gaps go, from the
program's own spans and counters (benchmark/lib/spans.py): the cell's
set-up and a window of steps as benchmark/run.py runs them (the traced
graphs captured before the window, so that they age with it), then the
traced segment, and with `--profile 1` single iterations under
torch.profiler after it (the device-busy time the replays' spans are held
to).

    python3 benchmark/span_split.py --workload glasstorus.mis --seed 7 --seconds 20 --profile 1

Prints one JSON line: the six per-layer metrics of benchmark/lib/spans.py,
the gap split (`lap_gaps`, ms a sample by host span) and the share of it
no program span covers, each card's summary, the set-up spans, and the
segment's cost: its seconds, and its mean step against the window's last
quarter's.  The benchmark's own runs do not run it.  It supersedes
benchmark/lap_gaps.py, which wraps the program's methods from outside.
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
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import numpy as np

    from benchmark.lib import cells, spans
    from benchmark.lib import trace as tr_mod
    from benchmark.lib.harness import _devices, _sync, power_limit
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    c = cells.cell(args.workload)
    cfg, mix = c["config"], c["traffic"]
    devices = int(cfg.get("devices", 1))
    opts = RenderOptions(sample_mode=SampleMode[mix["mode"].upper()], **mix.get("options", {}))
    spp = int(mix.get("samples_per_step", 1))
    r = Renderer(cells.ROOT / cfg["scene"], opts, resolution=tuple(cfg["film"]),
                 trace_depth=cfg["depth"], devices=devices if devices > 1 else None,
                 device="cuda")
    devs = _devices(r)
    r.set_seed(args.seed)
    r.step(1)
    spans.prepare(r, spp, lambda: _sync(devs))
    before = spans.counts(r)
    t0 = time.perf_counter()
    ends = []
    while not ends or ends[-1] < args.seconds:
        r.step(spp)
        ends.append(time.perf_counter() - t0)
    steps = np.diff([0.0] + ends)
    m = {"counts": spans.window_counts(before, spans.counts(r), len(ends) * spp)}
    m["spans"] = spans.segment(r, spp, lambda: _sync(devs))
    quarter_ms = float(np.mean(np.array_split(steps, 4)[-1])) * 1e3 / spp
    out = {"workload": args.workload, "seed": args.seed, "card": power_limit(),
           "window_steps": len(ends), "window_last_quarter_ms": quarter_ms,
           "window_steps_ms": [round(float(x) * 1e3, 3) for x in steps],
           "metrics": spans.metrics(m), "lap_gaps": spans.lap_gaps(m),
           "gap_uncovered_share": spans.uncovered_share(m),
           "replay_ms_per_spp": spans.replay_ms_per_spp(m), "window_counts": m["counts"],
           "setup": spans.setup_spans(r), "kernel_builds": r.stats.kernel_builds}
    seg = m["spans"]
    if seg is not None:
        out["segment"] = {k: seg[k] for k in ("seconds", "untimed_s", "steps", "step_ms",
                                              "dropped", "spans", "steps_ms", "replay_ms_by_step")}
        out["segment"]["cost_pct"] = 100.0 * (seg["step_ms"] / spp / quarter_ms - 1.0)
        out["cards"] = seg["summary"]
    if args.profile:
        busy = []
        for _ in range(2):
            s = tr_mod.summarize(tr_mod.record(lambda: r.step(1), lambda: _sync(devs)))
            busy.append(1e3 * sum(s["busy_s"].values()) / len(s["busy_s"]))
        out["device_busy_ms_per_spp"] = busy
    cards = out.get("cards") or {}
    brief = {k: v for k, v in (out.get("segment") or {}).items()
             if k not in ("steps_ms", "replay_ms_by_step")}
    print(f"span_split: {args.workload} seed {args.seed}: window {len(ends)} steps, last quarter "
          f"{quarter_ms:.3f} ms a sample; segment {json.dumps(brief)}; gap split "
          f"{json.dumps(out['lap_gaps'])}; per card "
          + "; ".join(f"{k}: replays {v['replay_total_ms']:.3f} ms, stages "
                      f"{json.dumps({s: round(x, 3) for s, x in v['stage_ms'].items()})}, "
                      f"coverage {v['coverage']:.5f}, anchor +-{v['anchor_us']} us"
                      for k, v in cards.items())
          + f"; set-up {json.dumps(out['setup'])}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
