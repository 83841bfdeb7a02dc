#!/usr/bin/env python3
"""The triangle walks' device time on one benchmark cell, read two ways in
one process: the program's own spans (`device.walk_closest` and
`device.walk_shadow`, utils/profiling.py) and the walk kernels' time in a
torch.profiler trace (K1-K5 by tag, benchmark/lib/trace.py), which is what
the benchmark's `walk_ms_per_spp` reads.

    python3 tools/walk_span_check.py --workload glasstorus160k.mis --seed 7 --seconds 20

The cell's Renderer is built and warmed up as benchmark/run.py builds it,
its traced graphs captured before a window of `--seconds` (as
benchmark/span_split.py does), then, in turn: a traced segment of
`--steps` steps (the spans alone); TRACES untraced iterations under the
profiler (the benchmark's reading); TRACES traced iterations under the
profiler (spans and kernels of the same iterations).  Prints one JSON line:
each reading in ms a sample, each profiled iteration's K1-K5 runs by tag,
the walk's tables (`StaticIteration.tables`) and the set-up spans.
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

TRACES = 2


def _walk_ms(cards: dict) -> dict:
    """The spans' walk ms a sample, the mean over the cards, by walk."""
    names = {k for sm in cards.values() for k in sm["walk_ms"]}
    return {k: sum(sm["walk_ms"][k] for sm in cards.values()) / len(cards) for k in sorted(names)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal, with no device time")
    p.add_argument("--res", default=None, help="WxH, the cell's film by default")
    args = p.parse_args(argv)

    from benchmark.lib import cells, spans
    from benchmark.lib import trace as tr_mod
    from benchmark.lib.harness import _devices, _sync, power_limit
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils import profiling
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    c = cells.cell(args.workload)
    cfg, mix = c["config"], c["traffic"]
    devices = int(cfg.get("devices", 1))
    opts = RenderOptions(sample_mode=SampleMode[mix["mode"].upper()], **mix.get("options", {}))
    res = tuple(int(x) for x in args.res.split("x")) if args.res else tuple(cfg["film"])
    r = Renderer(cells.ROOT / cfg["scene"], opts, resolution=res, trace_depth=cfg["depth"],
                 devices=devices if devices > 1 else None, device=args.device)
    devs = _devices(r)

    def sync():
        _sync(devs)

    r.set_seed(args.seed)
    r.step(1)
    spans.prepare(r, 1, sync)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        r.step(1)
    seg = spans.segment(r, 1, sync, steps=args.steps)

    def profiled():
        s = tr_mod.summarize(tr_mod.record(lambda: r.step(1), sync))
        ncards = max(len(s["busy_s"]), 1)
        return s, {"trace_walk_ms": 1e3 * sum(s["traversal_s"].values()) / ncards,
                   "trace_ms_by_tag": {k: 1e3 * v / ncards for k, v in s["traversal_s"].items()},
                   "runs_by_tag": s["traversal"],
                   "busy_ms": 1e3 * sum(s["busy_s"].values()) / ncards}

    untraced = [profiled() for _ in range(TRACES)]
    traced = []
    for _ in range(TRACES):
        with profiling.tracing() as tr:
            _, row = profiled()
            row["span_walk_ms"] = _walk_ms(profiling.summary(tr.drain(), samples=1)["cards"])
        traced.append(row)
    for row in traced:
        row["span_over_trace"] = sum(row["span_walk_ms"].values()) / row["trace_walk_ms"] \
            if row["trace_walk_ms"] else None
    out = {"workload": args.workload, "seed": args.seed, "card": power_limit(),
           "tables": [it.tables() for it in r.compiled_iterations()],
           "segment_walk_ms": _walk_ms(seg["summary"]) if seg else None,
           "segment_stage_ms": ({k: v["stage_ms"] for k, v in seg["summary"].items()}
                                if seg else None),
           "walk_ms_per_spp": cells.reader("walk_ms_per_spp")({"traces": [s for s, _ in untraced]}),
           "untraced": [row for _, row in untraced], "traced": traced,
           "setup": spans.setup_spans(r)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
