"""The program's own spans and counters over a run of a cell
(pathtracer_tpu_torch/utils/profiling.py, integrator/graphs.py), and the
arithmetic of the per-layer metrics that read them.

The segment (`segment`): tracing on, one untimed step, STEPS timed steps,
tracing off.  It follows the window and comes before any torch.profiler
trace, whose residue slows later graph launches in the process.  A freshly
captured set of graphs runs about 0.3 us a node slower for its first
seconds, replayed or not (PERF.md §2), so `prepare` captures the traced
graphs before the window, where they age with the untraced ones; without it
the segment's untimed step captures them and the timed steps read that slow
state.  Its numbers, per card and per sample (`profiling.summary`): each
step key's device ms, the stages' (sort, intersect, nee, shade), and the
card's idle gaps between the consecutive replays of an iteration split over
the host spans in flight.
The window's counters (`counts`, before and after it): the graph nodes the
untraced replays ran.

Each reader takes the measurements `m` with `m["spans"]` (the segment) and
`m["counts"]` (the window's counters) and returns None where they are
missing: a program without the tracer (`profiling.tracing` absent) or
without the counters (`StaticIteration.counts` absent) gives neither.
Four-card values are the mean over the cards, as `device_busy_ms_per_spp`
takes them.
"""

from __future__ import annotations

import time

STEPS = 30
STAGES = ("sort", "intersect", "nee", "shade")


def counts(r) -> dict | None:
    """Per card, the counters of the Renderer's StaticIterations
    (`StaticIteration.counts`): None where the program has none."""
    its = r.compiled_iterations() if hasattr(r, "compiled_iterations") else []
    if not its or not all(hasattr(it, "counts") for it in its):
        return None
    out = {}
    for i, it in enumerate(its):
        card = it.device.index if it.device.type == "cuda" else i
        out[card] = it.counts()
    return out


def window_counts(before: dict | None, after: dict | None, samples: int) -> dict | None:
    """Per card, the counters' change over `samples` samples, per sample."""
    if before is None or after is None or not samples:
        return None
    return {card: {k: (v - before.get(card, {}).get(k, 0)) / samples for k, v in c.items()}
            for card, c in after.items()}


def setup_spans(r) -> list:
    """The Renderer's set-up spans and its iterations' later captures:
    [name, card, ms, parent's name], in order of start."""
    if not hasattr(r, "setup"):
        return []
    rows = []
    for tr in [r.setup] + [it.setup for it in r.compiled_iterations()]:
        spans = tr.spans()
        names = {s.id: s.name for s in spans}
        rows += [(s.start, [s.name, s.card, round((s.end - s.start) / 1e6, 3),
                            names.get(s.parent, "")]) for s in spans]
    return [row for _, row in sorted(rows, key=lambda r: r[0])]


def prepare(r, spp: int, sync) -> bool:
    """Capture Renderer `r`'s traced graphs now: one traced step, its spans
    dropped.  False where the program has no tracer."""
    from pathtracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return False
    with profiling.tracing():
        r.step(spp)
        sync()
    return True


def segment(r, spp: int, sync, steps: int = STEPS) -> dict | None:
    """The traced segment on Renderer `r` (`spp` samples a step, `sync()`
    after each): None where the program has no tracer."""
    from pathtracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return None
    t0 = time.perf_counter()
    with profiling.tracing() as tr:
        r.step(spp)
        sync()
        tr.drain()
        t1 = time.perf_counter()
        ends = []
        for _ in range(steps):
            r.step(spp)
            sync()
            ends.append(time.perf_counter() - t1)
        spans = tr.drain()
    done = time.perf_counter()
    step_s = [b - a for a, b in zip([0.0] + ends, ends)]
    by_step = {}  # card -> iteration -> its replays' device ms
    for s in spans:
        if s.name == "device.replay":
            it = by_step.setdefault(s.card, {})
            it[s.iteration] = it.get(s.iteration, 0.0) + (s.end - s.start) / 1e6
    return {"seconds": done - t0, "untimed_s": t1 - t0, "steps": steps, "spp": spp,
            "step_ms": sum(step_s) / steps * 1e3, "dropped": tr.dropped, "spans": len(spans),
            "steps_ms": [round(x * 1e3, 3) for x in step_s],
            "replay_ms_by_step": {c: [round(v[k], 3) for k in sorted(v)] for c, v in by_step.items()},
            "summary": profiling.summary(spans, samples=steps * spp)["cards"]}


def _mean(m: dict, pick) -> float | None:
    seg = m.get("spans")
    if not seg or not seg["summary"]:
        return None
    vals = [pick(sm) for sm in seg["summary"].values()]
    return sum(vals) / len(vals)


def lap_gap_ms_per_spp(m: dict) -> float | None:
    return _mean(m, lambda sm: sm["gap_total_ms"])


def stage_ms_per_spp(m: dict, stage: str) -> float | None:
    return _mean(m, lambda sm: sm["stage_ms"][stage])


def replay_ms_per_spp(m: dict) -> float | None:
    return _mean(m, lambda sm: sm["replay_total_ms"])


def graph_nodes_per_spp(m: dict) -> float | None:
    c = m.get("counts")
    if not c:
        return None
    return sum(v["nodes"] for v in c.values()) / len(c)


def metrics(m: dict) -> dict:
    """The six per-layer metrics this module reads, None where nothing."""
    out = {"lap_gap_ms_per_spp": lap_gap_ms_per_spp(m),
           "graph_nodes_per_spp": graph_nodes_per_spp(m)}
    out.update({f"{s}_ms_per_spp": stage_ms_per_spp(m, s) for s in STAGES})
    return out


def lap_gaps(m: dict) -> list | None:
    """The gap split as a breakdown: [host span, ms a sample] hottest first,
    the mean over the cards."""
    seg = m.get("spans")
    if not seg or not seg["summary"]:
        return None
    cards = list(seg["summary"].values())
    names = {k for sm in cards for k in sm["gap_ms"]}
    split = {k: sum(sm["gap_ms"].get(k, 0.0) for sm in cards) / len(cards) for k in names}
    return sorted(([k, v] for k, v in split.items()), key=lambda kv: -kv[1])


def uncovered_share(m: dict) -> float | None:
    """The share of the gaps that no program span covers (the untraced
    host), the mean over the cards."""
    seg = m.get("spans")
    if not seg or not seg["summary"]:
        return None
    shares = [sm["gap_ms"].get("untraced host", 0.0) / sm["gap_total_ms"]
              for sm in seg["summary"].values() if sm["gap_total_ms"]]
    return sum(shares) / len(shares) if shares else None
