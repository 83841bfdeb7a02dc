"""Profiling and observability: the program's spans and counters, and a
device trace.

Spans.  A `Tracer` keeps spans in a list of fixed length, allocated when it
is made, that a caller drains (`drain`); a span that finds it full is
dropped and counted (`dropped`), so a preview server left tracing holds a
bounded buffer.  A span is `Span(id, parent, name, card, start, end, key,
iteration, lap)`: start and end in ns of `time.perf_counter_ns()`
(CLOCK_MONOTONIC on Linux), `parent` the id of the span that caused it (0:
none), `card` the card's index (-1: no card's), and the attributes the
step key, the iteration and the lap (None / -1 where they do not apply).

`tracing()` turns recording on for a block.  `ON` is the one module-level
test at each instrumented boundary of the compiled iteration
(integrator/graphs.py): with tracing off a boundary costs that test, with
no allocation, no CUDA call and no synchronize.  With tracing on, each
iteration records, per card, the host's spans `step` (its iteration as
the attribute), `set_inputs`, `replay` (the host's enqueue of one step),
`plan` (the lap plan's decision), `live_read` (the host's wait for the live
count) and, in `run_lockstep`, one `round` a lap whose children are each
card's `replay` and `live_read`.

Device spans come from stamps: `stamp` writes the card's %globaltimer (the
stamp kernel, csrc/stamp.cu) into a StaticIteration's stamp table, one row
a step (every lap of an iteration in its own row, from the lap counter on
the card), one column per edge: the step's first and last node and the
edges of the lap's stages (`SORT` .. `STAGES_END`, placed by
integrator/wavefront.py).  Stamps are captured only into the traced
graphs, which a StaticIteration holds beside its untraced ones.  One copy
of the table an iteration, to pinned memory, is read after a synchronize
the iteration makes anyway; the card's clock is put on the host's by an
anchor per iteration: each of ANCHORS lone stamps into the table's anchor
row, issued to the idle card before the iteration's first step and waited
for, is written after the host began to issue it and before the wait
returned (tracing only: a synchronize of an idle card);
so is every step's first stamp after its replay began, and every lap's
last stamp before the live read after it returned.  The offset is the
middle of the tightest bounds (`device.anchor` spans the anchor stamp's
possible places: its half-width is the error).  On the
CPU a stamp is the host's perf_counter_ns itself (CPU ops are synchronous).
Device spans: `device.replay` (a step, its parent the host's `replay`) and
its stages `device.sort`, `device.intersect`, `device.nee` and
`device.shade` (a lap's time from the closest hit to its pool written back,
outside the NEE: material lookup, scatter sample, light hit and MIS weight,
continuation, the refill under regeneration).  Inside `device.intersect`,
`device.walk_closest`, and inside `device.nee`, `device.walk_shadow`: the
triangle walk's kernel launch (K1, K3 or K5; K2 or K4), between a stamp
just before it and one just after (ops/traverse.py), where the lap walks
its triangles through a kernel.

Set-up spans (`renderer.init`, `cuda.context`, `scene.load`, `bvh.build`
with `stream.tables` inside it on a streamed mesh, `tables.upload`,
`renderer.warmup`, `kernels.load`, `graph.capture` with its `eager` and
`instantiate`) are recorded whatever the state, each into a small Tracer
of the object that does the set-up (`Renderer.setup`,
`StaticIteration.setup`).

`summary` turns spans into per-card, per-sample numbers: device ms of every
replay by step key, by stage and in the triangle walks, and the card's idle
gaps between the consecutive replays of an iteration, each split over the
host spans that overlap it.

`device_trace` writes a torch.profiler trace as a Chrome trace; with
tracing on, it also carries the program's spans, on the profiler's clock,
as their own track.  `top_ops_from_trace` reads the device's events of such
a trace (the raw events: `key_averages()` takes about a minute per 100k
events).
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

# Chrome-trace categories of the card's own work: kernels, copies, fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# Stamp-table columns: a step's first node, the lap's stage edges (each
# stage runs from its column to the next column stamped), its last node;
# then the edges of the triangle walks, each inside its stage.
STEP_BEGIN, SORT, INTERSECT, SHADE, NEE, SHADE_AFTER_NEE, STAGES_END, STEP_END = range(8)
WALK_CLOSEST, WALK_CLOSEST_END, WALK_SHADOW, WALK_SHADOW_END = range(8, 12)
STAMP_COLS = 12
# the walks' spans: (first column, last column, the stage column they lie in)
WALK_SPANS = {"walk_closest": (WALK_CLOSEST, WALK_CLOSEST_END, INTERSECT),
              "walk_shadow": (WALK_SHADOW, WALK_SHADOW_END, NEE)}
STAGE_NAMES = {SORT: "sort", INTERSECT: "intersect", SHADE: "shade", NEE: "nee",
               SHADE_AFTER_NEE: "shade"}
STAGES = ("sort", "intersect", "nee", "shade")
# the host's spans an idle gap of a card is charged to (on that card; on
# another card they count as that card's round work)
GAP_SPANS = ("replay", "live_read", "plan", "set_inputs")
CAPACITY = 1 << 16
ANCHORS = 3  # lone stamps an iteration that put a card's clock on the host's
CLOCK_MARK = "pathtracer.clock"  # the profiler events that put spans on its clock
TRACE_PID = 7_000_000           # the spans' process in a Chrome trace

ON = False                    # a Tracer records the iteration's spans
TRACER: "Tracer | None" = None


class Span(NamedTuple):
    id: int
    parent: int
    name: str
    card: int
    start: int
    end: int
    key: tuple | None = None
    iteration: int = -1
    lap: int = -1


def key_name(key) -> str:
    """A step key as a name: start, lap0, lap0.sort, down0, up0, finish."""
    kind = key[0]
    if kind == "lap":
        return f"lap{key[1]}" + (".sort" if key[2] else "")
    if kind in ("down", "up"):
        return f"{kind}{key[1]}"
    return kind


class StampRead(NamedTuple):
    """One StaticIteration's stamp table of one iteration, and what puts its
    rows on the host's clock: `steps` (key, row, lap, the host replay
    span's id, the host's clock when the replay began) in order, `reads`
    (row, the host's clock when the live read after that lap returned),
    `anchor` (the host's clock before and after each lone stamp into row 0,
    column by column, and its synchronize).  `table` is a numpy array of
    the host's clock (the CPU's stamps; `event` None), or a pinned tensor
    of a card's clock whose copy `event` follows."""
    card: int
    iteration: int
    table: object
    event: object
    steps: list
    reads: list
    anchor: list


class Tracer:
    """Spans in a list of `capacity` entries, and the stamp tables still to
    be read, `capacity // 64` at most; what finds them full is dropped and
    counted."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self._spans: list = [None] * self.capacity
        self._n = 0
        self._reads: list = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._open: list = []  # the open spans, innermost last

    # -- recording -----------------------------------------------------------
    def _put(self, span: Span) -> None:
        if self._n < self.capacity:
            self._spans[self._n] = span
            self._n += 1
        else:
            self.dropped += 1

    def add(self, name: str, start: int, end: int, parent: int | None = None, card: int = -1,
            key=None, iteration: int = -1, lap: int = -1) -> int:
        """A finished span; its parent is the innermost open span unless
        given.  Returns its id."""
        sid = next(self._ids)
        if parent is None:
            parent = self._open[-1][0] if self._open else 0
        self._put(Span(sid, parent, name, card, start, end, key, iteration, lap))
        return sid

    def open(self, name: str, card: int = -1, key=None, iteration: int = -1,
             root: bool = False) -> int:
        """Start a span that the spans added until its `close` are children
        of; a `root` span closes what was left open (by an exception)."""
        if root:
            self._open.clear()
        sid = next(self._ids)
        parent = self._open[-1][0] if self._open else 0
        self._open.append((sid, parent, name, card, key, iteration, time.perf_counter_ns()))
        return sid

    def close(self, sid: int) -> None:
        """End open span `sid` (and any opened inside it and left open)."""
        end = time.perf_counter_ns()
        for i in range(len(self._open) - 1, -1, -1):
            if self._open[i][0] == sid:
                sid, parent, name, card, key, iteration, start = self._open[i]
                del self._open[i:]
                self._put(Span(sid, parent, name, card, start, end, key, iteration))
                return

    def adopt(self, spans: list, parent: int) -> None:
        """Another Tracer's spans as this one's, with new ids, those without
        a parent among them under `parent`."""
        ids = {s.id: next(self._ids) for s in spans}
        for s in spans:
            self._put(s._replace(id=ids[s.id], parent=ids.get(s.parent, parent)))

    def stamp_read(self, read: StampRead) -> None:
        if len(self._reads) < self.capacity // 64:
            self._reads.append(read)
        else:
            self.dropped += 1

    # -- reading -------------------------------------------------------------
    def _harvest(self) -> None:
        """The stamp tables still to be read, as device spans."""
        reads, self._reads = self._reads, []
        for read in reads:
            _device_spans(self, read)

    def spans(self) -> list:
        """The spans recorded so far, the stamps read; the buffer is kept."""
        self._harvest()
        return self._spans[:self._n]

    def drain(self) -> list:
        """The spans recorded so far, the stamps read; the buffer is emptied."""
        out = self.spans()
        self._spans[:self._n] = [None] * self._n
        self._n = 0
        return out

    def summary(self, samples: int | None = None) -> dict:
        """`summary` of the spans recorded so far (the buffer is kept)."""
        return summary(self.spans(), samples)


@contextlib.contextmanager
def tracing():
    """Record the program's spans inside the block into a new Tracer."""
    global ON, TRACER
    was = ON, TRACER
    tr = Tracer()
    ON, TRACER = True, tr
    try:
        yield tr
    finally:
        ON, TRACER = was


# -- stamps -----------------------------------------------------------------
def stamp(table, col: int, row: int, lap=None) -> None:
    """Write the time into table[row + lap, col] (`table` a row-major
    (rows, STAMP_COLS) int64 tensor, `lap` a 0-d int32 tensor on its
    device, or None; a row past the table's last is its last): on a card
    the stamp kernel writes %globaltimer in stream order, so a CUDA graph
    can hold it; on the CPU the host's perf_counter_ns."""
    nrows = table.shape[0]
    if table.device.type == "cpu":
        r = row + (int(lap) if lap is not None else 0)
        table[min(max(r, 0), nrows - 1), col] = time.perf_counter_ns()
        return
    from pathtracer_tpu_torch.ops import _build

    _build.launch("pt_stamp", table.device, table, lap, int(row), int(col), STAMP_COLS, nrows)


def anchor_stamps(table, n: int = ANCHORS) -> list:
    """`n` lone stamps into row 0 of `table`, columns 0 .. n - 1, each
    issued to the idle card and waited for: [(the host's clock before the
    launch, after the wait)] for each.  Each stamp lies between its two
    readings; the tightest pair puts the card's clock on the host's.  On
    the CPU the stamps are the host's clock."""
    out = []
    if table.device.type == "cpu":
        for col in range(n):
            t0 = time.perf_counter_ns()
            table[0, col] = time.perf_counter_ns()
            out.append((t0, time.perf_counter_ns()))
        return out
    import torch

    from pathtracer_tpu_torch.ops import _build

    stream = torch.cuda.current_stream(table.device)
    for col in range(n):
        t0 = time.perf_counter_ns()
        _build.launch("pt_stamp", table.device, table, None, 0, col, STAMP_COLS, table.shape[0])
        stream.synchronize()
        out.append((t0, time.perf_counter_ns()))
    return out


def globaltimer_resolution(device, n: int = 4096) -> dict:
    """%globaltimer read `n` times back to back by one thread of `device`:
    the smallest step between two readings (ns, the resolution), the mean
    step and the readings' span."""
    import torch

    from pathtracer_tpu_torch.ops import _build

    out = torch.zeros((n,), dtype=torch.int64, device=device)
    _build.launch("pt_timer_probe", out.device, out, n, what="timer probe")
    torch.cuda.synchronize(out.device)
    steps = np.diff(out.cpu().numpy())
    moved = steps[steps > 0]
    return {"resolution_ns": int(moved.min()) if moved.size else None,
            "mean_step_ns": float(moved.mean()) if moved.size else None,
            "span_ns": int(steps.sum())}


def _device_spans(tr: Tracer, read: StampRead) -> None:
    """A stamp table's device spans, on the host's clock, into `tr`."""
    if read.event is not None:
        read.event.synchronize()
    rows = read.table.tolist()
    spill = len(rows) - 1
    off = lo = hi = 0
    if read.event is not None:
        # a stamp is written after the host began to issue it and before a
        # wait for it returned: each bound of host - card clock that gives
        lo = max([t0 - a for (t0, _), a in zip(read.anchor, rows[0])]
                 + [t0 - rows[row][STEP_BEGIN] for _, row, _, _, t0 in read.steps
                    if row < spill and rows[row][STEP_BEGIN]], default=None)
        hi = min([t1 - a for (_, t1), a in zip(read.anchor, rows[0])]
                 + [h1 - rows[row][STEP_END] for row, h1 in read.reads
                    if row < spill and rows[row][STEP_END]], default=None)
        if lo is None or hi is None:
            return
        hi = max(hi, lo)
        off = (lo + hi) // 2
    tr.add("device.anchor", rows[0][STEP_BEGIN] + lo, rows[0][STEP_BEGIN] + hi, parent=0,
           card=read.card, iteration=read.iteration)
    for key, row, lap, parent, _ in read.steps:
        r = rows[row]
        if row >= spill or not (r[STEP_BEGIN] and r[STEP_END]):
            continue
        did = tr.add("device.replay", r[STEP_BEGIN] + off, r[STEP_END] + off, parent=parent,
                     card=read.card, key=key, iteration=read.iteration, lap=lap)
        cols = [c for c in range(SORT, STEP_END) if r[c]]
        stage_ids = {}
        for c, nxt in zip(cols, cols[1:] + [STEP_END]):
            if c == STAGES_END:
                break
            stage_ids[c] = tr.add("device." + STAGE_NAMES[c], r[c] + off, r[nxt] + off,
                                  parent=did, card=read.card, key=key,
                                  iteration=read.iteration, lap=lap)
        for name, (first, last, stage) in WALK_SPANS.items():
            if r[first] and r[last]:
                tr.add("device." + name, r[first] + off, r[last] + off,
                       parent=stage_ids.get(stage, did), card=read.card, key=key,
                       iteration=read.iteration, lap=lap)


# -- the numbers ------------------------------------------------------------
def _dur(s: Span) -> int:
    return s.end - s.start


def _gap_split(a: int, b: int, card: int, launched: int, host: list, starts: list, out: dict):
    """Charge idle gap [a, b] of `card` to the host spans over it (`host`
    sorted by start, disjoint: one thread), by time: a span of this card by
    its name, another card's as that card's round work; of the rest, what
    lies after the enqueue of the step that ends the gap returned
    (`launched`) to launch latency, the remainder to the untraced host."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    covered = []
    while k < len(host) and host[k].start < b:
        s = host[k]
        lo, hi = max(a, s.start), min(b, s.end)
        if hi > lo:
            name = s.name if s.card == card else "other cards"
            out[name] = out.get(name, 0) + hi - lo
            covered.append((lo, hi))
        k += 1
    edge = a
    for lo, hi in covered + [(b, b)]:
        if lo > edge:
            late = max(0, lo - max(edge, launched))
            out["launch latency"] = out.get("launch latency", 0) + late
            out["untraced host"] = out.get("untraced host", 0) + (lo - edge) - late
        edge = max(edge, hi)


def summary(spans: list, samples: int | None = None) -> dict:
    """Per card (`cards`, by index), per sample (`samples` a card, by
    default the iterations it ran): device ms of every replay by step key
    (`replay_ms`) and in all (`replay_total_ms`), of the laps (`lap_ms`),
    by stage (`stage_ms`: sort, intersect, nee, shade; the sorts of the
    ladder's steps down included), in the triangle walks' kernels
    (`walk_ms`: walk_closest, inside intersect, and walk_shadow, inside
    nee), the laps' time outside their stages (`lap_unstaged_ms`), the
    share of the replays' time the laps' stages and the other steps
    account for (`coverage`), the card's idle gaps between the consecutive
    replays of an iteration by the host span in flight
    (`gap_ms`, `gap_total_ms`), the host's own spans of the card
    (`host_ms`), and the anchor's error (`anchor_us`: half the widest
    interval the card's clock was put in)."""
    by_id = {s.id: s for s in spans}
    host = sorted((s for s in spans if s.name in GAP_SPANS), key=lambda s: s.start)
    starts = [s.start for s in host]
    cards = {}
    for s in spans:
        if s.name.startswith("device."):
            cards.setdefault(s.card, []).append(s)
    out = {}
    for card, dev in sorted(cards.items()):
        steps = [s for s in dev if s.name == "device.replay"]
        n = samples or len({s.iteration for s in steps}) or 1
        ms = 1e-6 / n
        replay, stage, walk = {}, dict.fromkeys(STAGES, 0), dict.fromkeys(WALK_SPANS, 0)
        lap_stages = 0
        for s in steps:
            name = key_name(s.key)
            replay[name] = replay.get(name, 0) + _dur(s)
        for s in dev:
            if s.name[7:] in stage:
                stage[s.name[7:]] += _dur(s)
                if s.key[0] == "lap":
                    lap_stages += _dur(s)
            elif s.name[7:] in walk:
                walk[s.name[7:]] += _dur(s)
        total = sum(replay.values())
        laps = sum(_dur(s) for s in steps if s.key[0] == "lap")
        gaps = {}
        by_iter = {}
        for s in steps:
            by_iter.setdefault(s.iteration, []).append(s)
        for run in by_iter.values():
            run.sort(key=lambda s: s.start)
            for prev, nxt in zip(run, run[1:]):
                if nxt.start > prev.end:
                    enq = by_id.get(nxt.parent)
                    _gap_split(prev.end, nxt.start, card, enq.end if enq else prev.end,
                               host, starts, gaps)
        own = {}
        for s in host:
            if s.card == card:
                own[s.name] = own.get(s.name, 0) + _dur(s)
        anchors = [_dur(s) for s in dev if s.name == "device.anchor"]
        out[card] = {
            "samples": n,
            "replay_ms": {k: v * ms for k, v in sorted(replay.items())},
            "replay_total_ms": total * ms,
            "lap_ms": laps * ms,
            "stage_ms": {k: v * ms for k, v in stage.items()},
            "walk_ms": {k: v * ms for k, v in walk.items()},
            "lap_unstaged_ms": (laps - lap_stages) * ms,
            "coverage": (lap_stages + total - laps) / total if total else None,
            "gap_ms": {k: v * ms for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])},
            "gap_total_ms": sum(gaps.values()) * ms,
            "host_ms": {k: v * ms for k, v in sorted(own.items())},
            "anchor_us": max(anchors) / 2e3 if anchors else None,
        }
    return {"cards": out}


# -- torch.profiler ---------------------------------------------------------
def _mark(record_function) -> int:
    """A profiler event named CLOCK_MARK whose start is a read of the host's
    clock, after a first event that takes the profiler's first-call cost."""
    with record_function(CLOCK_MARK + ".warm"):
        pass
    with record_function(CLOCK_MARK):
        return time.perf_counter_ns()


def _merge_spans(path: Path, marks: tuple, spans: list) -> None:
    """Add `spans` to Chrome trace `path` as their own process (TRACE_PID):
    the host's spans on thread 0, each card's device spans on thread card +
    1, on the profiler's clock, fitted through the two CLOCK_MARK events
    (each event's start against the host's clock read right after it)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    found = sorted((e for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X"),
                   key=lambda e: e["ts"])
    if len(found) != 2:
        raise RuntimeError(f"the trace holds {len(found)} {CLOCK_MARK} events, not 2")
    (u0, u1), (h0, h1) = [e["ts"] for e in found], marks
    scale = (u1 - u0) / (h1 - h0) if h1 > h0 else 1e-3

    def ts(ns):
        return u0 + (ns - h0) * scale

    tids = sorted({s.card + 1 if s.name.startswith("device.") else 0 for s in spans})
    meta = [{"ph": "M", "name": "process_name", "pid": TRACE_PID, "tid": 0,
             "args": {"name": "pathtracer spans"}}]
    meta += [{"ph": "M", "name": "thread_name", "pid": TRACE_PID, "tid": t,
              "args": {"name": "host" if t == 0 else f"card {t - 1}"}} for t in tids]
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "card": s.card, "iteration": s.iteration,
                "lap": s.lap}
        if s.key is not None:
            args["key"] = key_name(s.key)
        events.append({"ph": "X", "cat": "pathtracer", "name": s.name, "pid": TRACE_PID,
                       "tid": s.card + 1 if s.name.startswith("device.") else 0,
                       "ts": ts(s.start), "dur": (s.end - s.start) * scale, "args": args})
    events.extend(meta)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def device_trace(out_dir: str | None = None):
    """Capture a torch.profiler trace of the block (the CPU, and the card
    when there is one) and write it to `out_dir` (default: pathtracer_trace
    in the temporary directory) as a Chrome trace, trace.json.  With tracing
    on, the trace also carries the program's spans of the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = Path(out_dir or os.path.join(tempfile.gettempdir(), "pathtracer_trace"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tr = TRACER if ON else None
    with profile(activities=activities) as prof:
        marks = (_mark(record_function),) if tr is not None else ()
        yield prof
        if tr is not None:
            marks += (_mark(record_function),)
    prof.export_chrome_trace(str(out / "trace.json"))
    if tr is not None:
        spans = [s for s in tr.spans() if marks[0] <= s.start <= marks[1]]
        _merge_spans(out / "trace.json", marks, spans)
    print(f"profiler trace written to {out}")


def top_ops_from_trace(trace_dir: str, top: int = 20) -> list[tuple[float, str]]:
    """Parse a `device_trace` dir -> [(total_ms, op_name)] hottest first,
    over the device's events: the card's kernels, copies and fills, or, in
    a trace that holds none (a CPU-only run), the CPU's ops."""
    import collections
    import glob
    import gzip

    files = sorted(glob.glob(f"{trace_dir}/**/*.json*", recursive=True), key=os.path.getmtime)
    if not files:
        return []
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e
             and not e.get("name", "").startswith("$")]
    cats = DEVICE_CATEGORIES if any(e.get("cat") in DEVICE_CATEGORIES for e in spans) else ("cpu_op",)
    dur = collections.Counter()
    for e in spans:
        if e.get("cat") in cats:
            dur[e["name"]] += e["dur"]
    return [(d / 1000.0, name) for name, d in dur.most_common(top)]
