"""The program's spans and counters (`pathtracer_tpu_torch/utils/profiling.py`,
`integrator/graphs.py`) on the CPU, where a stamp is the host's clock.

- Tracing off: a StaticIteration on a faked card (torch.cuda's calls faked,
  as tests/test_torch_graphs.py fakes them) records no span and stamps
  nothing, captures no traced graph, and keeps one node count per step key
  as before; its captures' set-up spans are recorded all the same.
- Tracing on, the eager steps over the fixed buffers: the image, rays and
  laps bitwise the untraced run's; every replay has its device span, each
  stage span lies inside its step's and a lap's stages sum to no more than
  the lap; no NEE span where the NEE is bypassed (BSDF sampling); the
  ladder's steps down carry their sort; the replays by key sum to the
  replays, and the counts follow from them.
- Two shards in lockstep: one `step`, a `round` a lap holding each card's
  `replay` and `live_read` (and a last one of the steps back up), each
  card's device spans.
- A CPU `device_trace` with tracing on carries the spans, on the
  profiler's clock: each lap's device span encloses the CPU ops run inside
  it, every `aten::sort` lies in a sort stage.
- The summary's arithmetic, the gap split included, on a span list made by
  hand; the Tracer's bound; the Renderer's set-up spans.
"""

import functools
import json

import pytest
import torch

from pathtracer_tpu_torch.integrator import graphs, render
from pathtracer_tpu_torch.integrator.graphs import StaticIteration, run_lockstep
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.utils import profiling
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from pathtracer_tpu_torch.utils.profiling import Span, Tracer, summary, tracing
from tests.test_torch_graphs import SCENES, FakeCuda
from tests.test_torch_schedule import env_ball_scene

RES, DEPTH = 32, 3
STAGE_SPANS = {"device.sort", "device.intersect", "device.nee", "device.shade"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as tests/test_torch_schedule.py."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


def renderer(scene, mode=SampleMode.MIS, res=RES, **options) -> Renderer:
    return Renderer(scene, RenderOptions(sample_mode=mode, packet_rows=1, **options),
                    resolution=(res, res), trace_depth=DEPTH, device="cpu")


def eager(r: Renderer, **kwargs) -> StaticIteration:
    return StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False,
                           **kwargs)


def test_tracing_off_records_nothing(monkeypatch):
    """On a faked card with tracing off: no span in a tracer left in place,
    no stamp, no traced graph; one node count per step key, as before; the
    captures' own spans (graph.capture, eager, instantiate) recorded."""
    r = renderer(SCENES["cornell_spheres"])
    it = eager(r)
    it.graphs, it.device = True, torch.device("cuda", 1)
    FakeCuda(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: 3)
    tr = Tracer()
    monkeypatch.setattr(profiling, "TRACER", tr)

    def no_stamp(*args, **kwargs):
        raise AssertionError("a stamp with tracing off")

    monkeypatch.setattr(profiling, "stamp", no_stamp)
    it.run(r.camera.as_arrays(), 1)
    it.run(r.camera.as_arrays(), 2)
    assert tr.drain() == [] and it.stamps is None
    assert it.nodes == dict.fromkeys(it.step_keys(), 3) and it.traced_nodes == {}
    assert it.num_graphs == len(it.step_keys())
    setup = it.setup.spans()
    caps = [s for s in setup if s.name == "graph.capture"]
    assert [s.key for s in caps] == it.step_keys() and all(s.card == 1 for s in caps)
    for name in ("eager", "instantiate"):
        kids = [s for s in setup if s.name == name]
        assert [by_id(setup)[s.parent].key for s in kids] == it.step_keys()
    assert it.counts()["nodes"] == 3 * it.replays


def by_id(spans) -> dict:
    return {s.id: s for s in spans}


def traced_run(it: StaticIteration, r: Renderer, iteration: int = 1):
    with tracing() as tr:
        out = it.run(r.camera.as_arrays(), iteration)
        return out, tr.drain()


def check_nesting(spans, replays: int) -> dict:
    """Every one of the `replays` replays has one device span under it, each
    stage span lies in its step's (and, in a scene with an environment map,
    the env resolve in the finish step's), a lap's stages sum to no more
    than the lap; returns the stage spans' names by step kind."""
    ids = by_id(spans)
    host = [s for s in spans if s.name == "replay"]
    dev = [s for s in spans if s.name == "device.replay"]
    assert len(host) == len(dev) == replays
    assert sorted(ids[d.parent].id for d in dev) == sorted(h.id for h in host)
    for d in dev:
        assert ids[d.parent].key == d.key and ids[d.parent].lap == d.lap
        h = ids[d.parent]
        assert h.start <= d.start <= d.end <= h.end  # the CPU's steps are synchronous
    kinds = {}
    for d in dev:
        stages = [s for s in spans if s.parent == d.id]
        resolve = [s for s in stages if s.name == "device.env_resolve"]
        assert all(d.key == ("finish",) and d.start <= s.start <= s.end <= d.end for s in resolve)
        stages = [s for s in stages if s not in resolve]
        assert all(s.name in STAGE_SPANS and d.start <= s.start <= s.end <= d.end for s in stages)
        if d.key[0] == "lap":
            assert sum(s.end - s.start for s in stages) <= d.end - d.start
        kinds.setdefault(d.key[0], set()).update(s.name for s in stages)
    return kinds


@pytest.mark.parametrize("case", ["glasstorus-mis", "cornell_spheres-bsdf"])
def test_stage_spans_nest(case):
    """The eager steps with tracing on: bitwise the untraced run; stages
    nest in their laps; BSDF sampling has no NEE span; replays by key sum
    to the replays."""
    scene, mode = case.split("-")
    r = renderer(SCENES[scene], SampleMode[mode.upper()])
    it = eager(r)
    c0, rays0, laps0 = (x.clone() if torch.is_tensor(x) else x for x in it.run(
        r.camera.as_arrays(), 1))
    replays = it.replays
    (c1, rays1, laps1), spans = traced_run(it, r)
    assert torch.equal(c0, c1) and torch.equal(rays0, rays1) and laps0 == laps1
    assert it.replays == 2 * replays == sum(it.key_replays.values())
    kinds = check_nesting(spans, replays)
    want = {"device.intersect", "device.shade"} | {
        "mis": {"device.sort", "device.nee"}, "bsdf": set()}[mode]
    assert kinds["lap"] == want
    assert not (kinds.get("start") or kinds.get("finish"))
    laps = [s for s in spans if s.name == "device.replay" and s.key[0] == "lap"]
    assert [s.lap for s in laps] == list(range(len(laps1)))
    sm = summary(spans)["cards"][0]
    assert sm["samples"] == 1 and 0.9 < sm["coverage"] <= 1.0
    assert sm["replay_total_ms"] == pytest.approx(sum(sm["replay_ms"].values()))


def test_ladder_counts_and_sorts(tmp_path):
    """A scene whose pool shrinks: the steps down carry their sort span, and
    the counts (laps, sorted laps, steps down and up) follow from the
    replays by key, as the iteration's plan made them."""
    r = renderer(env_ball_scene(tmp_path), res=48)
    it = eager(r)
    (_, _, laps), spans = traced_run(it, r)
    c = it.counts()
    assert c["laps"] == len(laps) and c["down"] == c["up"] >= 1 and c["sorted_laps"] == 0
    assert c["replays"] == it.replays == c["laps"] + c["down"] + c["up"] + 2
    kinds = check_nesting(spans, it.replays)
    assert kinds["down"] == {"device.sort"} and kinds["lap"] >= {"device.intersect"}
    assert summary(spans)["cards"][0]["stage_ms"]["sort"] > 0


def test_lockstep_spans_per_card():
    """Two CPU shards in lockstep: one `step` span; a `round` a lap holding
    each going card's `replay` and `live_read`, and a last one of the steps
    back up; each card's device spans."""
    r = renderer(SCENES["cornell_spheres"])
    shards = [eager(r, local_rows=16, pixel0=d * 16 * RES) for d in (0, 1)]
    with tracing() as tr:
        outs = run_lockstep([(it, r.camera.as_arrays(), 1, None) for it in shards])
        spans = tr.drain()
    ids = by_id(spans)
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == 1 and steps[0].iteration == 1
    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == max(len(laps) for _, _, laps in outs) + 1
    for rnd in rounds[:-1]:
        kids = [s for s in spans if s.parent == rnd.id]
        for name in ("replay", "live_read"):
            cards = [s.card for s in kids if s.name == name]
            assert sorted(cards) == sorted(set(cards)) and cards
        assert ids[rnd.parent].name == "step"
    for card, (_, _, laps) in enumerate(outs):
        reads = [s for s in spans if s.name == "live_read" and s.card == card]
        assert len(reads) == len(laps)
    sm = summary(spans)["cards"]
    assert sorted(sm) == [0, 1] and all(v["replay_total_ms"] > 0 for v in sm.values())


def test_device_trace_carries_spans(tmp_path):
    """A CPU device_trace with tracing on: the spans in trace.json, on the
    profiler's clock; each lap's device span encloses the CPU ops that
    start in it; every aten::sort lies in a sort stage."""
    r = renderer(SCENES["glasstorus"], res=16)
    it = eager(r)
    it.run(r.camera.as_arrays(), 1)
    with tracing():
        with profiling.device_trace(str(tmp_path)):
            it.run(r.camera.as_arrays(), 2)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("pid") == profiling.TRACE_PID and e.get("ph") == "X"]
    laps = [e for e in ours if e["name"] == "device.replay" and e["args"]["key"].startswith("lap")]
    sorts = [e for e in ours if e["name"] == "device.sort"]
    assert laps and sorts and {e["name"] for e in ours} >= {"replay", "live_read", "step"}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    slack = 50.0  # us: the two clock marks' events
    for lap in laps:
        a, b = lap["ts"], lap["ts"] + lap["dur"]
        inside = [e for e in ops if a <= e["ts"] <= b]
        assert inside and all(e["ts"] + e["dur"] <= b + slack for e in inside)
    for e in (e for e in ops if e["name"] == "aten::sort"):
        assert any(s["ts"] - slack <= e["ts"] <= s["ts"] + s["dur"] + slack for s in sorts)


def _span(sid, name, start, end, parent=0, card=0, key=None, iteration=1, lap=-1):
    return Span(sid, parent, name, card, start, end, key, iteration, lap)


def test_summary_gap_split():
    """A card's gap between two replays split over the host's spans by
    time: its own live read's wake-up, plan and enqueue, another card's
    work, launch latency after the enqueue returned, untraced host."""
    lap, fin = ("lap", 0, False), ("finish",)
    spans = [
        _span(1, "replay", 0, 1, key=lap, lap=0),
        _span(2, "device.replay", 1, 10, parent=1, key=lap, lap=0),
        _span(3, "device.intersect", 1, 4, parent=2, key=lap, lap=0),
        _span(4, "device.shade", 4, 9, parent=2, key=lap, lap=0),
        _span(5, "live_read", 2, 12, key=lap, lap=0),
        _span(6, "plan", 12, 13),
        _span(7, "replay", 13, 14, card=1, key=lap, lap=0),
        _span(8, "replay", 15, 16, key=fin),
        _span(9, "device.replay", 18, 20, parent=8, key=fin),
        _span(10, "device.anchor", 0, 4),
    ]
    sm = summary([s._replace(start=s.start * 10**6, end=s.end * 10**6) for s in spans])
    c = sm["cards"][0]
    assert c["samples"] == 1 and c["replay_total_ms"] == pytest.approx(11.0)
    assert c["replay_ms"] == pytest.approx({"lap0": 9.0, "finish": 2.0})
    assert c["stage_ms"] == pytest.approx({"sort": 0, "intersect": 3.0, "nee": 0, "shade": 5.0})
    assert c["lap_unstaged_ms"] == pytest.approx(1.0)
    assert c["coverage"] == pytest.approx(10.0 / 11.0)
    assert c["gap_ms"] == pytest.approx({"live_read": 2.0, "plan": 1.0, "other cards": 1.0,
                                         "untraced host": 1.0, "replay": 1.0,
                                         "launch latency": 2.0})
    assert c["gap_total_ms"] == pytest.approx(8.0)
    assert c["host_ms"] == pytest.approx({"replay": 2.0, "live_read": 10.0, "plan": 1.0})
    assert c["anchor_us"] == pytest.approx(2000.0)
    assert summary(spans[:4], samples=2)["cards"][0]["replay_total_ms"] == pytest.approx(4.5e-6)


def test_tracer_bounds_and_nesting():
    """A full Tracer drops and counts; `drain` empties it; open spans are
    the parents of what is added inside them; a root span closes what an
    exception left open; `tracing` restores the state on the way out."""
    tr = Tracer(capacity=4)
    top = tr.open("step", root=True)
    inner = tr.open("round")
    leaf = tr.add("replay", 1, 2, card=0)
    tr.close(inner)
    tr.close(top)
    tr.add("a", 3, 4)
    tr.add("b", 5, 6)
    spans = tr.drain()
    assert [s.name for s in spans] == ["replay", "round", "step", "a"] and tr.dropped == 1
    ids = by_id(spans)
    assert ids[leaf].parent == inner and ids[inner].parent == top and ids[top].parent == 0
    assert tr.drain() == [] and tr.add("c", 7, 8) and len(tr.spans()) == 1
    tr.open("left open")
    again = tr.open("step", root=True)
    tr.close(again)
    assert tr.spans()[-1].parent == 0
    with pytest.raises(RuntimeError):
        with tracing() as t2:
            assert profiling.ON and profiling.TRACER is t2
            raise RuntimeError
    assert not profiling.ON and profiling.TRACER is None


def test_renderer_setup_spans(monkeypatch):
    """The Renderer's set-up spans, tracing or not: renderer.init with the
    scene's load, build and upload inside it, then the warm-up (the
    iteration compile_seconds times) after it."""
    monkeypatch.setattr(Renderer, "graph_route", property(lambda self: True))
    monkeypatch.setattr(render, "StaticIteration", functools.partial(StaticIteration, graphs=False))
    r = renderer(SCENES["glasstorus"], res=16)
    r.step(2)
    spans = r.setup.spans()
    names = [s.name for s in spans]
    assert names == ["scene.load", "bvh.build", "tables.upload", "renderer.init", "renderer.warmup"]
    init, warm = spans[3], spans[4]
    assert all(s.parent == init.id and init.start <= s.start <= s.end <= init.end
               for s in spans[:3])
    assert warm.parent == 0 and warm.start >= init.end
    assert (warm.end - warm.start) / 1e9 == pytest.approx(r.stats.compile_seconds, abs=0.01)
    assert r.stats.kernel_builds == 0 and r.compiled_iterations() == [r.graphs]


@pytest.mark.parametrize("route", ["stream", "resident"])
def test_stream_tables_span(route, monkeypatch):
    """`stream.tables` lies inside `bvh.build` on a streamed mesh (glasstorus
    forced onto the streaming tables) and is absent on a resident one;
    `StaticIteration.tables()` gives the streaming tables' shape, zeros on
    the resident route."""
    if route == "stream":
        monkeypatch.setenv("PT_FORCE_STREAM", "1")
    r = renderer(SCENES["glasstorus"], res=16)
    spans = r.setup.spans()
    ids = by_id(spans)
    stream = [s for s in spans if s.name == "stream.tables"]
    t = eager(r).tables()
    assert t["traversal"] == route == r.static.traversal
    if route == "resident":
        assert stream == [] and t == {"traversal": "resident", "stream_subs": 0,
                                      "stream_sub_nodes": 0, "stream_sub_tris": 0,
                                      "stream_table_bytes": 0}
        return
    (s,) = stream
    build = ids[s.parent]
    assert build.name == "bvh.build" and build.start <= s.start <= s.end <= build.end
    assert t["stream_subs"] == r.static.stream_subs > 1
    assert (t["stream_sub_nodes"], t["stream_sub_tris"]) == (r.static.stream_sub_nodes,
                                                            r.static.stream_sub_tris)
    # the streaming tables hold each block's triangles, 48 bytes a row in subt12
    assert t["stream_table_bytes"] >= t["stream_subs"] * t["stream_sub_tris"] * 48


@pytest.mark.parametrize("case", ["resident-mis", "stream-mis", "stream-bsdf"])
def test_walk_spans_nest(case, monkeypatch):
    """With tracing on, each lap's triangle walk has its span inside its
    stage: `device.walk_closest` in `device.intersect` and
    `device.walk_shadow` in `device.nee`, one of each a lap (none of the
    shadow walk under BSDF sampling); the image bitwise the untraced run's;
    the summary's walk ms no more than their stages'."""
    route, mode = case.split("-")
    if route == "stream":
        monkeypatch.setenv("PT_FORCE_STREAM", "1")
    r = renderer(SCENES["glasstorus"], SampleMode[mode.upper()])
    assert r.static.traversal == route
    it = eager(r)
    c0 = it.run(r.camera.as_arrays(), 1)[0].clone()
    (c1, _, laps), spans = traced_run(it, r)
    assert torch.equal(c0, c1)
    ids = by_id(spans)
    for name, stage in (("device.walk_closest", "device.intersect"),
                        ("device.walk_shadow", "device.nee")):
        walks = [s for s in spans if s.name == name]
        assert len(walks) == (len(laps) if mode == "mis" or stage == "device.intersect" else 0)
        for w in walks:
            p = ids[w.parent]
            assert p.name == stage and p.start <= w.start <= w.end <= p.end
            assert (p.key, p.lap, p.iteration) == (w.key, w.lap, w.iteration)
    sm = summary(spans)["cards"][0]
    assert 0 < sm["walk_ms"]["walk_closest"] <= sm["stage_ms"]["intersect"]
    assert sm["walk_ms"]["walk_shadow"] <= sm["stage_ms"]["nee"]
    assert (sm["walk_ms"]["walk_shadow"] > 0) == (mode == "mis")


def test_tracing_off_stamps_no_walk(monkeypatch):
    """A streamed mesh on a faked card with tracing off: the lap steps,
    whose traced graphs stamp around the walks, stamp nothing, capture no
    traced graph and keep one node count per step key."""
    monkeypatch.setenv("PT_FORCE_STREAM", "1")
    r = renderer(SCENES["glasstorus"])
    it = eager(r)
    it.graphs, it.device = True, torch.device("cuda", 1)
    FakeCuda(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: 3)

    def no_stamp(*args, **kwargs):
        raise AssertionError("a stamp with tracing off")

    monkeypatch.setattr(profiling, "stamp", no_stamp)
    it.run(r.camera.as_arrays(), 1)
    assert it.stamps is None and it.traced_nodes == {}
    assert it.nodes == dict.fromkeys(it.step_keys(), 3)
