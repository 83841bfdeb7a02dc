"""The arithmetic of benchmark/lib/spans.py: the six per-layer metrics, the
gap split and its uncovered share from a segment's summaries made by hand;
nothing to read from a program without the tracer or the counters; and a
segment on the CPU, the Renderer's graph route forced onto its eager steps."""

import functools

import pytest
import torch

from benchmark.lib import cells, spans


def _card(gap: dict, stages: tuple, replays: float) -> dict:
    return {"gap_ms": gap, "gap_total_ms": sum(gap.values()),
            "stage_ms": dict(zip(spans.STAGES, stages)), "replay_total_ms": replays}


def test_metrics_from_summaries():
    """Two cards: each metric the mean over them; graph nodes from the
    window's counters; the gap split by host span, hottest first."""
    m = {"spans": {"summary": {
            0: _card({"live_read": 0.4, "untraced host": 0.2}, (1.0, 10.0, 4.0, 30.0), 46.0),
            1: _card({"live_read": 0.8, "other cards": 0.6}, (3.0, 12.0, 6.0, 32.0), 54.0)}},
         "counts": {0: {"nodes": 3000.0, "replays": 20.0}, 1: {"nodes": 5000.0, "replays": 20.0}}}
    got = spans.metrics(m)
    assert got == pytest.approx({"lap_gap_ms_per_spp": 1.0, "graph_nodes_per_spp": 4000.0,
                                 "sort_ms_per_spp": 2.0, "intersect_ms_per_spp": 11.0,
                                 "nee_ms_per_spp": 5.0, "shade_ms_per_spp": 31.0})
    assert spans.replay_ms_per_spp(m) == pytest.approx(50.0)
    assert spans.lap_gaps(m) == [["live_read", pytest.approx(0.6)],
                                 ["other cards", pytest.approx(0.3)],
                                 ["untraced host", pytest.approx(0.1)]]
    assert spans.uncovered_share(m) == pytest.approx(0.5 * (0.2 / 0.6))


def test_window_counts():
    before = {0: {"nodes": 100, "laps": 9}}
    after = {0: {"nodes": 700, "laps": 27}}
    assert spans.window_counts(before, after, 2) == {0: {"nodes": 300.0, "laps": 9.0}}
    assert spans.window_counts(None, after, 2) is None


def test_nothing_to_read():
    for m in ({}, {"spans": None, "counts": None}, {"spans": {"summary": {}}, "counts": {}}):
        assert all(v is None for v in spans.metrics(m).values())
        assert spans.lap_gaps(m) is None and spans.uncovered_share(m) is None


@pytest.fixture
def eager_graph_route(monkeypatch):
    """The Renderer's graph route on the CPU, its StaticIteration's steps
    eager (as tests/test_torch_graphs.py forces it)."""
    from pathtracer_tpu_torch.integrator import render
    from pathtracer_tpu_torch.integrator.graphs import StaticIteration

    monkeypatch.setattr(render.Renderer, "graph_route", property(lambda self: True))
    monkeypatch.setattr(render, "StaticIteration", functools.partial(StaticIteration, graphs=False))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _renderer():
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    cfg = cells.cell("glasstorus.mis")["config"]
    r = Renderer(cells.ROOT / cfg["scene"], RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(16, 16), trace_depth=3, device="cpu")
    r.set_seed(2**31 + 5)
    r.step(1)
    return r


def test_segment_on_the_cpu(eager_graph_route):
    """The segment's summary holds one card and STEPS samples; the window's
    counters give the laps and nodes a sample (no graph on the CPU: 0
    nodes); the set-up spans are listed."""
    r = _renderer()
    assert spans.prepare(r, 1, lambda: None)
    before = spans.counts(r)
    r.step(2)
    c = spans.window_counts(before, spans.counts(r), 2)
    assert c[0]["laps"] >= 1 and c[0]["nodes"] == 0 and c[0]["replays"] == c[0]["laps"] + 2
    seg = spans.segment(r, 1, lambda: None, steps=3)
    assert seg["steps"] == 3 and seg["dropped"] == 0 and list(seg["summary"]) == [0]
    card = seg["summary"][0]
    assert card["samples"] == 3 and card["replay_total_ms"] > 0
    got = spans.metrics({"spans": seg, "counts": c})
    assert got["lap_gap_ms_per_spp"] > 0 and got["intersect_ms_per_spp"] > 0
    names = [s[0] for s in spans.setup_spans(r)]
    assert names[:3] == ["renderer.init", "scene.load", "bvh.build"] and "renderer.warmup" in names


def test_segment_without_the_tracer(eager_graph_route, monkeypatch):
    """A program whose profiling module has no tracer gives no segment, and
    one without StaticIteration.counts no counters."""
    from pathtracer_tpu_torch.integrator.graphs import StaticIteration
    from pathtracer_tpu_torch.utils import profiling

    r = _renderer()
    monkeypatch.delattr(profiling, "tracing")
    assert spans.segment(r, 1, lambda: None, steps=2) is None
    assert not spans.prepare(r, 1, lambda: None)
    monkeypatch.delattr(StaticIteration, "counts")
    assert spans.counts(r) is None
