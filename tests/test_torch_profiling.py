"""The port's profiling helpers (utils/profiling.py) against the JAX
package's on the same inputs: StageTimer's accounting and report,
RaysPerSecond's window, and top_ops_from_trace on a CPU trace of a small
render iteration."""

import time

import pytest
import torch

from pathtracer_tpu.utils import profiling as jprof
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.utils import profiling as prof
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_render import ROOT


def test_stage_timer_matches_jax():
    """The same stages give the same counts, and the same totals give the
    same report."""
    ours, theirs = prof.StageTimer(), jprof.StageTimer()
    x = torch.ones(4)
    for timer in (ours, theirs):
        for name in ("trace", "shade", "trace"):
            with timer.stage(name):
                time.sleep(0.001)
    with ours.stage("synced", sync=x):
        x = x * 2
    assert ours.counts["trace"] == theirs.counts["trace"] == 2
    assert ours.counts["synced"] == 1
    assert ours.totals["trace"] >= 0.002 and ours.totals["shade"] >= 0.001
    for timer in (ours, theirs):
        timer.totals.clear(), timer.counts.clear()
        timer.totals.update({"a": 0.25, "b": 1.5})
        timer.counts.update({"a": 5, "b": 3})
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[0].startswith("b ")


def test_rays_per_second_matches_jax():
    ours, theirs = prof.RaysPerSecond(window=3), jprof.RaysPerSecond(window=3)
    assert ours.mrays_per_sec == theirs.mrays_per_sec == 0.0
    for dt, rays in ((0.5, 1_000_000), (0.25, 3_000_000), (1.0, 2_000_000), (0.5, 4_000_000)):
        ours.add(dt, rays)
        theirs.add(dt, rays)
        assert ours.mrays_per_sec == pytest.approx(theirs.mrays_per_sec, rel=0, abs=0)
    assert len(ours.samples) == 3
    assert ours.mrays_per_sec == pytest.approx(9.0 / 1.75)


def test_top_ops_from_a_cpu_trace(tmp_path):
    """A device trace of one render iteration on the CPU: the trace file is
    written, and its hottest ops are the CPU's aten ops, hottest first."""
    r = Renderer(ROOT / "scenes" / "cornell_spheres.txt",
                 opts=RenderOptions(sample_mode=SampleMode.MIS), resolution=(16, 16),
                 trace_depth=2, device="cpu")
    r.step(1)
    with prof.device_trace(str(tmp_path)):
        r.step(1)
    assert (tmp_path / "trace.json").stat().st_size > 0
    top = prof.top_ops_from_trace(str(tmp_path), top=10)
    assert 0 < len(top) <= 10
    ms = [t for t, _ in top]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    assert all(name.startswith("aten::") for _, name in top)
    assert prof.top_ops_from_trace(str(tmp_path / "absent")) == []
