"""The port's device trace (utils/profiling.py): top_ops_from_trace on a CPU
trace of a small render iteration.  The spans and counters:
tests/test_torch_tracing.py."""

from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.utils import profiling as prof
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_render import ROOT


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
