"""The port on the streaming route held to the benchmark's plain reference
(`benchmark/reference`), path for path, on the CPU, where the walks run the
plain versions of K3 (closest hit) and K4 (shadow any-hit).

Each case is one run of a benchmark cell through its harness
(`benchmark/lib/harness.run`) at a small film: the Renderer of the cell's
configuration renders its warm-up iteration and one more, and
`benchmark/lib/check.compare` judges the film against `Reference`:

- `glasstorus160k.mis`, the benchmark's 160,000-triangle configuration,
  which streams by the port's own budget (71 blocks), at 16x16;
- `glasstorus.mis` forced onto the streaming tables (`PT_FORCE_STREAM=1`),
  a walk over several blocks, at 32x16.

Tolerance: each compared number at or under the new cell's own limits
(`benchmark/workloads/glasstorus160k.mis.json`).  Both sides draw every
path's random numbers from the same counter stream, so a sound port agrees
path for path up to rounding: the port's walk tests triangles in its own
order over its own BVH while the reference walks a SAH BVH of its own, and
a path whose hit or shadow test a rounding tips differs whole.  The limits
were set between a reference that rounds otherwise (each product rounded
once) and the reference in bfloat16, which fails them; at these films the
port reads 0 on both.
"""

import json

import pytest
import torch

from benchmark.lib import harness
from tests.test_torch_render import ROOT

SEED = 2**31 + 77
LIMITS = json.loads((ROOT / "benchmark" / "workloads" / "glasstorus160k.mis.json").read_text())[
    "limits"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell, film, force", [
    ("glasstorus160k.mis", (16, 16), False),
    ("glasstorus.mis", (32, 16), True),
], ids=["glasstorus160k", "glasstorus-forced"])
def test_stream_route_matches_reference(cell, film, force, monkeypatch):
    if force:
        monkeypatch.setenv("PT_FORCE_STREAM", "1")
    seen = {}

    def route(r):
        seen.update(traversal=r.static.traversal, blocks=r.static.stream_subs)

    m = harness.run(cell, SEED, 0.0, False, device="cpu", resolution=film, hooks=(route,))
    assert seen["traversal"] == "stream" and seen["blocks"] > 1
    assert m["window_samples"] >= 1  # the warm-up iteration and one more
    for name, limit in LIMITS.items():
        assert m["checks"][name] <= limit, (name, m["checks"])
