"""The spans and the counter of the sky's work (utils/profiling.py,
integrator/wavefront.py, integrator/render.py RenderStats.env_lanes), on the
CPU, where a stamp is the host's clock and the compiled iteration's steps
run eagerly over its buffers.  The scenes are the benchmark's: envtorus
(the gold torus under the 2048 x 1024 sky, MIS with the sky sampled as a
light) and glasstorus (a closed box with a sphere lamp, no sky).

- Traced, envtorus has one `device.env_light` inside the `device.nee` of
  every lap (each lap the plan runs has live lanes), and one
  `device.env_resolve` inside the finish step's `device.replay`; glasstorus
  has neither.
- Untraced, each step dispatches the ops it dispatched before the spans and
  the counter were added (the CPU's counterpart of a graph's nodes), except
  the counter's own three in envtorus: its zero in the start step, its sum
  and add in the finish step.
- `RenderStats.env_lanes` counts the lanes that cashed sky radiance in the
  booked iterations: the lanes each bounce flagged as escaped, with and
  without ray regeneration; the eager loop's and the compiled iteration's
  counts agree, two shards count what one pool counts; 0 in glasstorus.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pathtracer_tpu_torch.integrator import wavefront
from pathtracer_tpu_torch.integrator.graphs import StaticIteration
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.utils import profiling
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_render import ROOT

SCENES = ROOT / "benchmark" / "configs" / "scenes"
RES, DEPTH, SEED = 16, 8, 3
ENV_SPANS = {"device.env_light", "device.env_resolve"}
# The ops each untraced step dispatched before this counter and these spans
# (16x16, depth 8, seed 3, iteration 2, MIS; envtorus with env_importance):
# by step key, the distinct counts of its runs.  A lap's count follows its
# live lanes (the CPU's plain walks), a graph's does not.
BEFORE = {
    "glasstorus": {("start",): [246], ("finish",): [4],
                   ("lap", 0, True): [22996, 30553, 33160, 33886, 34251, 34557, 34747, 39125]},
    "envtorus": {("start",): [246], ("finish",): [285],
                 ("lap", 0, True): [20483, 23554], ("lap", 0, False): [5532, 15270, 20645]},
}
COUNTER = {"envtorus": {("start",): 1, ("finish",): 2}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def renderer(name: str, devices=None, **options) -> Renderer:
    opts = RenderOptions(sample_mode=SampleMode.MIS, env_importance=name == "envtorus", **options)
    r = Renderer(SCENES / f"{name}.txt", opts, resolution=(RES, RES), trace_depth=DEPTH,
                 devices=devices, device="cpu")
    r.set_seed(SEED)
    return r


def iteration(r: Renderer) -> StaticIteration:
    """The compiled iteration's steps, eagerly, after its first run."""
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    it.run(r.camera.as_arrays(), 1)
    return it


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["envtorus", "glasstorus"])
def test_env_spans(name):
    r = renderer(name)
    it = iteration(r)
    with profiling.tracing() as tr:
        _, _, laps = it.run(r.camera.as_arrays(), 2)
        spans = tr.drain()
    ids = {s.id: s for s in spans}
    env = [s for s in spans if s.name in ENV_SPANS]
    env_ms = profiling.summary(spans)["cards"][0]["env_ms"]
    if name == "glasstorus":
        assert not env and not any(env_ms.values())
        return
    lights = [s for s in env if s.name == "device.env_light"]
    assert laps and all(n > 0 for n in laps)
    assert sorted(s.lap for s in lights) == list(range(len(laps)))
    for s in lights:
        nee = ids[s.parent]
        assert nee.name == "device.nee" and nee.lap == s.lap and nee.key[0] == "lap"
        assert nee.start <= s.start <= s.end <= nee.end
    (resolve,) = [s for s in env if s.name == "device.env_resolve"]
    step = ids[resolve.parent]
    assert step.name == "device.replay" and step.key == ("finish",)
    assert step.start <= resolve.start <= resolve.end <= step.end
    assert env_ms["env_light"] > 0 and env_ms["env_resolve"] > 0


@pytest.mark.parametrize("name", ["envtorus", "glasstorus"])
def test_untraced_steps_keep_their_ops(name):
    r = renderer(name)
    it = iteration(r)
    body, counts = it._body, {}

    def counted(key, traced=False):
        run = body(key, traced)

        def step():
            with _Count() as c:
                run()
            counts.setdefault(key, set()).add(c.n)
        return step

    it._body = counted
    it.run(r.camera.as_arrays(), 2)
    added = COUNTER.get(name, {})
    want = {key: [n + added.get(key, 0) for n in ns] for key, ns in BEFORE[name].items()}
    assert {key: sorted(ns) for key, ns in counts.items()} == want


def _escapes(monkeypatch) -> list:
    """The lanes each bounce flags as escaped to the sky, summed into the
    list's one entry."""
    bounce, seen = wavefront.bounce, [0]

    def counted(*args, **kwargs):
        s = args[6]
        out, rays = bounce(*args, **kwargs)
        seen[0] += int((out.env_miss & ~s.env_miss).sum())
        return out, rays

    monkeypatch.setattr(wavefront, "bounce", counted)
    return seen


@pytest.mark.parametrize("regen", [0, 3], ids=["classic", "regen3"])
def test_env_lanes_counts_the_escapes(regen, monkeypatch):
    r = renderer("envtorus", ray_regen=regen)
    r.step(1)  # the warm-up iteration, not booked
    assert r.stats.env_lanes == 0
    seen = _escapes(monkeypatch)
    r.step(3)
    assert r.stats.env_lanes == seen[0] > 0


def test_env_lanes_match_the_compiled_iteration(monkeypatch):
    """The Renderer's eager loop and the compiled iteration's steps count
    the same lanes, those the finish step found escaped."""
    r = renderer("envtorus")
    r.step(2)
    it = iteration(r)
    it.run(r.camera.as_arrays(), 2)
    finish, finished = wavefront.finish, {}

    def keep(spec, s, mark=None):
        finished["n"] = int(s.env_miss.sum())
        return finish(spec, s, mark)

    monkeypatch.setattr(wavefront, "finish", keep)
    wavefront.render_iteration(r.flat, r.static, r.opts, r._cam_arrays(), r.key, 2,
                               pixel_xy=r.pixel_xy)
    assert r.stats.env_lanes == int(it.env_lanes) == finished["n"] > 0


def test_env_lanes_zero_without_a_sky():
    r = renderer("glasstorus")
    r.step(2)
    assert r.stats.rays_traced > 0 and r.stats.env_lanes == 0


def test_env_lanes_sharded_as_one_card():
    """Two CPU shards count the lanes one pool counts (the swizzle off, as a
    sharded renderer turns it off)."""
    counts = []
    for devices in (None, 2):
        r = renderer("envtorus", devices=devices, swizzle=False)
        r.step(3)
        counts.append((r.stats.rays_traced, r.stats.env_lanes))
    assert counts[0] == counts[1] and counts[0][1] > 0
