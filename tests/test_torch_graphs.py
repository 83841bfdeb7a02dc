"""The Renderer's compiled iteration (`pathtracer_tpu_torch/integrator/graphs.py`)
on the CPU, where no graph is captured: its steps run eagerly over the same
fixed buffers the card's graphs hold.

- Capture cleanliness: each step of `StaticIteration.step_keys()` runs once
  under a dispatch mode that raises on what a CUDA graph cannot hold (a
  value read back to the host, `nonzero`, a tensor made from host data,
  `masked_select`, boolean indexing).  K1-K5 are stubbed as opaque calls of
  the right shapes, since their plain versions use `nonzero` and the
  card's kernels do not.
- The static-buffer loop (`StaticIteration(graphs=False).run`) against the
  eager loop (`wavefront.render_iteration`), bit for bit: contributions,
  rays and the pool's length at each lap, over two iterations (the second
  a batch of 3 under regeneration); the loop passes the iteration and lap
  index as 0-d tensors where the eager loop passes ints.
- Cases: cornell_spheres, glasstorus (K1/K2), texcube, envtorus with
  env_importance, a 576-triangle torus forced onto the stream tables
  (K3/K4, as tests/test_torch_stream.py forces it), glasstorus with
  ray_regen=3, cornell_spheres in DIRECT_LI; 64x64, depth 4, MIS unless
  named, `packet_rows=1` so that the shrink ladder has levels to take.
- The Renderer on its graph route (forced on the CPU, the steps eager)
  against the JAX Renderer's jitted iteration on the 576-triangle torus box,
  as tests/test_torch_render.py holds the eager route, and bit for bit
  against its own eager route.
- The cache key changes with the options, the seed, the route flag (on the
  streaming tables, where it switches K3 for K5), the film and
  regeneration; the route rule; no graphs off CUDA.
- The launch table (ops/_build.py): one entry point a tag, `launch_counts`
  K1-K5's counts from it in order; this module imports no kernel module.
- Capture and replay on the buffers' card: with torch.cuda's calls faked,
  every capture and replay of a renderer on a second card runs with that
  card current and a capture stream of it; a graph with no node raises.
- A shard's pool: `StaticIteration(local_rows, pixel0, graphs=False)` bit
  for bit `render_iteration(..., pixel0, local_rows)`, rows past the film
  included; the key changes with the pool's rows.
- `lap_plan` driven by hand makes `drive_laps`'s decisions, and the JAX
  package's ladder rule's (tests/test_torch_schedule.py expected_pools), on
  the ladders of tests/test_torch_schedule.py.
- Lockstep on two cards, faked: `run_lockstep` over shards on cuda:0 and
  cuda:1 captures and replays each shard's steps with its card current, on
  a stream of it, and issues every shard's lap of a round before the first
  live-count read of that round; a shard whose capture fails raises
  GraphError naming its card and step.
- The step factory on the card, faked: one StaticIteration per device and
  first pixel, kept across calls with the same key and made anew for
  another; results that a later call does not overwrite.
"""

import ast
import contextlib
import dataclasses
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pathtracer_tpu_torch.integrator import graphs, render
from pathtracer_tpu_torch.integrator.graphs import StaticIteration, graph_key
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.integrator import wavefront
from pathtracer_tpu_torch.integrator.wavefront import Schedule, render_iteration
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu_torch.scene import flatscene as tfs
from pathtracer_tpu_torch.utils import rng
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_render import jax_reference, render_and_compare, small_torus_scene
from tests.test_torch_schedule import expected_pools
from tests.test_torch_stream import force_stream
from tools.make_texture_assets import ensure_texture_assets

ROOT = Path(__file__).resolve().parent.parent
RES, DEPTH, REGEN_K = 64, 4, 3
SCENES = {"cornell_spheres": ROOT / "scenes" / "cornell_spheres.txt",
          "glasstorus": ROOT / "scenes" / "glasstorus.txt",
          "texcube": ROOT / "scenes" / "texcube.txt",
          "envtorus": ROOT / "scenes" / "envtorus.txt"}
# case: (scene, RenderOptions besides MIS and packet_rows=1, the kernels it routes to)
CASES = {
    "cornell_spheres": ("cornell_spheres", {}, ()),
    "glasstorus": ("glasstorus", {}, ("closest_hit_wbvh", "occlusion_wbvh")),
    "texcube": ("texcube", {}, ("closest_hit_wbvh", "occlusion_wbvh")),
    "envtorus-env_importance": ("envtorus", {"env_importance": True},
                                ("closest_hit_wbvh", "occlusion_wbvh")),
    "stream": ("torus576", {}, ("closest_hit_stream", "occlusion_stream")),
    "ray_regen": ("glasstorus", {"ray_regen": REGEN_K}, ("closest_hit_wbvh", "occlusion_wbvh")),
    "direct_li": ("cornell_spheres", {"sample_mode": SampleMode.DIRECT_LI}, ()),
}
KERNELS = ("closest_hit_wbvh", "occlusion_wbvh", "closest_hit_stream", "occlusion_stream",
           "closest_hit_blockmajor")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as tests/test_torch_schedule.py."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def torus576(tmp_path_factory):
    return small_torus_scene(tmp_path_factory.mktemp("graphs"))


def make_renderer(case: str, torus576) -> Renderer:
    scene, options, _ = CASES[case]
    options = {"sample_mode": SampleMode.MIS, "packet_rows": 1, **options}
    if scene == "torus576":
        with pytest.MonkeyPatch.context() as mp:
            force_stream(mp, tfs)
            r = Renderer(torus576, RenderOptions(**options), resolution=(RES, RES),
                         trace_depth=DEPTH, device="cpu")
        assert ttv.walk_route(r.static, r.opts).kind == "stream" and r.static.stream_subs > 1
        return r
    if scene in ("texcube", "envtorus"):
        ensure_texture_assets()
    return Renderer(SCENES[scene], RenderOptions(**options), resolution=(RES, RES),
                    trace_depth=DEPTH, device="cpu")


class CaptureAudit(TorchDispatchMode):
    """Raises on an op a CUDA graph cannot hold, naming the step."""

    FORBIDDEN = {"_local_scalar_dense", "nonzero", "lift_fresh", "lift_fresh_copy",
                 "masked_select", "equal"}
    INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __init__(self, step):
        super().__init__()
        self.step = step

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.FORBIDDEN:
            raise AssertionError(f"step {self.step} calls {func}, which a graph cannot hold")
        if name in self.INDEXING and any(i is not None and i.dtype == torch.bool
                                         for i in args[1]):
            raise AssertionError(f"step {self.step} indexes with a boolean mask ({func})")
        return func(*args, **(kwargs or {}))


def _stub(name: str, calls: dict):
    """An opaque K1-K5 of the right shapes: no triangle is hit, no ray
    blocked beyond occluded0."""
    def closest(*args, **_):
        calls[name] += 1
        t_init = args[-1]
        return (t_init.clone(), torch.full_like(t_init, -1, dtype=torch.int32),
                torch.zeros_like(t_init), torch.zeros_like(t_init))

    def occlusion(*args, **_):
        calls[name] += 1
        return args[-1].clone()

    return occlusion if name.startswith("occlusion") else closest


@pytest.mark.parametrize("case", CASES)
def test_steps_capture_clean(case, torus576, monkeypatch):
    """Every step a schedule can reach, run once as `prepare` runs them
    before their capture, calls nothing a CUDA graph cannot hold."""
    r = make_renderer(case, torus576)
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        monkeypatch.setattr(ttv, name, _stub(name, calls))
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy,
                         regen=bool(r.regen_k), graphs=False)
    it.set_inputs(r._cam_arrays(), 1, REGEN_K if r.regen_k else None)
    keys = it.step_keys()
    for key in keys:
        with CaptureAudit(key):
            it.replay(key)
    used = CASES[case][2]
    assert {k for k, n in calls.items() if n} == set(used), calls
    kinds = {key[0] for key in keys}
    assert {"start", "lap", "finish"} <= kinds
    if it.spec.sched.shrink:
        assert {"down", "up"} <= kinds


@pytest.mark.parametrize("case", CASES)
def test_static_loop_matches_eager(case, torus576):
    """The host loop over the steps on fixed buffers gives render_iteration's
    contributions, rays and laps bit for bit, twice in a row."""
    r = make_renderer(case, torus576)
    regen = bool(r.regen_k)
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, regen=regen,
                         graphs=False)
    cam = r._cam_arrays()
    for iteration, nk in ((1, 1), (2, REGEN_K)):
        nk = nk if regen else None
        want, want_rays, want_laps = render_iteration(r.flat, r.static, r.opts, cam, r.key,
                                                      iteration, pixel_xy=r.pixel_xy, nk=nk)
        got, rays, laps = it.run(cam, iteration, nk)
        assert laps == want_laps, (laps, want_laps)
        assert int(rays) == int(want_rays) > 0
        assert torch.equal(got, want), f"{case} iteration {iteration}"
        assert float(got.abs().sum()) > 0
    if case == "envtorus-env_importance":
        assert len(set(laps)) > 1, f"the ladder did not fire: {laps}"


def test_renderer_graph_route_matches_jax(torus576, monkeypatch):
    """The Renderer through its graph route's steps (eager here) against the
    JAX Renderer's jitted iteration, within the slice tolerance, and bit for
    bit against the Renderer's eager route."""
    eager = Renderer(torus576, RenderOptions(sample_mode=SampleMode.MIS), resolution=(RES, RES),
                     trace_depth=DEPTH, device="cpu")
    eager.set_seed(0)
    eager.step(2)
    assert not eager.graph_route and eager.graphs is None
    monkeypatch.setattr(Renderer, "graph_route", property(lambda self: True))
    monkeypatch.setattr(render, "StaticIteration", functools.partial(StaticIteration, graphs=False))
    port = render_and_compare(torus576, SampleMode.MIS, ref=jax_reference(torus576, "MIS"))
    assert isinstance(port.graphs, StaticIteration)
    assert np.array_equal(port.hdr_sum(), eager.hdr_sum())
    assert port.stats.rays_traced == eager.stats.rays_traced
    assert port.lap_pools == eager.lap_pools and port.traced_depth == eager.traced_depth


def _key(r: Renderer) -> tuple:
    return graph_key(r.static, r.opts, r.key, r.pixel_xy, bool(r.regen_k))


CHANGES = {
    "options": lambda r, mp: setattr(r, "opts", dataclasses.replace(r.opts, compaction=False)),
    "seed": lambda r, mp: r.set_seed(1),
    "route flag": lambda r, mp: mp.setattr(ts, "STREAM_BLOCKMAJOR", not ts.STREAM_BLOCKMAJOR),
    "film": lambda r, mp: setattr(r, "pixel_xy", None),
    "regeneration": lambda r, mp: setattr(r, "opts", dataclasses.replace(r.opts, ray_regen=4)),
}


@pytest.mark.parametrize("change", CHANGES)
def test_graph_key_changes(change, torus576, monkeypatch):
    """What a capture bakes in is in the key: a change drops the graphs.
    The route flag changes the walk on the streaming tables alone."""
    if change == "route flag":
        r = make_renderer("stream", torus576)
    else:
        r = Renderer(torus576, RenderOptions(sample_mode=SampleMode.MIS), resolution=(RES, RES),
                     trace_depth=DEPTH, device="cpu")
    before = _key(r)
    assert _key(r) == before
    CHANGES[change](r, monkeypatch)
    assert _key(r) != before


def test_graph_key_changes_with_film_size(torus576):
    keys = {_key(Renderer(torus576, RenderOptions(), resolution=res, trace_depth=DEPTH,
                          device="cpu")) for res in ((RES, RES), (RES, RES // 2))}
    assert len(keys) == 2


ROUTES = {
    "analytic": ("cornell_spheres", {}, True),
    "kernels": ("glasstorus", {}, True),
    "pallas_traversal=False": ("glasstorus", {"pallas_traversal": False}, False),
    "use_bvh=False": ("glasstorus", {"use_bvh": False}, False),
    "analytic, use_bvh=False": ("cornell_spheres", {"use_bvh": False}, True),
}


@pytest.mark.parametrize("route", ROUTES)
def test_graph_route(route):
    """A one-device CUDA Renderer replays graphs where the JAX Renderer runs
    its jitted iteration; a triangle scene off the kernels runs eagerly, as
    the JAX Renderer runs it staged; the CPU always runs eagerly."""
    scene, options, want = ROUTES[route]
    r = Renderer(SCENES[scene], RenderOptions(**options), resolution=(32, 32), trace_depth=2,
                 device="cpu")
    assert not r.graph_route
    r.device = torch.device("cuda")  # the rule alone: nothing runs
    assert r.graph_route is want


def test_launch_table():
    """One entry point a tag, each a C entry point of the kernels; K1-K5
    first, then S1, S2, M1, M2, L1, L2, P1, P2.  `launch_counts` reads K1-K5
    from the table in order, and the compiled iteration imports none of the
    kernels' modules: their launches reach it through the table alone."""
    assert tuple(_build.LAUNCHES) == ("K1", "K2", "K3", "K4", "K5", "S1", "S2", "M1", "M2",
                                      "L1", "L2", "P1", "P2")
    entries = list(_build.LAUNCHES.values())
    assert len(set(entries)) == len(entries) and set(entries) <= set(_build.ARGTYPES)
    was = dict(_build.launches)
    try:
        _build.launches.update(K1=1, K2=2, K3=3, K4=4, K5=5, S1=6, M1=7, P2=8)
        assert graphs.launch_counts() == (1, 2, 3, 4, 5)
    finally:
        _build.launches.update(was)
    imported = set()
    for node in ast.walk(ast.parse(Path(graphs.__file__).read_text())):
        if isinstance(node, ast.ImportFrom):
            imported |= {node.module or ""} | {a.name for a in node.names}
        elif isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
    kernel_modules = {"traverse_cuda", "traverse_stream_cuda", "sweep_cuda", "shade_cuda",
                      "lights_cuda", "probes"}
    assert not {name.rsplit(".", 1)[-1] for name in imported} & kernel_modules


def test_launch_counts_the_tag(monkeypatch):
    """`_build.launch` with the library faked: a counted entry point adds
    one under its tag, the M1 draw under none, and a CUDA error raises with
    the launch's name."""
    calls = []

    def entry(rc):
        return lambda *args: calls.append(args) or rc

    lib = types.SimpleNamespace(pt_sweep_closest=entry(0), pt_scatter_draw=entry(0),
                                pt_eval_lobes=entry(2),
                                pt_error_string=lambda rc: b"out of memory")
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    t = torch.zeros(4)
    _build.launch("pt_sweep_closest", "cuda:0", t, 5, None)
    assert calls == [(t.data_ptr(), 5, None, 77)]
    _build.launch("pt_scatter_draw", "cuda:0", t)
    assert _build.launches == dict(dict.fromkeys(_build.LAUNCHES, 0), S1=1)
    with pytest.raises(RuntimeError, match=r"eval_lobes launch: CUDA error 2 \(out of memory\)"):
        _build.launch("pt_eval_lobes", "cuda:0", t)
    assert _build.launches["M2"] == 0


def test_graphs_need_cuda():
    r = Renderer(SCENES["cornell_spheres"], RenderOptions(), resolution=(32, 32), trace_depth=2,
                 device="cpu")
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.StaticIteration(r.flat, r.static, r.opts, r.key)


class FakeCuda:
    """torch.cuda's calls of a capture and a replay, on a machine without a
    card: each records the device current when it is called; a capture runs
    its body, a replay nothing."""

    def __init__(self, monkeypatch):
        self.current = 0
        self.log = []
        for name in ("device", "Stream", "graph_pool_handle", "synchronize", "graph"):
            monkeypatch.setattr(torch.cuda, name, getattr(self, name))
        monkeypatch.setattr(torch.cuda, "CUDAGraph", self.make_graph)

    @contextlib.contextmanager
    def device(self, dev):
        was, self.current = self.current, torch.device(dev).index
        try:
            yield
        finally:
            self.current = was

    def Stream(self, dev):
        return types.SimpleNamespace(device=torch.device(dev))

    def graph_pool_handle(self):
        self.log.append(("pool", self.current))
        return object()

    def synchronize(self, dev=None):
        pass

    @contextlib.contextmanager
    def graph(self, g, pool=None, stream=None, capture_error_mode="global"):
        self.log.append(("capture", self.current, stream.device, capture_error_mode))
        yield

    def make_graph(self, keep_graph=False):
        fake = self
        assert keep_graph  # the nodes are counted before instantiation

        class Graph:
            def instantiate(self):
                pass

            def replay(self):
                fake.log.append(("replay", fake.current))

        return Graph()


def _on_second_card(monkeypatch, nodes: int):
    """A StaticIteration of a small cornell_spheres whose buffers claim to lie
    on cuda:1, with torch.cuda faked and every graph holding `nodes` nodes."""
    r = Renderer(SCENES["cornell_spheres"], RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(32, 32), trace_depth=2, device="cpu")
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    it.graphs, it.device = True, torch.device("cuda", 1)
    fake = FakeCuda(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: nodes)
    return r, it, fake


def test_capture_and_replay_on_the_buffers_card(monkeypatch):
    """With cuda:0 current, a renderer on cuda:1 captures every step on a
    stream of cuda:1 with cuda:1 current, and replays them there."""
    r, it, fake = _on_second_card(monkeypatch, nodes=3)
    it.run(r._cam_arrays(), 1)
    captures = [e for e in fake.log if e[0] == "capture"]
    replays = [e for e in fake.log if e[0] == "replay"]
    assert len(captures) == it.num_graphs == len(it.step_keys())
    assert all(e[1:] == (1, torch.device("cuda", 1), "thread_local") for e in captures), captures
    assert ("pool", 1) in fake.log and fake.current == 0
    assert replays and all(e[1] == 1 for e in replays) and len(replays) == it.replays
    assert it.nodes == dict.fromkeys(it.step_keys(), 3)


def test_capture_of_no_node_raises(monkeypatch):
    """A step whose graph holds no node (its work ran elsewhere) is refused,
    by name, before any replay."""
    r, it, fake = _on_second_card(monkeypatch, nodes=0)
    with pytest.raises(graphs.GraphError, match=r"capture of step \('start',\) on cuda:1 failed: "
                                                r"the graph holds no node"):
        it.run(r._cam_arrays(), 1)
    assert not [e for e in fake.log if e[0] == "replay"]


# case: (CASES entry, local_rows, first row): rows 16-31; the last 8 rows and
# 8 padding rows past the film; a regeneration batch over rows 40-55
SHARD_POOLS = {"cornell_spheres": ("cornell_spheres", 16, 16),
               "glasstorus, past the film": ("glasstorus", 16, 56),
               "ray_regen": ("ray_regen", 16, 40)}


@pytest.mark.parametrize("pool", SHARD_POOLS)
def test_shard_pool_matches_eager(pool, torus576):
    """A StaticIteration over `local_rows` rows from `pixel0` gives
    render_iteration's contributions, rays and laps over the same rows bit
    for bit, twice in a row."""
    case, rows, row0 = SHARD_POOLS[pool]
    r = make_renderer(case, torus576)
    r.pixel_xy = None  # a shard's lanes are its pixels, as a sharded renderer's
    regen = bool(r.regen_k)
    pixel0 = row0 * RES
    it = StaticIteration(r.flat, r.static, r.opts, r.key, regen=regen, graphs=False,
                         local_rows=rows, pixel0=pixel0)
    assert it.n == rows * RES and it.spec.pixel0 == pixel0
    cam = r._cam_arrays()
    for iteration, nk in ((1, 1), (2, REGEN_K)):
        nk = nk if regen else None
        want, want_rays, want_laps = render_iteration(r.flat, r.static, r.opts, cam, r.key,
                                                      iteration, nk=nk, pixel0=pixel0,
                                                      local_rows=rows)
        got, rays, laps = it.run(cam, iteration, nk)
        assert got.shape == (rows * RES, 3)
        assert laps == want_laps and int(rays) == int(want_rays) > 0
        assert torch.equal(got, want), f"{pool} iteration {iteration}"


def test_graph_key_changes_with_the_pool(torus576):
    """A capture is never replayed for another shard's rows."""
    r = Renderer(torus576, RenderOptions(), resolution=(RES, RES), trace_depth=DEPTH,
                 device="cpu")
    keys = {graph_key(r.static, r.opts, r.key, None, False, rows, pixel0)
            for rows, pixel0 in ((None, 0), (32, 0), (32, 32 * RES), (16, 32 * RES))}
    assert len(keys) == 4
    assert graph_key(r.static, r.opts, r.key, None, False) == graph_key(
        r.static, r.opts, r.key, None, False, None, 0)


# the ladders of tests/test_torch_schedule.py test_ladder_runs, sorted and not
PLANS = {
    "sorted, two levels": (Schedule(True, False, 1, ((1024, 4), (256, 4))), 4096),
    "sort_every=2, half level": (Schedule(True, True, 2, ((2048, 2), (512, 4), (128, 4))), 4096),
    "analytic, two levels": (Schedule(False, False, 1, ((1024, 4), (256, 4))), 4096),
    "no ladder": (Schedule(True, False, 3, ()), 4096),
}
# live counts after each lap; the plan stops at 0 or at the budget
LIVES = {"dwindling": [3900, 2600, 1100, 700, 240, 90, 20, 3, 0],
         "stays alive": [4000, 3900, 3800, 3700, 3600, 3500, 3400],
         "dies at once": [0]}


@pytest.mark.parametrize("lives", LIVES)
@pytest.mark.parametrize("plan", PLANS)
def test_lap_plan_by_hand(plan, lives):
    """lap_plan sent each lap's live count by hand: drive_laps's decisions
    and return value; its pools those of the JAX package's ladder rule, its
    sorts the sort rule, every step down just before the first lap on the
    smaller pool, the steps back up last, in reverse."""
    sched, n = PLANS[plan]
    live, budget = LIVES[lives], 7
    steps, it, reply = [], wavefront.lap_plan(sched, n, budget), None
    while True:
        try:
            step = it.send(reply)
        except StopIteration as done:
            laps = done.value
            break
        steps.append(step)
        reply = live[sum(s[0] == "lap" for s in steps) - 1] if step[0] == "lap" else None

    seen, feed = [], iter(live)

    def lap(level, depth, sort):
        seen.append(("lap", level, depth, sort))
        return next(feed)

    assert wavefront.drive_laps(sched, n, budget, lap, lambda lv: seen.append(("down", lv)),
                                lambda lv: seen.append(("up", lv))) == laps
    assert seen == steps
    lap_steps = [s for s in steps if s[0] == "lap"]
    assert len(laps) == len(lap_steps) == min(budget, live.index(0) + 1 if 0 in live else budget)
    assert [s[2] for s in lap_steps] == list(range(len(laps)))
    assert laps == expected_pools(n, sched.shrink, live[:len(laps)])
    alive = [n] + live
    pools = [n] + [size for size, _ in sched.shrink]
    for depth, (_, level, _, sort) in enumerate(lap_steps):
        assert laps[depth] == pools[level]
        assert sort == (sched.sort_rays and (depth == 0 or (depth % sched.sort_every == 0 and
                                                            alive[depth] * 4 > laps[depth])))
    levels = max((s[1] for s in lap_steps), default=0)
    downs = [i for i, s in enumerate(steps) if s[0] == "down"]
    assert [steps[i][1] for i in downs] == list(range(levels))
    assert all(steps[i + 1][0] in ("lap", "down") for i in downs)
    assert [s for s in steps if s[0] == "up"] == [("up", lv) for lv in reversed(range(levels))]
    assert all(s[0] == "up" for s in steps[len(steps) - levels:])


def _shards_on_two_cards(monkeypatch, nodes: int = 3):
    """Two StaticIterations of a small cornell_spheres, rows 0-15 and 16-31,
    whose buffers claim to lie on cuda:0 and cuda:1, with torch.cuda faked;
    every step, replay and live-count read logged with its shard's card."""
    r = Renderer(SCENES["cornell_spheres"], RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(32, 32), trace_depth=2, device="cpu")
    shards = []
    for card in (0, 1):
        it = StaticIteration(r.flat, r.static, r.opts, r.key, graphs=False, local_rows=16,
                             pixel0=card * 16 * 32)
        it.graphs, it.device = True, torch.device("cuda", card)
        shards.append(it)
    fake = FakeCuda(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: nodes)
    replay, live = StaticIteration.replay, StaticIteration.live

    def logged_replay(self, key):
        fake.log.append(("step", self.device.index, key))
        return replay(self, key)

    def logged_live(self, key):
        fake.log.append(("read", self.device.index, key))
        return live(self, key)

    monkeypatch.setattr(StaticIteration, "replay", logged_replay)
    monkeypatch.setattr(StaticIteration, "live", logged_live)
    return r, shards, fake


def test_lockstep_on_two_cards(monkeypatch):
    """With cuda:0 current, run_lockstep over shards on cuda:0 and cuda:1:
    each shard's captures on a stream of its card with its card current, its
    replays with its card current; in every round each shard's lap is issued
    before the round's first live-count read, and each shard's laps are the
    ones its own run takes."""
    r, shards, fake = _shards_on_two_cards(monkeypatch)
    out = graphs.run_lockstep([(it, r.camera.as_arrays(), 1, None) for it in shards])
    captures = [e for e in fake.log if e[0] == "capture"]
    assert [e[1:] for e in captures] == (
        [(0, torch.device("cuda", 0), "thread_local")] * shards[0].num_graphs
        + [(1, torch.device("cuda", 1), "thread_local")] * shards[1].num_graphs)
    assert fake.current == 0
    steps = [i for i, e in enumerate(fake.log) if e[0] == "step"]
    assert steps and all(fake.log[i + 1] == ("replay", fake.log[i][1]) for i in steps)
    # the rounds: each shard's lap, then the reads
    events = [e for e in fake.log if e[0] == "read" or (e[0] == "step" and e[2][0] == "lap")]
    rounds, i = [], 0
    while i < len(events):
        laps = []
        while i < len(events) and events[i][0] == "step":
            laps.append(events[i][1])
            i += 1
        reads = []
        while i < len(events) and events[i][0] == "read":
            reads.append(events[i][1])
            i += 1
        assert laps == reads and len(set(laps)) == len(laps), (laps, reads)
        rounds.append(laps)
    assert rounds[0] == [0, 1]
    for d, (_, _, shard_laps) in enumerate(out):
        assert sum(d in lapped for lapped in rounds) == len(shard_laps) > 0
    finishes = [e[1] for e in fake.log if e[0] == "step" and e[2] == ("finish",)]
    assert finishes == [0, 1]


def test_lockstep_capture_failure_names_the_card(monkeypatch):
    """A shard whose graph holds no node raises GraphError naming its card
    and its step; nothing runs eagerly after it."""
    r, shards, fake = _shards_on_two_cards(monkeypatch)
    nodes = {0: 3, 1: 0}
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: nodes[fake.current])
    with pytest.raises(graphs.GraphError, match=r"capture of step \('start',\) on cuda:1 failed"):
        graphs.run_lockstep([(it, r.camera.as_arrays(), 1, None) for it in shards])
    assert not [e for e in fake.log if e[0] == "read"]


def test_factory_on_the_card_keeps_its_iterations(monkeypatch):
    """make_render_iteration's step on a card (faked): a second call with
    the same key replays the same StaticIteration; another first pixel gets
    its own, another key a new one in its place; every result is a new
    tensor that no later call writes."""
    r = Renderer(SCENES["cornell_spheres"], RenderOptions(sample_mode=SampleMode.MIS,
                                                          swizzle=False),
                 resolution=(32, 32), trace_depth=2, device="cpu")
    made = []

    class OnCard(StaticIteration):
        def __init__(self, flat, *args, graphs=True, **kwargs):
            super().__init__(flat, *args, graphs=False, **kwargs)
            self.graphs, self.device = graphs, torch.device("cuda", 0)
            made.append(self)

    monkeypatch.setattr(graphs, "StaticIteration", OnCard)
    monkeypatch.setattr(graphs, "graph_route", lambda static, opts, device: True)
    fake = FakeCuda(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: 3)
    step = wavefront.make_render_iteration(r.static, r.opts, 32, 32, local_rows=16)
    cam, img = r._cam_arrays(), torch.zeros((16 * 32, 3))
    first = step(r.flat, cam, img, 1, r.key)
    kept = [t.clone() for t in first[:2]]
    second = step(r.flat, cam, first[0], 2, r.key)
    assert len(made) == 1 and made[0].graphs and made[0].num_graphs
    captures = len([e for e in fake.log if e[0] == "capture"])
    assert captures == made[0].num_graphs  # the second call captured nothing
    it = made[0]
    for out in (first, second):
        assert out[0].data_ptr() not in (it.contrib.data_ptr(), img.data_ptr())
        assert out[1].data_ptr() != it.rays.data_ptr()
        assert isinstance(out[2], int) and out[2] >= 1
    it.contrib.fill_(-1.0)
    it.rays.fill_(-1)
    assert torch.equal(first[0], kept[0]) and torch.equal(first[1], kept[1])
    step(r.flat, cam, img, 1, r.key, 16 * 32)
    assert len(made) == 2 and made[1].spec.pixel0 == 16 * 32
    step(r.flat, cam, img, 1, r.key, 16 * 32)
    assert len(made) == 2
    step(r.flat, cam, img, 1, rng.base_key(1))
    assert len(made) == 3 and made[2].key != made[0].key
