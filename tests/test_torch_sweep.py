"""The analytic sweep's wrappers (`pathtracer_tpu_torch/ops/sweep_cuda.py`:
S1 `geoms_closest`, S2 `geoms_occluded`) and their plain versions.

- On CPU tensors each wrapper is its plain version, bit for bit, and counts
  no launch (cornell_spheres' 11 spheres and cubes; the torus box, whose
  mesh the sweep skips).
- `closest_hit` and `occlusion_test` on a scene without a sphere or a cube
  call neither wrapper.
- Hand-made rays through both plain versions: a zero direction component,
  whose slab test meets 0/0 (NaN) on a cube's face plane and +-inf off it,
  and twin geoms at the same t (the earlier geom wins), against the values
  the geometry gives and against the JAX package's sweep.
- The main path hands the wrappers what the kernels take: contiguous
  float32 rays, (N,) min_t.
- The compiled iteration (`integrator/graphs.py`, torch.cuda faked as in
  tests/test_torch_graphs.py) credits every replay of a lap with the sweep
  launches its capture counted: one S1 a lap, one S2 a lap under MIS, none
  under BSDF sampling; and likewise the material lobes' M1 and M2
  (ops/shade_cuda.py), each under its tag in the launch table of
  ops/_build.py.
- On a card (marked `card`; skipped here): each kernel bit for bit its plain
  version on random and on axis-aligned rays.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import traverse as jtv
from pathtracer_tpu.scene.flatscene import build_flat_scene as jax_build_flat_scene
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch.integrator import graphs
from pathtracer_tpu_torch.integrator.graphs import StaticIteration
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.integrator import wavefront
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import shade_cuda as sh
from pathtracer_tpu_torch.ops import sweep_cuda as sw
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.scene.flatscene import build_flat_scene
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_graphs import FakeCuda
from tests.test_torch_render import small_torus_scene
from tests.test_traverse import tri_soup_scene

ROOT = Path(__file__).resolve().parent.parent
CORNELL = ROOT / "scenes" / "cornell_spheres.txt"

# A unit cube at the origin, twin unit spheres at x = 3 and twin unit cubes
# at x = -3 (each twin pair the same geom twice: equal t on every ray).
TWINS = """
MATERIAL white
TYPE        Lambertian
ALBEDO      .5 .5 .5
METALLIC    0
ROUGHNESS   0
IOR         0

CAMERA
RES         16 16
FOVY        45
ITERATIONS  1
DEPTH       2
FILE        twins
EYE         0 0 10
LOOKAT      0 0 0
UP          0 1 0
"""
TWIN_GEOMS = (("cube", (0, 0, 0)), ("sphere", (3, 0, 0)), ("sphere", (3, 0, 0)),
              ("cube", (-3, 0, 0)), ("cube", (-3, 0, 0)))
# rays: origin, direction, the segment's end, and what S1 and S2 must give:
# the geom hit (-1: none), the hit's t and world normal, blocked or not
TWIN_RAYS = (
    # on the cube's face plane x = -0.5, straight up: (-0.5 - -0.5) / 0 is
    # 0/0, and the NaN rejects the cube
    ((-0.5, -2, 0), (0, 1, 0), (-0.5, 2, 0), -1, None, (0, 0, 0), False),
    # through the cube's middle, straight up: the x and z slabs are +-inf
    ((0, -2, 0), (0, 1, 0), (0, 2, 0), 0, 1.5, (0, -1, 0), True),
    # through the twin spheres: the earlier one
    ((3, -2, 0), (0, 1, 0), (3, 2, 0), 1, 1.5, (0, -1, 0), True),
    # through the twin cubes, along +x: the earlier one
    ((-5, 0, 0), (1, 0, 0), (-1, 0, 0), 3, 1.5, (-1, 0, 0), True),
    # along +x through all: the twin cubes first; the segment ends short of them
    ((-6, 0, 0), (1, 0, 0), (-4, 0, 0), 3, 2.5, (-1, 0, 0), False),
    # parallel to every face, beside everything: a miss
    ((0, 2, 0), (0, 0, -1), (0, 2, -5), -1, None, (0, 0, 0), False),
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as tests/test_torch_schedule.py."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Port tables (CPU) of cornell_spheres, the torus box and the twins,
    and the twins' JAX tables."""
    tmp = tmp_path_factory.mktemp("sweep")
    twins = tmp / "twins.txt"
    text = TWINS
    for k, (kind, (x, y, z)) in enumerate(TWIN_GEOMS):
        text += (f"\nOBJECT g{k}\n{kind}\nmaterial white\nTRANS       {x} {y} {z}\n"
                 f"ROTAT       0 0 0\nSCALE       1 1 1\n")
    twins.write_text(text)
    out = {name: build_flat_scene(load_scene(path), device="cpu")
           for name, path in (("cornell_spheres", CORNELL),
                              ("torus_box", small_torus_scene(tmp)), ("twins", twins))}
    out["twins_jax"] = jax_build_flat_scene(jax_load_scene(twins))
    return out


@pytest.fixture(autouse=True)
def counters(monkeypatch):
    """A launch table of zeros for each test."""
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.LAUNCHES, 0))


def _sweeps() -> tuple:
    return _build.launches["S1"], _build.launches["S2"]


def _box_rays(n, seed):
    """Rays from inside the Cornell box toward anywhere, a sixth of them
    with one direction component zero, and segment ends along them."""
    g = np.random.default_rng(seed)
    o = g.uniform([-4.5, 0.5, -4.5], [4.5, 9.0, 4.5], size=(n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d[::6, 1] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    des = (o + d * g.uniform(0.5, 8.0, size=(n, 1))).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(des)


def _min_t(o, des):
    e = des - o
    return torch.sqrt(torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2],
                                  min=0.0))


@pytest.mark.parametrize("scene", ["cornell_spheres", "torus_box"])
def test_wrappers_are_the_plain_versions_on_cpu(scene, scenes):
    flat, static = scenes[scene]
    o, d, des = _box_rays(3000, seed=71)
    min_t = _min_t(o, des)
    got = sw.geoms_closest(flat, static, o, d)
    want = sw.geoms_closest_plain(flat, static, o, d)
    for name, a, b in zip(("t", "geom", "point", "normal"), got, want):
        assert torch.equal(a, b), name
    assert (got[1] >= 0).sum() > 1000  # the rays hit walls and objects
    occ = sw.geoms_occluded(flat, static, o, d, min_t)
    assert torch.equal(occ, sw.geoms_occluded_plain(flat, static, o, d, min_t))
    assert 100 < int(occ.sum()) < 2900
    assert _sweeps() == (0, 0)


def test_no_analytic_geom_calls_no_wrapper(tmp_path, monkeypatch):
    """A mesh alone: closest_hit and occlusion_test sweep nothing, and what
    they return is the triangles' answer alone."""
    flat, static = build_flat_scene(load_scene(tri_soup_scene(tmp_path, n=60, seed=5)),
                                    device="cpu")
    assert not sw.analytic_geoms(static)

    def refuse(*args, **kwargs):
        raise AssertionError("a scene without spheres and cubes reached a sweep wrapper")

    monkeypatch.setattr(ttv, "geoms_closest", refuse)
    monkeypatch.setattr(ttv, "geoms_occluded", refuse)
    g = np.random.default_rng(6)
    o = torch.from_numpy(g.uniform(-6, 6, size=(500, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(g.normal(size=(500, 3)).astype(np.float32)))
    hit = ttv.closest_hit(flat, static, o, d)
    assert torch.equal(hit.geom >= 0, hit.tri >= 0) and int((hit.tri >= 0).sum()) > 0
    assert torch.equal(hit.t[hit.tri < 0], torch.full_like(hit.t[hit.tri < 0], sw.FLT_MAX))
    occ = ttv.occlusion_test(flat, static, o, d, o + 8.0 * d)
    assert occ.dtype == torch.bool and occ.shape == (500,)
    assert _sweeps() == (0, 0)


def _twin_rays():
    o, d, des = (torch.tensor([r[k] for r in TWIN_RAYS], dtype=torch.float32) for k in range(3))
    return o, d, des


def test_zero_direction_and_ties_closest(scenes):
    flat, static = scenes["twins"]
    o, d, _ = _twin_rays()
    t, geom, point, normal = sw.geoms_closest_plain(flat, static, o, d)
    assert geom.tolist() == [r[3] for r in TWIN_RAYS]
    for k, (_, _, _, gi, t_want, n_want, _) in enumerate(TWIN_RAYS):
        if gi < 0:
            assert float(t[k]) == np.float32(sw.FLT_MAX)
            assert point[k].tolist() == [0.0, 0.0, 0.0] and normal[k].tolist() == [0.0, 0.0, 0.0]
        else:
            # the hit is pulled back by 1e-4 along the object ray
            assert abs(float(t[k]) - t_want) < 2e-4, k
            assert normal[k].tolist() == list(map(float, n_want)), k
    # the JAX package's sweep on the same tables: the same geoms, the same
    # values up to XLA's rounding
    jflat, jstatic = scenes["twins_jax"]
    jt, jgeom, jpoint, jnormal = jtv._geoms_closest(jflat, jstatic, jnp.asarray(o.numpy()),
                                                 jnp.asarray(d.numpy()))
    np.testing.assert_array_equal(geom.numpy(), np.asarray(jgeom))
    for a, b in ((t, jt), (point, jpoint), (normal, jnormal)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_zero_direction_and_ties_occluded(scenes):
    flat, static = scenes["twins"]
    o, d, des = _twin_rays()
    occ = sw.geoms_occluded_plain(flat, static, o, d, _min_t(o, des))
    assert occ.tolist() == [r[6] for r in TWIN_RAYS]
    assert torch.equal(ttv.occlusion_test(flat, static, o, d, des), occ)


def test_wrapper_arguments_are_checked(scenes):
    flat, static = scenes["cornell_spheres"]
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="rays must be"):
        sw.geoms_closest(flat, static, o, torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="min_t must be"):
        sw.geoms_occluded(flat, static, o, o, torch.zeros(5))
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sw.geoms_closest(flat, static, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sw.geoms_occluded(flat, static, meta, meta, torch.zeros(4, device="meta"))


def test_graph_counters_hold_the_sweep():
    """The launch table counts S1 and S2 beside K1-K5; `launch_counts`
    stays K1-K5's, which a device trace names."""
    assert (_build.LAUNCHES["S1"], _build.LAUNCHES["S2"]) == ("pt_sweep_closest",
                                                              "pt_sweep_occluded")
    _build.launches.update(S1=3, S2=4)
    assert _sweeps() == (3, 4)
    assert graphs.launch_counts() == (0,) * 5


def test_main_path_hands_the_kernels_their_arguments(monkeypatch):
    """Every call of the wrappers in a CPU render (MIS: both) gets what the
    CUDA branch takes: contiguous float32 (N, 3) rays and an (N,) float32
    min_t."""
    seen = {"closest": 0, "occluded": 0}

    def ok(*tensors):
        assert all(t.dtype == torch.float32 and t.is_contiguous() for t in tensors)

    def closest(flat, static, o, d):
        ok(o, d)
        seen["closest"] += 1
        return sw.geoms_closest_plain(flat, static, o, d)

    def occluded(flat, static, ori, dir, min_t):
        ok(ori, dir, min_t)
        assert min_t.shape == ori.shape[:1]
        seen["occluded"] += 1
        return sw.geoms_occluded_plain(flat, static, ori, dir, min_t)

    monkeypatch.setattr(ttv, "geoms_closest", closest)
    monkeypatch.setattr(ttv, "geoms_occluded", occluded)
    r = Renderer(CORNELL, RenderOptions(sample_mode=SampleMode.MIS), resolution=(24, 24),
                 trace_depth=3, device="cpu")
    r.step(1)
    assert seen["closest"] > 0 and seen["occluded"] > 0


def _counting(monkeypatch):
    """Wrappers that count a launch and run the plain version: S1 and S2,
    and the material lobes' M1 and M2."""
    def counted(tag, plain):
        def wrapper(*args, **kwargs):
            _build.launches[tag] += 1
            return plain(*args, **kwargs)
        return wrapper

    closest = counted("S1", sw.geoms_closest_plain)
    occluded = counted("S2", sw.geoms_occluded_plain)
    scatter = counted("M1", sh.scatter_lobes_plain)
    evaluate = counted("M2", sh.eval_lobes_plain)

    monkeypatch.setattr(ttv, "geoms_closest", closest)
    monkeypatch.setattr(ttv, "geoms_occluded", occluded)
    monkeypatch.setattr(wavefront, "scatter_lobes", scatter)
    monkeypatch.setattr(wavefront, "eval_lobes", evaluate)


@pytest.mark.parametrize("mode", [SampleMode.MIS, SampleMode.BSDF])
def test_replays_credit_the_sweep_launches(mode, monkeypatch):
    """A lap graph's replay adds the launches its capture counted: one S1 and
    one M1 a lap, and one S2 and one M2 a lap under MIS (none under BSDF
    sampling)."""
    _counting(monkeypatch)
    r = Renderer(CORNELL, RenderOptions(sample_mode=mode), resolution=(32, 32), trace_depth=2,
                 device="cpu")
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    it.graphs, it.device = True, torch.device("cuda", 0)
    FakeCuda(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: 3)
    it.run(r._cam_arrays(), 1)  # captures every step (each run once eagerly first)
    _build.launches.update(dict.fromkeys(_build.launches, 0))
    launches, laps = dict(it.launches), it.counts()["laps"]
    it.run(r._cam_arrays(), 2)  # replays alone
    laps = it.counts()["laps"] - laps
    assert laps > 0
    want = (laps, laps if mode == SampleMode.MIS else 0)
    added = {tag: n - launches[tag] for tag, n in it.launches.items()}
    assert added == dict(dict.fromkeys(_build.LAUNCHES, 0), S1=want[0], S2=want[1], M1=want[0],
                         M2=want[1])
    assert _build.launches == added


@pytest.mark.card
@pytest.mark.parametrize("rays", ["random", "axis-aligned"])
def test_kernels_match_plain_on_the_card(rays):
    """S1 and S2 against their plain versions on the card, bit for bit, on
    cornell_spheres: random rays from inside the box, or rays whose
    directions lie along the axes (a zero component, or two)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flat, static = build_flat_scene(load_scene(CORNELL), device="cuda")
    o, d, des = (x.cuda() for x in _box_rays(200_000, seed=72))
    if rays == "axis-aligned":
        axis = torch.arange(o.shape[0], device="cuda") % 3
        d = torch.nn.functional.one_hot(axis, 3).float() * torch.where(d[:, :1] > 0, 1.0, -1.0)
        d[1::2] = torch.nn.functional.normalize(d[1::2] + d[1::2].roll(1, dims=1))
        des = o + 6.0 * d
    min_t = _min_t(o, des)
    got = sw.geoms_closest(flat, static, o, d)
    want = sw.geoms_closest_plain(flat, static, o, d)
    for name, a, b in zip(("t", "geom", "point", "normal"), got, want):
        assert torch.equal(a, b), name
    assert torch.equal(sw.geoms_occluded(flat, static, o, d, min_t),
                       sw.geoms_occluded_plain(flat, static, o, d, min_t))
    assert _sweeps() == (1, 1)
