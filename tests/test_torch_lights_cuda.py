"""The light side of NEE's wrappers (`pathtracer_tpu_torch/ops/lights_cuda.py`:
L1 `sample_lights`, L2 `eval_light_pdf`) and their plain versions.

- On CPU tensors each wrapper is exactly today's code: L1 is
  `pixel_uniforms` (STAGE_LIGHT, counter lane + pixel0, 3 columns, 4 with
  the environment) then `ops/lights.py light_samples`, L2 is `light_pdf`;
  with the RNG's counter fields as ints, one-word tensors and per-lane
  tensors, pixel0 0 and not, a NEE mask and none, on a scene with sphere,
  cube and triangle lights and on a sky with a lamp; no launch counter
  moves.
- The main path hands the wrappers what the CUDA branch takes: every call
  in a CPU render (eager loop, compiled iteration without graphs, ray
  regeneration; MIS and DIRECT_LI) passes the CUDA branch's argument
  checks; BSDF sampling calls neither, DIRECT_LI no L2.
- The launch table of `ops/_build.py` counts L1 and L2 under their tags:
  at depth 8 an iteration's 8 laps launch one of each under MIS (8 a
  sample), none under BSDF sampling, and a captured iteration's replays
  credit one of each a replayed lap.
- On a card (marked `card`; skipped here): each kernel bit for bit its plain
  version, NaN where NaN, on 640,000 lanes (sphere, cube and triangle
  lights, the environment's split, disabled lanes, per-lane counters).
  This file imports no JAX, so on a card it runs alone:
  `python -m pytest --noconftest tests/test_torch_lights_cuda.py`.
"""

import contextlib
import textwrap
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import graphs
from pathtracer_tpu_torch.integrator import wavefront as wf
from pathtracer_tpu_torch.integrator.graphs import StaticIteration
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import lights_cuda as lc
from pathtracer_tpu_torch.ops.lights import light_pdf, light_samples
from pathtracer_tpu_torch.scene.flatscene import build_flat_scene
from pathtracer_tpu_torch.scene.parser import CUBE, OBJ, SPHERE, load_scene
from pathtracer_tpu_torch.utils import rng
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tools.make_texture_assets import ensure_texture_assets
from tools.make_torus_obj import write_torus_obj

ROOT = Path(__file__).resolve().parent.parent
CORNELL = ROOT / "scenes" / "cornell_spheres.txt"
KEY = rng.base_key(2**32 + 91)


@pytest.fixture(autouse=True)
def counters(monkeypatch):
    """A launch table of zeros for each test."""
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.LAUNCHES, 0))


def _lights() -> tuple:
    return _build.launches["L1"], _build.launches["L2"]


def lights_scene(tmp: Path) -> Path:
    """cornell_spheres with every kind of light: the sphere lamp, the
    diffuse sphere made a light, the tall box made a cube light (no sampling
    branch) and a 576-triangle torus of triangle lights."""
    write_torus_obj(tmp / "torus576.obj", 24, 12)
    text = CORNELL.read_text()
    for name, kind, mat in (("box", "cube", "white"), ("diffuse", "sphere", "yellow")):
        text = text.replace(f"OBJECT {name}\n{kind}\nmaterial {mat}",
                            f"OBJECT {name}\n{kind}\nmaterial light")
    text += textwrap.dedent(f"""
        OBJECT torus
        {tmp / 'torus576.obj'}
        material light
        TRANS       1 5 0
        ROTAT       60 0 30
        SCALE       1.5 1.5 1.5
        """)
    path = tmp / "lights.txt"
    path.write_text(text)
    return path


def sky_scene(tmp: Path) -> Path:
    """scenes/envtorus.txt with a sphere lamp: light 0 the lamp, 1 the sky."""
    ensure_texture_assets()
    text = (ROOT / "scenes" / "envtorus.txt").read_text()
    text = text.replace("assets/", str(ROOT / "scenes" / "assets") + "/")
    text = text.replace("MATERIAL gold", textwrap.dedent("""\
        MATERIAL light
        TYPE\tLight
        ALBEDO      5 5 5
        METALLIC    0
        ROUGHNESS   0
        IOR         0

        MATERIAL gold"""))
    text += textwrap.dedent("""
        OBJECT lamp
        sphere
        material light
        TRANS       1.5 4 2
        ROTAT       0 0 0
        SCALE       1 1 1
        """)
    path = tmp / "sky.txt"
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lights")
    return {"lights": lights_scene(tmp), "sky": sky_scene(tmp)}


def _tables(path, device="cpu"):
    return build_flat_scene(load_scene(path), device=device)


def _counter_fields(form: str, n: int, seed: int):
    """(iteration, depth) as ints, one-word int32 tensors or per-lane int32
    tensors."""
    if form == "int":
        return 7, 3
    if form == "one word":
        return torch.tensor(7, dtype=torch.int32), torch.tensor(3, dtype=torch.int32)
    g = np.random.default_rng(seed)
    return (torch.from_numpy(g.integers(0, 2**20, n).astype(np.int32)),
            torch.from_numpy(g.integers(0, 256, n).astype(np.int32)))


def _view_points(n: int, seed: int):
    """Points inside the box (and the sky scene's), some in or on a light."""
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.uniform([-4.9, 0.1, -4.9], [4.9, 9.9, 4.9], (n, 3))
                            .astype(np.float32))


def _hits(flat, static, n: int, seed: int):
    """L2's inputs: ray origins, hit points, unit normals, and (triangle,
    geom) pairs over every geom (-1 a miss), a mesh's with a triangle."""
    g = np.random.default_rng(seed)
    geom = g.integers(-1, static.num_geoms, n).astype(np.int32)
    mesh = np.isin(geom, [i for i, t in enumerate(static.geom_types) if t == OBJ])
    tri = np.where(mesh, g.integers(0, max(static.num_tris, 1), n), -1).astype(np.int32)
    nrm = g.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o, p = (g.uniform([-4.9, 0.1, -4.9], [4.9, 9.9, 4.9], (n, 3)) for _ in range(2))
    return (*(torch.from_numpy(v.astype(np.float32)) for v in (o, p, nrm)),
            torch.from_numpy(tri), torch.from_numpy(geom))


def test_scenes_hold_every_kind_of_light(scenes):
    _, static = _tables(scenes["lights"])
    kinds = {t for _, _, t in static.analytic_lights}
    assert kinds == {SPHERE, CUBE} and static.num_lights > len(static.analytic_lights) + 500
    _, sky = _tables(scenes["sky"])
    assert sky.num_lights == 1 and sky.env_map_id >= 0


@pytest.mark.parametrize("pixel0", [0, 640_000])
@pytest.mark.parametrize("form", ["int", "one word", "per lane"])
@pytest.mark.parametrize("scene", ["lights", "sky"])
def test_wrappers_are_the_plain_versions_on_cpu(scene, form, pixel0, scenes):
    flat, static = _tables(scenes[scene])
    env = scene == "sky"
    n = 3000
    view = _view_points(n, seed=41)
    lane = torch.from_numpy(np.random.default_rng(42).permutation(n).astype(np.int32))
    it, depth = _counter_fields(form, n, seed=43)
    enabled = torch.arange(n) % 4 != 0
    rands = rng.pixel_uniforms(KEY, it, depth, rng.STAGE_LIGHT,
                               lane + pixel0 if pixel0 else lane, 4 if env else 3)
    for mask in (None, enabled):
        got = lc.sample_lights(flat, static, view, KEY, it, depth, lane, pixel0, mask, env)
        want = light_samples(flat, static, view, rands, mask, env)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), name
    assert (got.pdf > 0).any() and not got.occ_on[~enabled].any()
    if not env:  # a cube light's lanes: pdf 0, no shadow ray
        assert (got.pdf == 0).any()
    o, p, nrm, tri, geom = _hits(flat, static, n, seed=44)
    lp = lc.eval_light_pdf(flat, static, o, p, nrm, tri, geom, env)
    assert torch.equal(lp, light_pdf(flat, static, o, p, nrm, tri, geom, env))
    assert (lp > 0).any() and (lp == -1).any()
    assert _lights() == (0, 0)


def test_wrapper_arguments_are_checked(scenes):
    flat, static = _tables(scenes["lights"])
    n = 16
    view, lane = _view_points(n, seed=45), torch.arange(n, dtype=torch.int32)
    o, p, nrm, tri, geom = _hits(flat, static, n, seed=46)
    with pytest.raises(ValueError, match="directions must be"):
        lc.sample_lights(flat, static, view[:8], KEY, 1, 0, lane)
    with pytest.raises(ValueError, match="directions must be"):
        lc.eval_light_pdf(flat, static, o, p, nrm[:, :2], tri, geom)
    with pytest.raises(ValueError, match="8 depth bits"):
        lc.sample_lights(flat, static, view, KEY, 1, 256, lane)
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        lc.sample_lights(flat, static, view.to("meta"), KEY, 1, 0, meta)
    # what the CUDA branch refuses before a launch
    dev = lane.device
    with pytest.raises(ValueError, match="dtype"):
        _build.column(torch.ones(n, dtype=torch.uint8), "enabled", n, 1, torch.bool, dev)
    with pytest.raises(ValueError, match="dtype"):
        lc._tables(replace(flat, geom_inv=flat.geom_inv.double()), static, static.num_lights)
    with pytest.raises(ValueError, match="contiguous"):
        lc._tables(replace(flat, tri_data=flat.tri_data.t().contiguous().t()), static, 1)
    with pytest.raises(ValueError, match="disagree"):
        lc._tables(replace(flat, light_tri=flat.light_tri[:-1]), static, static.num_lights)
    tabs = lc._tables(flat, static, static.num_lights + 1)
    assert tabs[2:6] == (static.num_lights, static.num_lights, float(static.num_lights + 1),
                         float(np.float32(1) / np.float32(static.num_lights + 1)))
    assert tabs[11] == flat.mat_f32.shape[1] and tabs[15] == flat.tri_data.shape[1]
    assert lc._tables(flat, static, 0)[5] == 0.0


def _marshalling(monkeypatch):
    """Wrappers that run the CUDA branch's argument checks on the main path's
    CPU tensors, then the plain version; returns the calls seen."""
    seen = []

    def form(x):
        return "int" if not isinstance(x, torch.Tensor) else ("one word" if x.numel() == 1
                                                              else "per lane")

    def sample(flat, static, view_pos, key, iteration, depth, lane, pixel0=0, enabled=None,
               include_env=False, mark=None):
        n, dev = lane.shape[0], lane.device
        _build.column(view_pos, "view_pos", n, 3, torch.float32, dev)
        _build.column(enabled, "enabled", n, 1, torch.bool, dev)
        _build.draw_args(key, iteration, depth, lane, pixel0)
        lc._tables(flat, static, static.num_lights + include_env)
        seen.append(("L1", form(iteration), form(depth)))
        return lc.sample_lights_plain(flat, static, view_pos, key, iteration, depth, lane, pixel0,
                                      enabled, include_env, mark=mark)

    def pdf(flat, static, view_pos, light_pos, normal, tri_id, geom_id, include_env=False):
        n, dev = tri_id.shape[0], tri_id.device
        for name, v in (("view_pos", view_pos), ("light_pos", light_pos), ("normal", normal)):
            _build.column(v, name, n, 3, torch.float32, dev)
        for name, v in (("tri_id", tri_id), ("geom_id", geom_id)):
            _build.column(v, name, n, 1, torch.int32, dev)
        lc._tables(flat, static, static.num_lights + include_env)
        seen.append(("L2",))
        return lc.eval_light_pdf_plain(flat, static, view_pos, light_pos, normal, tri_id,
                                       geom_id, include_env)

    monkeypatch.setattr(wf, "sample_lights", sample)
    monkeypatch.setattr(wf, "eval_light_pdf", pdf)
    return seen


def test_main_path_hands_the_kernels_their_arguments(monkeypatch, scenes):
    """A CPU render's every call of L1 and L2 passes the CUDA branch's
    checks: the eager loop (int counters), the compiled iteration's steps
    run eagerly (one-word counters) and ray regeneration (per-lane), under
    MIS; DIRECT_LI calls L1 alone, BSDF sampling neither."""
    seen = _marshalling(monkeypatch)

    def renderer(mode, scene=CORNELL, **options):
        return Renderer(scene, RenderOptions(sample_mode=mode, **options), resolution=(16, 16),
                        trace_depth=3, device="cpu")

    r = renderer(SampleMode.MIS)
    r.step(1)
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    it.run(r._cam_arrays(), 1)
    renderer(SampleMode.MIS, ray_regen=4).step(5)
    renderer(SampleMode.MIS, scenes["sky"], env_importance=True).step(1)
    assert {("L1", "int", "int"), ("L1", "one word", "one word"),
            ("L1", "per lane", "per lane"), ("L2",)} <= set(seen)
    seen.clear()
    renderer(SampleMode.DIRECT_LI, scenes["lights"]).step(2)
    assert seen and set(seen) == {("L1", "int", "int")}
    seen.clear()
    renderer(SampleMode.BSDF).step(2)
    assert not seen


@contextlib.contextmanager
def _fake_graphs(monkeypatch):
    """torch.cuda's calls of a capture and a replay, on a machine without a
    card: a capture runs its body, a replay nothing; every graph 3 nodes."""
    class Graph:
        def instantiate(self):
            pass

        def replay(self):
            pass

    @contextlib.contextmanager
    def capture(*args, **kwargs):
        yield

    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: types.SimpleNamespace(device=dev))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda keep_graph=False: Graph())
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: 3)
    yield


@pytest.mark.parametrize("mode", [SampleMode.MIS, SampleMode.BSDF])
def test_replays_credit_the_light_launches(mode, monkeypatch):
    """At depth 8 in the closed box an iteration runs 8 laps, each with one
    L1 and one L2 under MIS and none under BSDF sampling: 8 of each a
    sample.  A captured iteration's replays add the launches its capture
    counted, one of each a replayed lap (the faked replays run nothing, so
    the live count stays and all 9 laps of the budget replay)."""
    def counted(tag, plain):
        def wrapper(*args, **kwargs):
            _build.launches[tag] += 1
            return plain(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(wf, "sample_lights", counted("L1", lc.sample_lights_plain))
    monkeypatch.setattr(wf, "eval_light_pdf", counted("L2", lc.eval_light_pdf_plain))
    r = Renderer(CORNELL, RenderOptions(sample_mode=mode), resolution=(32, 32), trace_depth=8,
                 device="cpu")
    per_lap = 1 if mode == SampleMode.MIS else 0
    eager = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    eager.run(r._cam_arrays(), 1)
    assert eager.counts()["laps"] == 8 and _lights() == (8 * per_lap, 8 * per_lap)

    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    it.graphs, it.device = True, torch.device("cuda", 0)
    with _fake_graphs(monkeypatch):
        it.run(r._cam_arrays(), 1)  # captures every step (each run once eagerly first)
        _build.launches.update(dict.fromkeys(_build.launches, 0))
        launches, laps = dict(it.launches), it.counts()["laps"]
        it.run(r._cam_arrays(), 2)  # replays alone
    laps = it.counts()["laps"] - laps
    assert laps > 0
    added = {tag: it.launches[tag] - launches[tag] for tag in ("L1", "L2")}
    assert added == {"L1": per_lap * laps, "L2": per_lap * laps}
    assert _lights() == (per_lap * laps, per_lap * laps)


# ---------------------------------------------------------------------------
# on a card


def _same_bits(a, b) -> bool:
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                                               torch.where(nb, 0.0, b).view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("form", ["one word", "per lane"])
@pytest.mark.parametrize("scene", ["lights", "sky"])
def test_kernels_match_plain_on_the_card(scene, form, scenes):
    """L1 and L2 against their plain versions on the card at 640,000 lanes,
    bit for bit and NaN where NaN: sphere, cube and triangle lights, or the
    sky's split with a lamp; lanes with and without the NEE mask; NaN view
    points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flat, static = _tables(scenes[scene], device="cuda")
    env = scene == "sky"
    n = 640_000
    view = _view_points(n, seed=47)
    view[:64] = float("nan")
    view = view.cuda()
    lane = torch.from_numpy(np.random.default_rng(48).permutation(n).astype(np.int32)).cuda()
    it, depth = (x.cuda() for x in _counter_fields(form, n, seed=49))
    enabled = (torch.arange(n, device="cuda") % 3) != 0
    for mask in (None, enabled):
        got = lc.sample_lights(flat, static, view, KEY, it, depth, lane, 12345, mask, env)
        want = lc.sample_lights_plain(flat, static, view, KEY, it, depth, lane, 12345, mask, env)
        for name, a, b in zip(want._fields, got, want):
            assert _same_bits(a, b), name
    assert (want.pdf > 0).any()
    o, p, nrm, tri, geom = (x.cuda() for x in _hits(flat, static, n, seed=50))
    got = lc.eval_light_pdf(flat, static, o, p, nrm, tri, geom, env)
    assert _same_bits(got, lc.eval_light_pdf_plain(flat, static, o, p, nrm, tri, geom, env))
    assert _lights() == (2, 1)
