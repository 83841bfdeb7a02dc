"""The material lobes' wrappers (`pathtracer_tpu_torch/ops/shade_cuda.py`:
M1 `scatter_lobes`, M2 `eval_lobes`) and their plain versions.

- On CPU tensors each wrapper is exactly today's code: M1 is
  `pixel_uniforms` (STAGE_SCATTER, counter lane + pixel0) then
  `scatter_sample`, M2 is `bsdf_eval` and `pdf_eval`; with the RNG's
  counter fields as ints, one-word tensors and per-lane tensors, pixel0 0
  and not, on cornell_spheres' five material types and on missed lanes; no
  launch counter moves.
- The main path hands the wrappers what the CUDA branch takes: every call in
  a CPU render (eager loop, compiled iteration without graphs, ray
  regeneration) passes the CUDA branch's argument checks.
- the launch table of `ops/_build.py` counts M1 and M2 under their tags;
  `integrator/graphs.py launch_counts` stays K1-K5's.
- On a card (marked `card`; skipped here): each kernel bit for bit its plain
  version over every lobe, NaN where NaN, on random lanes of every type and
  on edge values (grazing rays, roughness at its clamps, metallic 0 and 1,
  ior 1, NaN inputs), and M1's draw word for word against `pixel_uniforms`
  with each form of counter field.  This file imports no JAX, so on a card
  it runs alone: `python -m pytest --noconftest tests/test_torch_shade_cuda.py`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import graphs
from pathtracer_tpu_torch.integrator import wavefront as wf
from pathtracer_tpu_torch.integrator.graphs import StaticIteration
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import shade_cuda as sh
from pathtracer_tpu_torch.ops.materials import (
    MatParams,
    bsdf_eval,
    material_by_geom,
    pdf_eval,
    scatter_sample,
)
from pathtracer_tpu_torch.scene.flatscene import build_flat_scene
from pathtracer_tpu_torch.scene.parser import (
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    METALLIC_WORKFLOW,
    MICROFACET,
    load_scene,
)
from pathtracer_tpu_torch.utils import rng
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

ROOT = Path(__file__).resolve().parent.parent
CORNELL = ROOT / "scenes" / "cornell_spheres.txt"
TYPES = (LAMBERTIAN, METALLIC_WORKFLOW, DIELECTRIC, MICROFACET, LIGHT)
KEY = rng.base_key(2**32 + 77)


@pytest.fixture(autouse=True)
def counters(monkeypatch):
    """A launch table of zeros for each test."""
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.LAUNCHES, 0))


def _lobes() -> tuple:
    return _build.launches["M1"], _build.launches["M2"]


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))


@pytest.fixture(scope="module")
def cornell():
    return build_flat_scene(load_scene(CORNELL), device="cpu")


def _scene_lanes(flat, static, n, seed):
    """Lanes as `bounce` shades them: cornell_spheres' material rows by geom
    (a fifth of the lanes missed: geom -1, type 0, zero rows), random normals,
    rays and light directions."""
    g = np.random.default_rng(seed)
    geom = torch.from_numpy(g.integers(-1, static.num_geoms, n).astype(np.int32))
    geom[::5] = -1
    uv = torch.from_numpy(g.uniform(0, 1, (n, 2)).astype(np.float32))
    p = material_by_geom(flat, static, geom, uv)
    return p, geom, _unit(g, n), _unit(g, n), _unit(g, n)


def _counter_fields(form: str, n: int, seed: int):
    """(iteration, depth) as ints, one-word int32 tensors or per-lane int32
    tensors."""
    if form == "int":
        return 7, 3
    if form == "one word":
        return torch.tensor(7, dtype=torch.int32), torch.tensor(3, dtype=torch.int32)
    g = np.random.default_rng(seed)
    return (torch.from_numpy(g.integers(0, 2**21, n).astype(np.int32)),
            torch.from_numpy(g.integers(0, 256, n).astype(np.int32)))


@pytest.mark.parametrize("pixel0", [0, 640_000])
@pytest.mark.parametrize("form", ["int", "one word", "per lane"])
def test_wrappers_are_the_plain_versions_on_cpu(form, pixel0, cornell):
    flat, static = cornell
    n = 4000
    p, geom, nrm, wo, wi = _scene_lanes(flat, static, n, seed=31)
    assert set(TYPES) <= set(p.type.tolist()) and int((geom < 0).sum()) >= n // 5
    lane = torch.from_numpy(np.random.default_rng(32).permutation(n).astype(np.int32))
    it, depth = _counter_fields(form, n, seed=33)
    present = static.material_types

    got = sh.scatter_lobes(p, nrm, wo, KEY, it, depth, lane, pixel0, present=present)
    rands = rng.pixel_uniforms(KEY, it, depth, rng.STAGE_SCATTER,
                               lane + pixel0 if pixel0 else lane, 3)
    want = scatter_sample(p, nrm, wo, rands, present=present)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    bsdf, pdf = sh.eval_lobes(p, nrm, wo, wi, present=present)
    assert torch.equal(bsdf, bsdf_eval(p, nrm, wo, wi, present=present))
    assert torch.equal(pdf, pdf_eval(p, nrm, wo, wi, present=present))
    assert torch.equal(sh.scatter_draw(KEY, it, depth, lane, pixel0), rands)
    assert _lobes() == (0, 0)


def test_wrapper_arguments_are_checked(cornell):
    flat, static = cornell
    p, _, nrm, wo, wi = _scene_lanes(flat, static, 16, seed=34)
    lane = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="directions must be"):
        sh.scatter_lobes(p, nrm[:8], wo, KEY, 1, 0, lane)
    with pytest.raises(ValueError, match="directions must be"):
        sh.eval_lobes(p, nrm, wo, wi[:, :2])
    with pytest.raises(ValueError, match="8 depth bits"):
        sh.scatter_lobes(p, nrm, wo, KEY, 1, 256, lane)
    meta = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sh.scatter_draw(KEY, 1, 0, meta)
    # what the CUDA branch refuses before a launch
    dev = lane.device
    with pytest.raises(ValueError, match="dtype"):
        _build.column(nrm.double(), "n", 16, 3, torch.float32, dev)
    with pytest.raises(ValueError, match="adjacent"):
        _build.column(nrm.t().contiguous().t(), "n", 16, 3, torch.float32, dev)
    with pytest.raises(ValueError, match="shape"):
        _build.column(p.roughness[:4], "roughness", 16, 1, torch.float32, dev)
    with pytest.raises(ValueError, match="int32"):
        _build.counter(torch.tensor(3), "depth", 16, dev)
    with pytest.raises(ValueError, match="one-word"):
        _build.counter(torch.zeros(4, dtype=torch.int32), "depth", 16, dev)
    assert _build.counter(2**32 + 5, "iteration", 16, dev) == (None, 0, 5)
    word = torch.tensor(9, dtype=torch.int32)
    assert _build.counter(word, "iteration", 16, dev) == (word.data_ptr(), 0, 0)
    # a strided column (a row of the material table) is read in place
    rows = torch.zeros((16, 6))
    assert _build.column(rows[:, 0:3], "albedo", 16, 3, torch.float32, dev) == (rows.data_ptr(), 6)


def _marshalling(monkeypatch):
    """Wrappers that run the CUDA branch's argument checks on the main path's
    CPU tensors, then the plain version; returns the counter forms seen."""
    seen = set()

    def form(x):
        return "int" if not isinstance(x, torch.Tensor) else ("one word" if x.numel() == 1
                                                              else "per lane")

    def scatter(p, n, wo, key, iteration, depth, lane, pixel0=0, present=None):
        count, dev = lane.shape[0], lane.device
        sh._material(p, count, dev, full=True)
        _build.column(n, "n", count, 3, torch.float32, dev)
        _build.column(wo, "wo", count, 3, torch.float32, dev)
        _build.draw_args(key, iteration, depth, lane, pixel0)
        seen.add((form(iteration), form(depth)))
        return sh.scatter_lobes_plain(p, n, wo, key, iteration, depth, lane, pixel0, present)

    def evaluate(p, n, wo, wi, present=None):
        count, dev = p.type.shape[0], p.type.device
        sh._material(p, count, dev, full=False)
        for name, v in (("n", n), ("wo", wo), ("wi", wi)):
            _build.column(v, name, count, 3, torch.float32, dev)
        seen.add("eval")
        return sh.eval_lobes_plain(p, n, wo, wi, present)

    monkeypatch.setattr(wf, "scatter_lobes", scatter)
    monkeypatch.setattr(wf, "eval_lobes", evaluate)
    return seen


def test_main_path_hands_the_kernels_their_arguments(monkeypatch):
    """A CPU render's every call of M1 and M2 passes the CUDA branch's
    checks: the eager loop (int counters), the compiled iteration's steps
    run eagerly (one-word counters) and ray regeneration (per-lane)."""
    seen = _marshalling(monkeypatch)
    opts = RenderOptions(sample_mode=SampleMode.MIS)
    r = Renderer(CORNELL, opts, resolution=(16, 16), trace_depth=3, device="cpu")
    r.step(1)
    it = StaticIteration(r.flat, r.static, r.opts, r.key, pixel_xy=r.pixel_xy, graphs=False)
    it.run(r._cam_arrays(), 1)
    regen = Renderer(CORNELL, RenderOptions(sample_mode=SampleMode.MIS, ray_regen=4),
                     resolution=(16, 16), trace_depth=3, device="cpu")
    regen.step(5)
    assert {("int", "int"), ("one word", "one word"), ("per lane", "per lane"), "eval"} <= seen


def test_graph_counters_hold_the_lobes():
    """The launch table counts M1 and M2 (the draw kernel, no tag);
    `launch_counts` stays K1-K5's, which a device trace names."""
    assert (_build.LAUNCHES["M1"], _build.LAUNCHES["M2"]) == ("pt_scatter_lobes",
                                                              "pt_eval_lobes")
    assert "pt_scatter_draw" not in _build.LAUNCHES.values()
    _build.launches.update(M1=5, M2=6)
    assert _lobes() == (5, 6)
    assert graphs.launch_counts() == (0,) * 5


# ---------------------------------------------------------------------------
# on a card


def _same_bits(a, b) -> bool:
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                                               torch.where(nb, 0.0, b).view(torch.int32))


def _card_lanes(n: int, edge: bool):
    """Random lanes of every type (and type 7, the Light default), on the
    card; with `edge`, edge values in eighths of them."""
    g = np.random.default_rng(35 + edge)
    types = np.asarray(TYPES + (7,), np.int32)[np.arange(n) % (len(TYPES) + 1)]
    rows = torch.from_numpy(g.uniform(0.0, 1.0, (n, 6)).astype(np.float32))
    rows[:, 5] = torch.from_numpy(g.uniform(1.0, 2.0, n).astype(np.float32))
    rough = torch.from_numpy(g.uniform(1e-3, 1.0, n).astype(np.float32))
    metal = torch.from_numpy(g.uniform(0.0, 1.0, n).astype(np.float32))
    nrm, wo, wi = _unit(g, n), _unit(g, n), _unit(g, n)
    if edge:
        k = n // 8
        rough[:k], rough[k:2 * k] = 1e-3, 1.0
        metal[2 * k:3 * k], metal[3 * k:4 * k] = 0.0, 1.0
        rows[4 * k:5 * k, 5] = 1.0
        tangent = torch.nn.functional.normalize(torch.cross(nrm, _unit(g, n), dim=1), dim=1)
        wo[5 * k:6 * k] = torch.nn.functional.normalize(tangent[5 * k:6 * k] + 1e-4 * nrm[5 * k:6 * k])
        wo[6 * k:7 * k] = tangent[6 * k:7 * k]
        nan = float("nan")
        nrm[7 * k:7 * k + 40], wo[7 * k + 40:7 * k + 80] = nan, nan
        rough[7 * k + 80:7 * k + 120], wi[7 * k + 120:7 * k + 160] = nan, nan
        nrm[7 * k + 160:7 * k + 200] = torch.tensor([0.0, 0.0, -1.0])
    p = MatParams(type=torch.from_numpy(types), albedo=rows[:, 0:3], roughness=rough,
                  metallic=metal, ior=rows[:, 5], emit=rows[:, 0:3],
                  normal_map=torch.zeros((n, 3)))
    return (MatParams(*(t.cuda() for t in p)),) + tuple(v.cuda() for v in (nrm, wo, wi))


@pytest.mark.card
@pytest.mark.parametrize("lanes", ["random", "edge"])
def test_kernels_match_plain_on_the_card(lanes):
    """M1 and M2 against their plain versions on the card over every lobe,
    bit for bit and NaN where NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 120_000
    p, nrm, wo, wi = _card_lanes(n, lanes == "edge")
    # a row of the material table: strided albedo, emission and ior
    p = p._replace(albedo=torch.cat([p.albedo, p.ior[:, None], p.roughness[:, None],
                                     p.metallic[:, None]], 1)[:, 0:3])
    lane = torch.arange(n, dtype=torch.int32, device="cuda").flip(0)
    depth = torch.full((), 4, dtype=torch.int32, device="cuda")
    got = sh.scatter_lobes(p, nrm, wo, KEY, 11, depth, lane, 1234)
    want = sh.scatter_lobes_plain(p, nrm, wo, KEY, 11, depth, lane, 1234)
    for name in ("bsdf", "pdf", "dir"):
        assert _same_bits(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.delta, want.delta)
    got_e = sh.eval_lobes(p, nrm, wo, wi)
    for name, a, b in zip(("bsdf", "pdf"), got_e, sh.eval_lobes_plain(p, nrm, wo, wi)):
        assert _same_bits(a, b), name
    assert _lobes() == (1, 1)


@pytest.mark.card
@pytest.mark.parametrize("form", ["int", "one word", "per lane"])
def test_draw_matches_pixel_uniforms_on_the_card(form):
    """M1's draw word for word against utils/rng.py pixel_uniforms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 100_000
    lane = torch.from_numpy(np.random.default_rng(36).permutation(n).astype(np.int32)).cuda()
    it, depth = (x.cuda() if isinstance(x, torch.Tensor) else x
                 for x in _counter_fields(form, n, seed=37))
    for pixel0 in (0, 2**31 - 5):
        got = sh.scatter_draw(KEY, it, depth, lane, pixel0)
        want = rng.pixel_uniforms(KEY, it, depth, rng.STAGE_SCATTER, lane + pixel0, 3)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
