"""A mesh that fits neither kernel table, and `ray_regen` off the kernels.

The JAX package routes a mesh that fits neither its resident budget nor
its streaming split to the XLA walk: `packet_mode` is None
(`pathtracer_tpu/ops/traverse.py:308`) and its Renderer turns
`pallas_traversal` off (`pathtracer_tpu/integrator/render.py:122`).  The
port records that route when it builds the tables and walks the MTBVH
tables.  Such meshes have millions of triangles, so both packages' budgets
are patched to 0 here (`RESIDENT_SMEM_BUDGET` and `STREAM_SMEM_BUDGET`, read
at call time) on the 576-triangle glass torus box of test_torch_render.py:

- the tables equal the JAX package's, with no split, and both packages'
  `packet_mode` is None; `cli info` prints no traversal;
- `closest_hit` and `occlusion_test` take the MTBVH walk even when asked
  for the kernels, with the walk's results; no kernel wrapper is called;
- the Renderer turns `pallas_traversal` off, and its 64x64 MIS render
  (depth 4, 2 spp) is held to the JAX package's under the same patch with
  the slice tolerance; the image with `compaction=False` is bitwise the
  default schedule's, and the shadow sort's;
- regeneration is ignored off the kernels, as the JAX package's staged
  path ignores it: `regen_k` is 0, and `step(2)` with `ray_regen=8`
  advances two iterations and is bitwise the render without it, on this
  route and with `pallas_traversal=False` on the resident tables.
"""

import json

import numpy as np
import pytest
import torch

import pathtracer_tpu.scene.flatscene as jfs
import pathtracer_tpu_torch.scene.flatscene as tfs
from pathtracer_tpu.ops.traverse import packet_mode as jax_packet_mode
from pathtracer_tpu.scene.parser import load_scene as jax_load
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_flatscene import _assert_tables_equal
from tests.test_torch_render import render_and_compare, small_torus_scene

KERNELS = ("closest_hit_wbvh", "occlusion_wbvh", "closest_hit_stream", "closest_hit_blockmajor",
           "occlusion_stream")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as the other port tests that render."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return small_torus_scene(tmp_path_factory.mktemp("fallback"))


@pytest.fixture
def no_table(monkeypatch):
    """Both packages' budgets at 0: the mesh fits neither the resident
    tables nor the streaming split."""
    for fs in (jfs, tfs):
        monkeypatch.setattr(fs, "RESIDENT_SMEM_BUDGET", 0)
        monkeypatch.setattr(fs, "STREAM_SMEM_BUDGET", 0)


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper of ops/traverse.py refuses to be called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called for a mesh no kernel table fits")

    for name in KERNELS:
        monkeypatch.setattr(ttv, name, refuse)


def renderer(scene, **options) -> Renderer:
    r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS, **options),
                 resolution=(64, 64), trace_depth=4, device="cpu")
    r.set_seed(0)
    return r


def torus_rays(n: int, seed: int = 7):
    """Rays from around the torus (centred at (0, 2.2, 0)) toward points near
    its centre: most hit it, some pass through its hole to the walls."""
    rng = np.random.default_rng(seed)
    centre = np.array([0.0, 2.2, 0.0])
    o = centre + rng.uniform(-4.0, 4.0, size=(n, 3))
    d = centre + rng.uniform(-1.5, 1.5, size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def test_tables_and_route(scene, no_table, capsys):
    _, tstatic = _assert_tables_equal(scene)
    assert tstatic.num_tris == 576 and tstatic.stream_subs == 0
    assert ttv.packet_mode(tstatic) is None
    assert tstatic.stream_top_depth == tstatic.stream_sub_depth == 0
    assert jax_packet_mode(jfs.build_flat_scene(jax_load(scene))[1]) is None
    assert cli.main(["info", str(scene), "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["traversal"] is None and info["triangles"] == 576


def test_queries_take_the_walk(scene, no_table, no_kernels):
    """closest_hit / occlusion_test with the kernels asked for give the MTBVH
    walk's answers on a mesh no kernel table fits."""
    flat, static = tfs.build_flat_scene(load_scene(scene), device="cpu")
    o, d = torus_rays(4096)
    hit = ttv.closest_hit(flat, static, o, d)
    walk = ttv.closest_hit(flat, static, o, d, use_kernels=False)
    assert int((hit.tri >= 0).sum()) > 100
    for a, b in zip(hit, walk):
        assert torch.equal(a, b)
    des = o + d * 3.0
    occ = ttv.occlusion_test(flat, static, o, d, des, shadow_sort=True)
    assert 0 < int(occ.sum()) < occ.shape[0]
    assert torch.equal(occ, ttv.occlusion_test(flat, static, o, d, des, use_kernels=False))


def test_render_matches_jax(scene, no_table, no_kernels, monkeypatch):
    calls = {"closest": 0, "occluded": 0}

    def counted(name, key):
        fn = getattr(ttv, name)

        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(ttv, name, wrapper)

    counted("mtbvh_closest", "closest")
    counted("mtbvh_occluded", "occluded")
    port = render_and_compare(scene, SampleMode.MIS)
    assert port.opts.pallas_traversal is False
    assert ttv.packet_mode(port.static) is None
    assert calls["closest"] > 0 and calls["occluded"] > 0


@pytest.mark.parametrize("options", [{}, {"shadow_sort": True, "shrink_half": True}],
                         ids=["default", "shadow_sort"])
def test_schedule_keeps_the_image(scene, options, no_table, no_kernels):
    """The scheduler still sorts the pool (576 triangles), and with the
    option the shadow rays; the walk ignores lane order, so the image is
    the unsorted one bit for bit."""
    a, b = renderer(scene, **options), renderer(scene, compaction=False)
    assert a.opts.compaction and a.opts.pallas_traversal is False
    a.step(2)
    b.step(2)
    assert a.stats.rays_traced == b.stats.rays_traced
    np.testing.assert_array_equal(a.hdr_sum(), b.hdr_sum())


@pytest.mark.parametrize("route", ["no_table", "pallas_traversal=False"])
def test_regen_ignored_off_the_kernels(scene, route, request):
    if route == "no_table":
        request.getfixturevalue("no_table")
        options = {}
    else:
        options = {"pallas_traversal": False}
    a, b = renderer(scene, ray_regen=8, **options), renderer(scene, **options)
    assert a.regen_k == 0 and a.opts.pallas_traversal is False
    a.step(2)
    b.step(2)
    assert a.iteration == b.iteration == 2
    assert a.stats.rays_traced == b.stats.rays_traced
    np.testing.assert_array_equal(a.hdr_sum(), b.hdr_sum())
