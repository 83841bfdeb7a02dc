"""The port's two plain triangle walks beside the kernels: the brute-force
sweep (`use_bvh=False`, the reference's USE_BVH=0) and the threaded MTBVH
walk (`pallas_traversal=False`), for closest hit and any hit, against the
JAX package's `_brute_closest`, `_bvh_closest` and `occlusion_test` on the
same tables and rays, against the port's plain K1/K2, and through an MIS
render against the JAX package's with the same option.

Tolerances as tests/test_torch_traverse.py: triangle ids and occlusion
booleans exactly, t/u/v within rtol 1e-5.  The rays start at random points
in the scene, where exact ties and the zero-direction slab case that
`ray_aabb` and the kernels treat apart have measure zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import traverse as jtv
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import load_scene
from pathtracer_tpu.utils import config as jax_config
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.utils.config import SampleMode
from tests.test_torch_render import render_and_compare, small_torus_scene
from tests.test_torch_traverse import _box_rays, _port, _t, port_static
from tests.test_traverse import random_rays, tri_soup_scene

FLT_MAX = jtv.FLT_MAX
N = 2048


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads (see tests/test_torch_schedule.py)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


BUILDS = {
    # six octant trees, one triangle a leaf (the default)
    "soup mtbvh": dict(),
    # one tree, leaves of up to 4 triangles: the leaf loop and the one-tree walk
    "soup one tree, max_prim 4": dict(use_mtbvh=False, max_prim=4),
}


@pytest.fixture(scope="module", params=list(BUILDS))
def soup(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("soup_modes")
    opts = jax_config.RenderOptions(**BUILDS[request.param])
    flat, static = build_flat_scene(load_scene(tri_soup_scene(tmp, n=300, seed=7)), opts=opts)
    assert static.num_bvh_trees == (1 if "one tree" in request.param else 6)
    return flat, static, _port(flat, static)


@pytest.fixture(scope="module")
def torus_box(tmp_path_factory):
    path = small_torus_scene(tmp_path_factory.mktemp("modes_box"))
    flat, static = build_flat_scene(load_scene(path))
    return path, flat, static, _port(flat, static)


def _init(n, seed):
    """A t budget per lane: most unbounded, some capped (an analytic hit)."""
    t = np.full(n, FLT_MAX, np.float32)
    cap = np.random.default_rng(seed).random(n) < 0.3
    t[cap] = np.random.default_rng(seed + 1).uniform(1.0, 8.0, cap.sum()).astype(np.float32)
    return t


def _same_hits(got, want, min_hits=50):
    t, tri, u, v = (np.asarray(x) for x in got)
    wt, wtri, wu, wv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(tri, wtri)
    hit = tri >= 0
    assert hit.sum() > min_hits
    for a, b in ((t, wt), (u, wu), (v, wv)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t[~hit], wt[~hit])


@pytest.mark.parametrize("walk", ["sweep", "mtbvh"])
def test_closest_matches_jax(soup, walk):
    flat, static, tflat = soup
    o, d = random_rays(N, seed=31)
    t0 = _init(N, 32)
    state = (jnp.asarray(t0), jnp.full((N,), -1, jnp.int32), jnp.zeros((N,), jnp.float32),
             jnp.zeros((N,), jnp.float32))
    if walk == "sweep":
        want = jtv._brute_closest(flat, o, d, *state)
        got = ttv.sweep_closest(tflat, static, _t(o), _t(d), _t(t0))
    else:
        want = jtv._bvh_closest(flat, static, o, d, *state)
        got = ttv.mtbvh_closest(tflat, static, _t(o), _t(d), _t(t0))
    _same_hits(got, want)


@pytest.mark.parametrize("walk", ["sweep", "mtbvh"])
def test_closest_matches_the_plain_k1(soup, walk):
    """The walks find K1's triangles (its plain version on the CPU), t bit
    for bit, on every lane; lanes not live test no triangle."""
    _, static, tflat = soup
    static = port_static(static)
    o, d = (_t(x) for x in random_rays(N, seed=33))
    alive = torch.arange(N) % 6 != 0
    kw = dict(use_bvh=False) if walk == "sweep" else dict(use_kernels=False)
    got = ttv.closest_hit(tflat, static, o, d, alive=alive, **kw)
    want = ttv.closest_hit(tflat, static, o, d, alive=alive)
    assert torch.equal(got.tri, want.tri)
    assert (got.tri[~alive] == -1).all()
    assert int((got.tri >= 0).sum()) > 50
    for name in ("t", "geom", "point", "normal", "uv"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("walk", ["sweep", "mtbvh"])
def test_occlusion_matches_jax_and_the_plain_k2(torus_box, walk):
    _, flat, static, tflat = torus_box
    o, d = _box_rays(N, seed=51)
    des = o + d * np.random.default_rng(52).uniform(0.5, 6.0, size=(N, 1)).astype(np.float32)
    enabled = np.arange(N) % 4 != 0
    jkw = dict(use_bvh=False) if walk == "sweep" else dict(use_pallas=False)
    want = jtv.occlusion_test(flat, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(des),
                              enabled=jnp.asarray(enabled), **jkw)
    kw = dict(use_bvh=False) if walk == "sweep" else dict(use_kernels=False)
    static = port_static(static)
    got = ttv.occlusion_test(tflat, static, _t(o), _t(d), _t(des), enabled=_t(enabled), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 100 < int(got.sum()) < N
    k2 = ttv.occlusion_test(tflat, static, _t(o), _t(d), _t(des), enabled=_t(enabled))
    assert torch.equal(got, k2)
    # the shadow sort is the kernels' alone: the walk ignores it
    srt = ttv.occlusion_test(tflat, static, _t(o), _t(d), _t(des), enabled=_t(enabled),
                             shadow_sort=True, **kw)
    assert torch.equal(srt, got)


@pytest.mark.parametrize("walk", ["sweep", "mtbvh"])
def test_closest_hit_on_the_torus_box_matches_jax(torus_box, walk):
    """closest_hit with the option, analytic walls included, against the
    JAX package's closest_hit with the same option."""
    _, flat, static, tflat = torus_box
    o, d = _box_rays(N, seed=53)
    jkw = dict(use_bvh=False) if walk == "sweep" else dict(use_pallas=False)
    kw = dict(use_bvh=False) if walk == "sweep" else dict(use_kernels=False)
    want = jtv.closest_hit(flat, static, jnp.asarray(o), jnp.asarray(d), **jkw)
    got = ttv.closest_hit(tflat, static, _t(o), _t(d), **kw)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.geom.numpy(), np.asarray(want.geom))
    assert int((got.tri >= 0).sum()) > 100
    for name in ("t", "point", "normal", "uv"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("option", [{"pallas_traversal": False}, {"use_bvh": False}],
                         ids=["mtbvh walk", "sweep"])
def test_mis_render_matches_jax(torus_box, option):
    """An MIS render (64x64, depth 4, 2 spp) with the option against the JAX
    package's render with the same option, within the slice tolerance."""
    render_and_compare(torus_box[0], SampleMode.MIS, **option)
