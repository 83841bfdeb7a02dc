"""Traversal parity: the plain versions of K1/K2 (what the wrappers run on
CPU tensors) against the Pallas kernels in interpret mode and the XLA walk,
and the port's closest_hit / occlusion_test against the JAX package's.

Tolerances: triangle ids and occlusion booleans exactly; t, u, v within
rtol=1e-5 (XLA may round the Möller-Trumbore sums differently in the last
bit).  Mirrors tests/test_traverse_pallas.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import traverse as jtv
from pathtracer_tpu.ops.traverse_pallas import closest_hit_wbvh_pallas, occlusion_wbvh_pallas
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import load_scene
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.ops import traverse_cuda as tc
from pathtracer_tpu_torch.scene.flatscene import SceneStatic, flat_from_arrays
from tests.test_torch_render import small_torus_scene
from tests.test_traverse import random_rays, tri_soup_scene

FLT_MAX = jtv.FLT_MAX


def _port(flat, static):
    return flat_from_arrays({k: np.asarray(v) for k, v in flat._asdict().items()}, "cpu", static)


def port_static(static) -> SceneStatic:
    """The port's SceneStatic for the JAX package's, of resident tables: the
    same fields, and the route that the JAX package's `packet_mode` reads
    from the budgets at call time and the port records when it builds the
    tables (`traversal`)."""
    assert static.stream_subs == 0  # the streaming walk's depths are the port's alone
    return SceneStatic(**dataclasses.asdict(static), traversal=jtv.packet_mode(static))


@pytest.fixture(scope="module")
def soup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("soup_torch")
    flat, static = build_flat_scene(load_scene(tri_soup_scene(tmp, n=200, seed=3)))
    return flat, static, _port(flat, static)


def _t(x):
    return torch.from_numpy(np.array(x))


def _k1(tflat, static, o, d, t_init):
    return tc.closest_hit_wbvh(
        tflat.bvh_wf, tflat.bvh_wi, tflat.bvh_wp, tflat.tri_pk, _t(o), _t(d),
        _t(t_init), wide_depth=static.wide_depth,
    )


def _k2(tflat, static, o, d, min_t, occ0):
    return tc.occlusion_wbvh(
        tflat.bvh_wf, tflat.bvh_wi, tflat.tri_pk, _t(o), _t(d), _t(min_t), _t(occ0),
        wide_depth=static.wide_depth,
    )


class TestClosestPlain:
    def test_matches_pallas_interpret_and_xla(self, soup):
        flat, static, tflat = soup
        o, d = random_rays(2048, seed=21)
        t_init = jnp.full((2048,), FLT_MAX, jnp.float32)
        pk = closest_hit_wbvh_pallas(
            flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk, o, d, t_init,
            leaf_k=static.wide_leaf_k, interpret=True,
        )
        xla = jtv.closest_hit(flat, static, o, d)
        t, tri, u, v = _k1(tflat, static, o, d, t_init)
        np.testing.assert_array_equal(tri.numpy(), np.asarray(pk[1]))
        np.testing.assert_array_equal(tri.numpy(), np.asarray(xla.tri))
        hits = tri.numpy() >= 0
        assert hits.sum() > 50
        for got, want in zip((t, u, v), (pk[0], pk[2], pk[3])):
            np.testing.assert_allclose(got.numpy()[hits], np.asarray(want)[hits], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.numpy()[hits], np.asarray(xla.t)[hits], rtol=1e-5)
        assert (t.numpy()[~hits] == np.float32(FLT_MAX)).all()

    def test_respects_t_init(self, soup):
        _, static, tflat = soup
        o, d = random_rays(1024, seed=22)
        _, tri, _, _ = _k1(tflat, static, o, d, np.full(1024, 1e-3, np.float32))
        assert (tri.numpy() == -1).all()
        # a partial cap keeps exactly the hits closer than it
        full_t, full_tri, _, _ = _k1(tflat, static, o, d, np.full(1024, FLT_MAX, np.float32))
        cap = np.float32(6.0)
        t, tri, _, _ = _k1(tflat, static, o, d, np.full(1024, cap, np.float32))
        closer = (full_tri.numpy() >= 0) & (full_t.numpy() < cap)
        np.testing.assert_array_equal(tri.numpy(), np.where(closer, full_tri.numpy(), -1))

    def test_dead_sentinel_is_inert(self, soup):
        _, static, tflat = soup
        o, d = random_rays(1024, seed=26)
        t, tri, u, v = _k1(tflat, static, o, d, np.full(1024, -FLT_MAX, np.float32))
        assert (tri.numpy() == -1).all()
        assert (t.numpy() == np.float32(-FLT_MAX)).all()
        assert not u.numpy().any() and not v.numpy().any()

    def test_empty_slots_never_entered(self, soup):
        # poison every empty (NaN) child slot with a link far past the table:
        # a walk that entered one would index out of range
        flat, static, tflat = soup
        wf = tflat.bvh_wf.view(-1, 8, 6)
        empty = torch.isnan(wf).any(-1)
        assert empty.any(), "soup has no empty child slots"
        wi = tflat.bvh_wi.clone().view(-1, 3, 8)
        wi[:, 0][empty] = 10**6
        o, d = random_rays(2048, seed=21)
        base = _k1(tflat, static, o, d, np.full(2048, FLT_MAX, np.float32))
        got = tc.closest_hit_wbvh_plain(
            tflat.bvh_wf, wi.view(-1), tflat.bvh_wp, tflat.tri_pk, _t(o), _t(d),
            torch.full((2048,), FLT_MAX),
        )
        for a, b in zip(base, got):
            assert torch.equal(a, b)
        nan_box = torch.full((1, 6), float("nan"))
        hit, _ = tc.slab(nan_box, *(torch.zeros(1),) * 3, *(torch.ones(1),) * 3)
        assert not hit.any()

    @pytest.mark.parametrize("n", [1, 127, 1000])
    def test_pool_sizes(self, soup, n):
        flat, static, tflat = soup
        o, d = random_rays(n, seed=23)
        ref = jtv.closest_hit(flat, static, o, d)
        t, tri, _, _ = _k1(tflat, static, o, d, np.full(n, FLT_MAX, np.float32))
        assert t.shape == (n,)
        np.testing.assert_array_equal(tri.numpy(), np.asarray(ref.tri))


class TestOcclusionPlain:
    def test_matches_pallas_interpret(self, soup):
        flat, static, tflat = soup
        o, d = random_rays(2048, seed=24)
        des = o + d * 3.0
        min_t = jnp.linalg.norm(des - o, axis=-1)
        occ0 = jnp.zeros((2048,), bool)
        want = occlusion_wbvh_pallas(
            flat.bvh_wf, flat.bvh_wi, flat.tri_pk, o, d, min_t, occ0,
            leaf_k=static.wide_leaf_k, interpret=True,
        )
        got = _k2(tflat, static, o, d, min_t, occ0)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtv.occlusion_test(flat, static, o, d, des)))
        assert 0 < got.sum() < 2048

    @pytest.mark.parametrize("case", ["plain", "occluded0 every 7th", "25% at -FLT_MAX",
                                      "min_t clamped short"])
    def test_kernel_order_gives_the_same_lanes(self, soup, case):
        """The kernel's walk (a node's leaf cuts before its inner children, out
        at the first blocker), restated in numpy, against the plain version's
        slot order on a resident mesh: the same bool on every lane."""
        from tests.test_torch_walk_tables import WideTables, _shadow_rays, any_hit_walk

        _, static, tflat = soup
        o, d, min_t, occ0 = _shadow_rays(tflat, case, m=512)
        got, _, deepest = any_hit_walk(WideTables(tflat), o, d, min_t, occ0)
        np.testing.assert_array_equal(got, _k2(tflat, static, o, d, min_t, occ0).numpy())
        assert 0 < got[~occ0].sum() < (~occ0).sum()
        assert deepest <= 7 * static.wide_depth + 1

    def test_pre_occluded_preserved(self, soup):
        _, static, tflat = soup
        o, d = random_rays(1024, seed=25)
        got = _k2(tflat, static, o, d, np.full(1024, 3.0, np.float32), np.ones(1024, bool))
        assert got.all()

    def test_disabled_sentinel_never_blocks(self, soup):
        _, static, tflat = soup
        o, d = random_rays(1024, seed=27)
        got = _k2(tflat, static, o, d, np.full(1024, -FLT_MAX, np.float32), np.zeros(1024, bool))
        assert not got.any()


class TestWrappers:
    def test_unsupported_device_raises(self, soup):
        _, static, tflat = soup
        meta = torch.zeros((4, 3), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            tc.closest_hit_wbvh(tflat.bvh_wf, tflat.bvh_wi, tflat.bvh_wp, tflat.tri_pk,
                                meta, meta, torch.zeros(4, device="meta"),
                                wide_depth=static.wide_depth)
        with pytest.raises(ValueError, match="cpu or cuda"):
            tc.occlusion_wbvh(tflat.bvh_wf, tflat.bvh_wi, tflat.tri_pk, meta, meta,
                              torch.zeros(4, device="meta"),
                              torch.zeros(4, dtype=torch.bool, device="meta"),
                              wide_depth=static.wide_depth)

    def test_stack_depth_guard(self, soup):
        _, _, tflat = soup
        o = torch.zeros((2, 3))
        with pytest.raises(ValueError, match="stack"):
            tc.closest_hit_wbvh(tflat.bvh_wf, tflat.bvh_wi, tflat.bvh_wp, tflat.tri_pk,
                                o, o, torch.zeros(2), wide_depth=tc.STACK // 7 + 1)

    def test_occlusion_stack_depth_guard(self, soup):
        _, _, tflat = soup
        o = torch.zeros((2, 3))
        with pytest.raises(ValueError, match="stack"):
            tc.occlusion_wbvh(tflat.bvh_wf, tflat.bvh_wi, tflat.tri_pk, o, o, torch.zeros(2),
                              torch.zeros(2, dtype=torch.bool), wide_depth=tc.STACK // 7 + 1)

    def test_cpu_tensors_never_count_a_launch(self, soup, monkeypatch):
        _, static, tflat = soup
        monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.LAUNCHES, 0))
        o, d = random_rays(64, seed=5)
        _k1(tflat, static, o, d, np.full(64, FLT_MAX, np.float32))
        _k2(tflat, static, o, d, np.full(64, 2.0, np.float32), np.zeros(64, bool))
        assert (_build.launches["K1"], _build.launches["K2"]) == (0, 0)


@pytest.fixture(scope="module")
def torus_box(tmp_path_factory):
    path = small_torus_scene(tmp_path_factory.mktemp("torus_box"))
    flat, static = build_flat_scene(load_scene(path))
    return flat, static, _port(flat, static)


def _box_rays(n, seed):
    """Rays from inside the Cornell box, toward anywhere."""
    g = np.random.default_rng(seed)
    o = g.uniform([-4.5, 0.5, -4.5], [4.5, 9.0, 4.5], size=(n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_closest_hit_matches_jax(torus_box):
    flat, static, tflat = torus_box
    o, d = _box_rays(2048, seed=40)
    alive = np.arange(2048) % 5 != 0
    want = jtv.closest_hit(flat, static, jnp.asarray(o), jnp.asarray(d))
    got = ttv.closest_hit(tflat, port_static(static), _t(o), _t(d), alive=_t(alive))
    a = alive
    np.testing.assert_array_equal(got.geom.numpy()[a], np.asarray(want.geom)[a])
    np.testing.assert_array_equal(got.tri.numpy()[a], np.asarray(want.tri)[a])
    assert (got.tri.numpy()[a] >= 0).sum() > 100
    # dead lanes skip the triangles but keep their analytic hit
    assert (got.tri.numpy()[~a] == -1).all()
    for name in ("t", "point", "normal", "uv", "tangent", "bitangent"):
        np.testing.assert_allclose(getattr(got, name).numpy()[a], np.asarray(getattr(want, name))[a],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_occlusion_test_matches_jax(torus_box):
    flat, static, tflat = torus_box
    o, d = _box_rays(2048, seed=41)
    des = o + d * np.random.default_rng(42).uniform(0.5, 6.0, size=(2048, 1)).astype(np.float32)
    enabled = np.arange(2048) % 4 != 0
    want = jtv.occlusion_test(flat, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(des),
                              enabled=jnp.asarray(enabled))
    got = ttv.occlusion_test(tflat, port_static(static), _t(o), _t(d), _t(des),
                             enabled=_t(enabled))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < 2048


def test_intersect_primitives_match_jax(torus_box):
    """ray_sphere / ray_cube (object space, 1e-4 pull-back, world t),
    ray_triangle and ray_aabb against the JAX package."""
    from pathtracer_tpu.ops import intersect as ji
    from pathtracer_tpu_torch.ops import intersect as ti

    flat, static, tflat = torus_box
    o, d = _box_rays(2048, seed=43)
    for gi, gtype in enumerate(static.geom_types):
        if gtype == 2:  # OBJ
            continue
        fn = "ray_sphere" if gtype == 0 else "ray_cube"
        mats = (flat.geom_transform[gi], flat.geom_inv[gi], flat.geom_invt[gi])
        want = getattr(ji, fn)(*mats, jnp.asarray(o), jnp.asarray(d))
        got = getattr(ti, fn)(*(torch.from_numpy(np.array(m)) for m in mats), _t(o), _t(d))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        v = got[0].numpy()
        for a, b in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v], rtol=1e-5, atol=1e-5)
    tri = np.array(flat.tri_data[:64])
    verts = [tri[:, k:k + 3] for k in (0, 3, 6)]
    want = ji.ray_triangle(*map(jnp.asarray, verts), jnp.asarray(o[:64]), jnp.asarray(d[:64]))
    got = ti.ray_triangle(*map(torch.from_numpy, verts), _t(o[:64]), _t(d[:64]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    lo, hi = np.float32([-1, 0, -1]), np.float32([1, 2, 1])
    d0 = d.copy()
    d0[::3, 0] = 0.0  # zero components take the origin-containment fallback
    want = ji.ray_aabb(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o), jnp.asarray(d0))
    got = ti.ray_aabb(torch.from_numpy(lo), torch.from_numpy(hi), _t(o), _t(d0))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    h = got[0].numpy()
    np.testing.assert_allclose(got[1].numpy()[h], np.asarray(want[1])[h], rtol=1e-6)
