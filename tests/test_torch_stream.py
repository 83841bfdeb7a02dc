"""The streaming slice on the CPU: two-level tables, the plain versions of K3
(closest hit) and K4 (shadow any-hit), and a render through them.

- Stream tables equal the JAX package's, array for array, at the default
  budgets on a 40,000-triangle torus (which streams by default) and on the
  300-triangle soup forced onto many small blocks, as
  tests/test_traverse_pallas.py forces it.
- K3/K4's plain versions (what the wrappers run on CPU tensors) against the
  Pallas kernels in interpret mode: triangle ids and occlusion exactly, t
  within rtol 1e-5 (the JAX test's own tolerance).  Against K1/K2's plain
  versions on the same mesh: t and occlusion identical on every lane, tri
  identical (it may differ only on exact-t ties, which these rays do not
  have), since both walk the same boxes in the same per-ray order.
- K4's wrapper with the tables its kernel reads on the card (padded rows,
  per-block rows), and the port's `occlusion_test` on a streamed mesh against
  the JAX package's: booleans, exactly.
- The port's Renderer on the 576-triangle glass torus forced onto the
  streaming path, against the JAX Renderer, with test_torch_render.py's
  image tolerance, in all three modes, with STREAM_BLOCKMAJOR off (K3/K4)
  and on (K5/K4).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu.scene.flatscene as jfs
import pathtracer_tpu_torch.scene.flatscene as tfs
from pathtracer_tpu.ops.traverse_pallas import closest_hit_stream_pallas, occlusion_stream_pallas
from pathtracer_tpu.scene.parser import load_scene as jax_load
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.ops import traverse_cuda as tc
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.config import SampleMode
from tests.test_torch_render import ROOT, render_and_compare, small_torus_scene
from tests.test_traverse import random_rays, tri_soup_scene
from tools.make_torus_obj import ensure_torus_obj

FLT_MAX = 3.402823466e38
DEAD_T = -FLT_MAX
STR_FIELDS = ("str_topf", "str_topl", "str_topp", "str_subf", "str_subi", "str_subp",
              "str_subt", "str_base")
STREAM_STATIC = ("stream_top", "stream_subs", "stream_sub_nodes", "stream_sub_tris",
                 "wide_nodes", "wide_depth", "wide_leaf_k", "num_tris")


def force_stream(mp, *modules):
    """Shrink the resident budget and the block budgets, as
    tests/test_traverse_pallas.py does, so a small mesh splits into many
    blocks."""
    for fs in modules:
        mp.setattr(fs, "RESIDENT_SMEM_BUDGET", 0)
        mp.setattr(fs, "STREAM_SUB_NODES", 8)
        mp.setattr(fs, "STREAM_SUB_TRIS", 48)


def build_both(path):
    jflat, jstatic = jfs.build_flat_scene(jax_load(path))
    tflat, tstatic = tfs.build_flat_scene(load_scene(path), device="cpu")
    return jflat, jstatic, tflat, tstatic


def _walk_depth(links, node, depth=0):
    """Depth of the deepest node below `node`, by plain recursion."""
    kids = [int(c) for c in links[node] if c >= 0]
    return max([depth] + [_walk_depth(links, c, depth + 1) for c in kids])


def assert_stream_tables_equal(jflat, jstatic, tflat, tstatic):
    assert tstatic.stream_subs > 1
    for name in STR_FIELDS:
        a, b = np.asarray(getattr(jflat, name)), getattr(tflat, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b, equal_nan=True), name
    for name in STREAM_STATIC:
        assert getattr(tstatic, name) == getattr(jstatic, name), name
    # the walk depths the K3/K4 wrappers check, against a recursive walk
    S = tstatic.stream_sub_nodes
    subl = tflat.str_subi.numpy().reshape(-1, S, 3, 8)[:, :, 0, :]
    assert tstatic.stream_top_depth == _walk_depth(tflat.str_topl.numpy().reshape(-1, 8), 0) + 1
    assert tstatic.stream_sub_depth == max(_walk_depth(blk, 0) for blk in subl)


@pytest.fixture(scope="module")
def stream_soup(tmp_path_factory):
    path = tri_soup_scene(tmp_path_factory.mktemp("soup_stream"), n=300, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        force_stream(mp, jfs, tfs)
        return build_both(path)


def test_stream_tables_equal_default_budgets(tmp_path):
    ensure_torus_obj(tmp_path / "torus40k.obj", 200, 100)
    text = (ROOT / "scenes" / "glasstorus.txt").read_text()
    scene = tmp_path / "glasstorus40k.txt"
    scene.write_text(text.replace("assets/torus10k.obj", str(tmp_path / "torus40k.obj")))
    jflat, jstatic, tflat, tstatic = build_both(scene)
    assert tstatic.num_tris == 40_000
    assert ttv.packet_mode(tstatic) == "stream"
    assert (tstatic.stream_sub_nodes, tstatic.stream_sub_tris) == (512, 4096)
    assert_stream_tables_equal(jflat, jstatic, tflat, tstatic)


def test_stream_tables_equal_forced(stream_soup):
    assert_stream_tables_equal(*stream_soup)


def test_packet_mode_follows_built_tables(stream_soup, tmp_path, monkeypatch):
    """The route is read from the tables that were built, not from the
    budgets or PT_FORCE_STREAM at call time."""
    _, resident = tfs.build_flat_scene(load_scene(tri_soup_scene(tmp_path, n=300, seed=5)),
                                       device="cpu")
    streamed = stream_soup[3]
    monkeypatch.setenv("PT_FORCE_STREAM", "1")
    assert resident.stream_subs == 0 and ttv.packet_mode(resident) == "resident"
    monkeypatch.delenv("PT_FORCE_STREAM")
    monkeypatch.setattr(tfs, "RESIDENT_SMEM_BUDGET", 10**12)
    assert ttv.packet_mode(streamed) == "stream"


def _t(x):
    return torch.from_numpy(np.array(x))


def _tables(tflat, static, closest=True):
    names = STR_FIELDS if closest else ("str_topf", "str_topl", "str_subf", "str_subi",
                                        "str_subt", "str_base")
    return [getattr(tflat, n) for n in names]


def _sizes(static):
    return dict(sub_nodes=static.stream_sub_nodes, sub_tris=static.stream_sub_tris)


def _k3(tflat, static, o, d, t_init):
    return ts.closest_hit_stream(
        *_tables(tflat, static), _t(o), _t(d), _t(t_init), **_sizes(static),
        top_depth=static.stream_top_depth, sub_depth=static.stream_sub_depth,
    )


def _k4(tflat, static, o, d, min_t, occ0):
    return ts.occlusion_stream(
        *_tables(tflat, static, closest=False), _t(o), _t(d), _t(min_t), _t(occ0),
        **_sizes(static), top_depth=static.stream_top_depth, sub_depth=static.stream_sub_depth,
    )


def _pallas_k3(jflat, jstatic, o, d, t_init):
    return closest_hit_stream_pallas(
        *(getattr(jflat, n) for n in STR_FIELDS), o, d, t_init,
        leaf_k=jstatic.wide_leaf_k, **_sizes(jstatic), interpret=True,
    )


def _pallas_k4(jflat, jstatic, o, d, min_t, occ0):
    return occlusion_stream_pallas(
        *(getattr(jflat, n) for n in STR_FIELDS), o, d, min_t, occ0,
        leaf_k=jstatic.wide_leaf_k, **_sizes(jstatic), interpret=True,
    )


def _shadow_case(m, seed):
    o, d = random_rays(m, seed=seed)
    rng = np.random.default_rng(seed)
    min_t = rng.uniform(0.5, 9.0, m).astype(np.float32)
    occ0 = np.arange(m) % 7 == 0
    return o, d, min_t, occ0


class TestK3Plain:
    def test_matches_pallas_interpret(self, stream_soup):
        jflat, jstatic, tflat, tstatic = stream_soup
        o, d = random_rays(2048, seed=31)
        t_init = jnp.full((2048,), FLT_MAX, jnp.float32)
        pk = _pallas_k3(jflat, jstatic, o, d, t_init)
        t, tri, u, v = _k3(tflat, tstatic, o, d, t_init)
        np.testing.assert_array_equal(tri.numpy(), np.asarray(pk[1]))
        hits = tri.numpy() >= 0
        assert hits.sum() > 50
        for got, want in zip((t, u, v), (pk[0], pk[2], pk[3])):
            np.testing.assert_allclose(got.numpy()[hits], np.asarray(want)[hits], rtol=1e-5, atol=1e-6)
        assert (t.numpy()[~hits] == np.float32(FLT_MAX)).all()

    def test_dead_sentinel_is_inert(self, stream_soup):
        jflat, jstatic, tflat, tstatic = stream_soup
        o, d = random_rays(512, seed=32)
        t_init = np.where(np.arange(512) % 2 == 0, DEAD_T, FLT_MAX).astype(np.float32)
        pk = _pallas_k3(jflat, jstatic, o, d, jnp.asarray(t_init))
        t, tri, u, v = _k3(tflat, tstatic, o, d, t_init)
        dead = t_init < 0
        assert (tri.numpy()[dead] == -1).all() and (t.numpy()[dead] == np.float32(DEAD_T)).all()
        assert (u.numpy()[dead] == 0).all() and (v.numpy()[dead] == 0).all()
        np.testing.assert_array_equal(tri.numpy(), np.asarray(pk[1]))
        assert (tri.numpy()[~dead] >= 0).any()

    @pytest.mark.parametrize("variant", ["full", "dead and t cap"])
    def test_matches_k1(self, stream_soup, variant):
        _, _, tflat, static = stream_soup
        o, d = random_rays(2048, seed=33)
        t_init = np.full(2048, FLT_MAX, np.float32)
        if variant != "full":
            t_init = np.where(np.arange(2048) % 4 == 0, DEAD_T, 6.0).astype(np.float32)
        k1 = tc.closest_hit_wbvh_plain(tflat.bvh_wf, tflat.bvh_wi, tflat.bvh_wp, tflat.tri_pk,
                                       _t(o), _t(d), _t(t_init))
        k3 = _k3(tflat, static, o, d, t_init)
        assert (k1[1] >= 0).sum() > 30
        for a, b in zip(k1, k3):  # t, tri, u, v: lane for lane, bit for bit
            assert torch.equal(a, b)


class TestK4Plain:
    def test_matches_pallas_interpret(self, stream_soup):
        jflat, jstatic, tflat, tstatic = stream_soup
        o, d, min_t, occ0 = _shadow_case(2048, seed=34)
        pk = _pallas_k4(jflat, jstatic, o, d, jnp.asarray(min_t), jnp.asarray(occ0))
        occ = _k4(tflat, tstatic, o, d, min_t, occ0)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(pk))
        assert occ.numpy()[~occ0].any() and not occ.numpy()[~occ0].all()
        assert occ.numpy()[occ0].all()

    def test_dead_sentinel_never_blocks(self, stream_soup):
        jflat, jstatic, tflat, tstatic = stream_soup
        o, d, min_t, occ0 = _shadow_case(512, seed=35)
        min_t = np.where(np.arange(512) % 4 == 1, DEAD_T, min_t).astype(np.float32)
        pk = _pallas_k4(jflat, jstatic, o, d, jnp.asarray(min_t), jnp.asarray(occ0))
        occ = _k4(tflat, tstatic, o, d, min_t, occ0)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(pk))
        assert not occ.numpy()[(min_t < 0) & ~occ0].any()
        assert occ.numpy()[occ0].all()

    def test_matches_k2(self, stream_soup):
        _, _, tflat, static = stream_soup
        o, d, min_t, occ0 = _shadow_case(2048, seed=36)
        min_t = np.where(np.arange(2048) % 4 == 1, DEAD_T, min_t).astype(np.float32)
        k2 = tc.occlusion_wbvh_plain(tflat.bvh_wf, tflat.bvh_wi, tflat.tri_pk, _t(o), _t(d),
                                     _t(min_t), _t(occ0))
        k4 = _k4(tflat, static, o, d, min_t, occ0)
        assert torch.equal(k2, k4)


    def test_wrapper_takes_the_kernel_tables(self, stream_soup):
        """occlusion_test hands K4 the derived tables on every device; on CPU
        tensors the plain version answers from the stream tables alone."""
        _, _, tflat, static = stream_soup
        o, d, min_t, occ0 = _shadow_case(512, seed=39)
        got = ts.occlusion_stream(
            *_tables(tflat, static, closest=False), _t(o), _t(d), _t(min_t), _t(occ0),
            **_sizes(static), top_depth=static.stream_top_depth,
            sub_depth=static.stream_sub_depth, subt12=tflat.str_subt12, blocks=tflat.str_blocks)
        assert torch.equal(got, _k4(tflat, static, o, d, min_t, occ0))
        with pytest.raises(ValueError, match="stack"):
            ts.occlusion_stream(*_tables(tflat, static, closest=False), _t(o), _t(d), _t(min_t),
                                _t(occ0), **_sizes(static), top_depth=10, sub_depth=0)

    @pytest.mark.parametrize("masked", [False, True], ids=["all lanes", "enabled mask"])
    def test_occlusion_test_matches_jax(self, stream_soup, masked):
        """The NEE shadow layer on a streamed mesh, port against JAX package."""
        from pathtracer_tpu.ops import traverse as jtv

        jflat, jstatic, tflat, tstatic = stream_soup
        assert ttv.packet_mode(tstatic) == "stream"
        o, d = random_rays(1024, seed=44)
        des = o + d * np.random.default_rng(44).uniform(0.5, 9.0, size=(1024, 1)).astype(np.float32)
        enabled = np.arange(1024) % 4 != 0 if masked else None
        want = jtv.occlusion_test(jflat, jstatic, o, d, des,
                                  enabled=None if enabled is None else jnp.asarray(enabled))
        got = ttv.occlusion_test(tflat, tstatic, _t(o), _t(d), _t(des),
                                 enabled=None if enabled is None else _t(enabled))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < 1024
        if masked:
            assert not got.numpy()[~enabled].any()


def test_walk_counts_match_k1(stream_soup):
    """The plain walks count the same box and triangle tests on both table
    layouts (the bound in chip_smoke.py is computed from these counts)."""
    _, _, tflat, static = stream_soup
    o, d = random_rays(1024, seed=37)
    t_init = _t(np.full(1024, FLT_MAX, np.float32))
    c1, c3 = {"box": 0, "tri": 0}, {"box": 0, "tri": 0}
    tc.closest_hit_wbvh_plain(tflat.bvh_wf, tflat.bvh_wi, tflat.bvh_wp, tflat.tri_pk,
                              _t(o), _t(d), t_init, counts=c1)
    ts.closest_hit_stream_plain(*_tables(tflat, static), _t(o), _t(d), t_init,
                                **_sizes(static), counts=c3)
    assert c1 == c3 and c1["box"] > 0 and c1["tri"] > 0


def test_wrappers_refuse(stream_soup):
    _, _, tflat, static = stream_soup
    o, d = random_rays(16, seed=38)
    t_init = np.full(16, FLT_MAX, np.float32)
    with pytest.raises(ValueError, match="stack"):
        ts.closest_hit_stream(*_tables(tflat, static), _t(o), _t(d), _t(t_init),
                              **_sizes(static), top_depth=10, sub_depth=0)
    with pytest.raises(ValueError, match="entries"):
        ts.closest_hit_stream(*_tables(tflat, static), _t(o), _t(d), _t(t_init),
                              sub_nodes=static.stream_sub_nodes + 1,
                              sub_tris=static.stream_sub_tris, top_depth=1, sub_depth=1)
    meta = [x.to("meta") for x in (_t(o), _t(d), _t(t_init))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ts.closest_hit_stream(*_tables(tflat, static), *meta, **_sizes(static),
                              top_depth=1, sub_depth=1)


@pytest.fixture(scope="module")
def torus_scene(tmp_path_factory):
    return small_torus_scene(tmp_path_factory.mktemp("stream_slice"))


@pytest.mark.parametrize("mode", [SampleMode.BSDF, SampleMode.DIRECT_LI, SampleMode.MIS])
@pytest.mark.parametrize("blockmajor", [False, True], ids=["packetmajor", "blockmajor"])
def test_stream_slice_matches_jax(torus_scene, mode, blockmajor, monkeypatch):
    """K3/K4 by default; K5/K4 with STREAM_BLOCKMAJOR, and then K3 never."""
    force_stream(monkeypatch, tfs)
    monkeypatch.setattr(ts, "STREAM_BLOCKMAJOR", blockmajor)
    calls = {"closest": 0, "occlusion": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def refuse(*args, **kwargs):
        raise AssertionError("a streamed scene reached a kernel of the other path")

    closest = "closest_hit_blockmajor" if blockmajor else "closest_hit_stream"
    unused = "closest_hit_stream" if blockmajor else "closest_hit_blockmajor"
    monkeypatch.setattr(ttv, closest, counted("closest", getattr(ttv, closest)))
    monkeypatch.setattr(ttv, unused, refuse)
    monkeypatch.setattr(ttv, "occlusion_stream", counted("occlusion", ttv.occlusion_stream))
    monkeypatch.setattr(ttv, "closest_hit_wbvh", refuse)
    monkeypatch.setattr(ttv, "occlusion_wbvh", refuse)
    port = render_and_compare(torus_scene, mode)
    assert port.static.stream_subs > 1 and ttv.packet_mode(port.static) == "stream"
    assert calls["closest"] > 0
    assert (calls["occlusion"] > 0) == (mode != SampleMode.BSDF)


def test_cli_info_names_the_path(torus_scene, monkeypatch, capsys):
    assert cli.main(["info", str(torus_scene), "--device", "cpu"]) == 0
    resident = json.loads(capsys.readouterr().out)
    assert resident["traversal"] == "resident" and resident["stream_blocks"] == 0
    force_stream(monkeypatch, tfs)
    assert cli.main(["info", str(torus_scene), "--device", "cpu"]) == 0
    stream = json.loads(capsys.readouterr().out)
    assert stream["traversal"] == "stream" and stream["stream_blocks"] > 1
    assert stream["stream_block_nodes"] == 8 and stream["stream_top_nodes"] >= 1
