"""K5, the block-major streaming closest hit, on the CPU.

The mesh is tests/test_torch_stream.py's forced-stream soup: 300 triangles
in blocks of 8 nodes / 48 triangles.

- K5's plain version (what the wrapper runs on CPU tensors) against the
  Pallas kernel `closest_hit_blockmajor_pallas` in interpret mode, at the
  two chunk sizes tests/test_traverse_pallas.py runs it with: triangle ids
  exactly, t within rtol 1e-5 on hits (the JAX test's own tolerance).
- Against K3's plain version on the same rays: t, tri, u and v identical
  on every lane (these rays have no exact-t ties, the only place the two
  visit orders may pick different triangles).
- The DEAD_T sentinel is inert, the root boxes are the top slots that link
  the blocks, and `closest_hit` routes a streamed mesh to K5, never to K3,
  when `STREAM_BLOCKMAJOR` is true.  The stream-forced render with the flag
  on is `test_stream_slice_matches_jax[blockmajor-...]` in
  tests/test_torch_stream.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops.traverse_pallas import closest_hit_blockmajor_pallas
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu_torch.scene.flatscene import flat_from_arrays
from tests.test_torch_stream import (
    DEAD_T,
    FLT_MAX,
    STR_FIELDS,
    _k3,
    _sizes,
    _t,
    stream_soup,  # noqa: F401  (module fixture)
)
from tests.test_traverse import random_rays

# the Pallas kernel takes the top tables and builds the root boxes per call;
# the port's K5 takes the root boxes the scene build made once
PALLAS_FIELDS = tuple(n for n in STR_FIELDS if n != "str_topp")
BM_FIELDS = ("str_roots", "str_subf", "str_subi", "str_subp", "str_subt", "str_base")


def _k5(tflat, static, o, d, t_init):
    return ts.closest_hit_blockmajor(
        *(getattr(tflat, n) for n in BM_FIELDS), _t(o), _t(d), _t(t_init), **_sizes(static),
        sub_depth=static.stream_sub_depth,
    )


def _pallas_k5(jflat, jstatic, o, d, t_init, chunk_rows):
    return closest_hit_blockmajor_pallas(
        *(getattr(jflat, n) for n in PALLAS_FIELDS), o, d, t_init,
        leaf_k=jstatic.wide_leaf_k, **_sizes(jstatic), interpret=True, chunk_rows=chunk_rows,
    )


# chunk_rows=16: one packet per chunk, several chunks; 32: two packets share a chunk
@pytest.mark.parametrize("chunk_rows", [16, 32])
def test_matches_pallas_interpret(stream_soup, chunk_rows):
    jflat, jstatic, tflat, tstatic = stream_soup
    o, d = random_rays(4096, seed=31)
    t_init = jnp.full((4096,), FLT_MAX, jnp.float32)
    pk = _pallas_k5(jflat, jstatic, o, d, t_init, chunk_rows)
    t, tri, u, v = _k5(tflat, tstatic, o, d, t_init)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(pk[1]))
    hits = tri.numpy() >= 0
    assert hits.sum() > 100
    np.testing.assert_allclose(t.numpy()[hits], np.asarray(pk[0])[hits], rtol=1e-5)
    assert (t.numpy()[~hits] == np.float32(FLT_MAX)).all()


@pytest.mark.parametrize("variant", ["full", "dead and t cap"])
def test_matches_k3_plain(stream_soup, variant):
    _, _, tflat, static = stream_soup
    o, d = random_rays(2048, seed=35)
    t_init = np.full(2048, FLT_MAX, np.float32)
    if variant != "full":
        t_init = np.where(np.arange(2048) % 4 == 0, DEAD_T, 6.0).astype(np.float32)
    k3 = _k3(tflat, static, o, d, t_init)
    k5 = _k5(tflat, static, o, d, t_init)
    assert (k3[1] >= 0).sum() > 30
    for a, b in zip(k3, k5):  # t, tri, u, v: lane for lane, bit for bit
        assert torch.equal(a, b)


def test_dead_sentinel_is_inert(stream_soup):
    _, _, tflat, static = stream_soup
    o, d = random_rays(512, seed=32)
    t_init = np.where(np.arange(512) % 2 == 0, DEAD_T, FLT_MAX).astype(np.float32)
    counts = {"box": 0, "tri": 0}
    t, tri, u, v = ts.closest_hit_blockmajor_plain(
        *(getattr(tflat, n) for n in BM_FIELDS), _t(o), _t(d), _t(t_init), **_sizes(static),
        counts=counts)
    dead = t_init < 0
    assert (tri.numpy()[dead] == -1).all() and (t.numpy()[dead] == np.float32(DEAD_T)).all()
    assert (u.numpy()[dead] == 0).all() and (v.numpy()[dead] == 0).all()
    assert (tri.numpy()[~dead] >= 0).any()
    # every live lane pays one root test per block, dead lanes none
    assert counts["box"] >= static.stream_subs * int((~dead).sum())
    all_dead = {"box": 0, "tri": 0}
    ts.closest_hit_blockmajor_plain(
        *(getattr(tflat, n) for n in BM_FIELDS), _t(o), _t(d),
        _t(np.full(512, DEAD_T, np.float32)), **_sizes(static), counts=all_dead)
    assert all_dead == {"box": 0, "tri": 0}


def test_block_roots_are_the_linking_slots(stream_soup):
    """FlatScene.str_roots, built once with the scene, holds block s's box in
    row s: the top slot whose link is -(2+s); flat_from_arrays builds the
    same rows from the JAX package's tables, which lack them."""
    jflat, _, tflat, static = stream_soup
    roots = tflat.str_roots.numpy().reshape(-1, 6)
    boxes = tflat.str_topf.numpy().reshape(-1, 6)
    links = tflat.str_topl.numpy().reshape(-1)
    assert roots.shape == (static.stream_subs, 6) and roots.dtype == np.float32
    for slot in np.nonzero(links < -1)[0]:
        np.testing.assert_array_equal(roots[-(links[slot] + 2)], boxes[slot])
    assert sorted(-(links[links < -1] + 2)) == list(range(static.stream_subs))
    from_jax = flat_from_arrays({k: np.asarray(v) for k, v in jflat._asdict().items()}, "cpu",
                                static)
    assert torch.equal(from_jax.str_roots, tflat.str_roots)


def test_closest_hit_routes_to_k5(stream_soup, monkeypatch):
    _, _, tflat, static = stream_soup
    o, d = random_rays(256, seed=36)
    calls = {"k5": 0}

    def counted(*args, **kwargs):
        calls["k5"] += 1
        return ts.closest_hit_blockmajor(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the block-major path reached K3")

    monkeypatch.setattr(ttv, "closest_hit_blockmajor", counted)
    ref = ttv.closest_hit(tflat, static, _t(o), _t(d))
    assert calls["k5"] == 0  # off by default: K3
    monkeypatch.setattr(ts, "STREAM_BLOCKMAJOR", True)
    monkeypatch.setattr(ttv, "closest_hit_stream", refuse)
    hit = ttv.closest_hit(tflat, static, _t(o), _t(d))
    assert calls["k5"] == 1
    for a, b in zip(ref, hit):
        assert torch.equal(a, b)


def test_wrapper_refuses(stream_soup):
    _, _, tflat, static = stream_soup
    o, d = random_rays(16, seed=38)
    t_init = np.full(16, FLT_MAX, np.float32)
    tables = [getattr(tflat, n) for n in BM_FIELDS]
    with pytest.raises(ValueError, match="stack"):
        ts.closest_hit_blockmajor(*tables, _t(o), _t(d), _t(t_init), **_sizes(static),
                                  sub_depth=10)
    with pytest.raises(ValueError, match="entries"):
        ts.closest_hit_blockmajor(*tables, _t(o), _t(d), _t(t_init),
                                  sub_nodes=static.stream_sub_nodes + 1,
                                  sub_tris=static.stream_sub_tris, sub_depth=1)
    meta = [x.to("meta") for x in (_t(o), _t(d), _t(t_init))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ts.closest_hit_blockmajor(*tables, *meta, **_sizes(static), sub_depth=1)
