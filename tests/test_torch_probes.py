"""The timing probes P1 and P2 (`pathtracer_tpu_torch/ops/probes.py`) on the
CPU, at small lap counts.

- P2: each variant's plain version (what the wrapper runs on CPU tensors)
  against the TPU probe's own kernel, `make_kernel(variant)` of
  tools/kernel_microbench.py, run by a `pl.pallas_call` with `run`'s specs
  and `interpret=True`, the module's F patched small (24 pops, 640 for the
  loop and load variants so that `i & 255` and `i % M` wrap); inputs from numpy with
  seed 0, as `run` makes them.  The probe starts its accumulator at 1e30,
  where every lap's contribution rounds away, so the test wraps the
  module's `fori_loop` to start both at 0 (50 for leaf_mt, where the start
  is the cap a hit must beat), and the outputs agree exactly.  Where the
  two probes' semantics differ, the inputs are chosen so that they agree:
  the votes (any1, aabb_any, push_branchless) are the warp's on the card
  and the tile's on the TPU, so every warp holds the same 32 lanes;
  push_packed's TPU probe takes the max of the packed bits where the card
  takes their OR, which agree when every lane is the same; aabb's TPU
  probe drops each box test's result, which the card's adds, so its boxes
  lie behind every lane.  A numpy restatement of the card's semantics
  holds the vote variants and aabb on the probe's own inputs.
- P1: tools/rowprim_probe.py runs its kernel when imported, so the plain
  version is held to a numpy restatement of its `kernel` (:27-51) at a few
  laps, within rtol 1e-6 (the restatement sums rows in numpy's order, the
  plain version in the card's order), and bit for bit to a numpy
  restatement of the card's order (one warp per row, 4 lanes a thread, a
  shuffle tree, a tree over the rows) at lap counts that are not a multiple
  of the kernel's ring of stages.
- The bound on one SM that chip_smoke.py holds each probe's time to
  (`probe_bound`), on fixed counts and clocks.
"""

import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import pathtracer_tpu.utils
from pathtracer_tpu_torch.ops import probes

F_SMALL = 24
# the loop and load variants run past `i & 255` and twice round the 311 nodes
F_WRAP = 640
LOOPS = ("loop_empty", "while_empty", "loop_and", "loop_only", "loads", "loads4")


@pytest.fixture(scope="module")
def microbench():
    """tools/kernel_microbench.py, imported without its persistent compile
    cache (its import would point JAX at a cache directory outside the
    checkout)."""
    fake = types.SimpleNamespace(enable=lambda *a, **k: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "pathtracer_tpu.utils.jaxcache", fake)
        mp.setattr(pathtracer_tpu.utils, "jaxcache", fake, raising=False)
        mp.delitem(sys.modules, "tools.kernel_microbench", raising=False)
        return importlib.import_module("tools.kernel_microbench")


def pallas_pop(kmb, variant, leaf_k, pool, wf, wi, tr):
    """`run`'s pallas_call, in interpret mode."""
    R, L = kmb.TILE_ROWS, kmb.TILE_LANES
    fn = pl.pallas_call(
        kmb.make_kernel(variant, leaf_k),
        grid=(1,),
        in_specs=[
            *[pl.BlockSpec((1, R, L), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
              for _ in range(3)],
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((1, R, L), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, R, L), jnp.float32),
        scratch_shapes=[
            pltpu.SMEM((kmb.M * 48,), jnp.float32),
            pltpu.SMEM((kmb.M * 24,), jnp.int32),
            pltpu.VMEM((kmb.NT, 12), jnp.float32),
            pltpu.SMEM((64,), jnp.int32),
            pltpu.SemaphoreType.DMA((3,)),
        ],
        interpret=True,
    )
    p = jnp.asarray(pool)[:, None]
    return np.asarray(fn(p[0], p[1], p[2], jnp.asarray(wf), jnp.asarray(wi), jnp.asarray(tr)))[0]


def test_pop_inputs_are_the_probes(microbench):
    pool, wf, wi, tr = probes.pop_inputs()
    assert (probes.POP_M, probes.POP_NT, probes.POP_F) == (microbench.M, microbench.NT,
                                                          microbench.F)
    assert (probes.POP_ROWS, probes.POP_LANES) == (microbench.TILE_ROWS, microbench.TILE_LANES)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(wf.numpy(), rng.uniform(-5, 5, microbench.M * 48).astype(np.float32))
    assert wi.dtype == torch.int32 and tuple(tr.shape) == (microbench.NT, 12)
    assert tuple(pool.shape) == (3, 16, 128)


def _start(variant):
    return 50.0 if variant == "leaf_mt" else 0.0


def _pool_for(variant, pool):
    """The lanes on which the card's and the TPU's semantics of `variant`
    agree: every warp the same 32 lanes for a warp vote, every lane the same
    for push_packed (max of the bits = their OR), else the probe's pool."""
    lanes = pool.reshape(3, -1)
    if variant in ("any1", "aabb_any", "push_branchless"):
        lanes = lanes[:, :probes.WARP].repeat(1, lanes.shape[1] // probes.WARP)
    elif variant == "push_packed":
        # lane 10 pushes 21 children in F_SMALL pops from a start of 0
        # (lane 0 none, which would leave the output at its start)
        lanes = lanes[:, 10:11].expand_as(lanes)
    return lanes.reshape(pool.shape).contiguous()


@pytest.mark.parametrize("variant", probes.P2_VARIANTS)
def test_pop_matches_pallas_interpret(microbench, monkeypatch, variant):
    acc0 = _start(variant)
    fori = jax.lax.fori_loop
    patched = types.SimpleNamespace(
        fori_loop=lambda lo, hi, body, init: fori(lo, hi, body, jnp.float32(acc0)),
        while_loop=jax.lax.while_loop)
    monkeypatch.setattr(microbench, "jax", types.SimpleNamespace(lax=patched))
    F = F_WRAP if variant in LOOPS else F_SMALL
    monkeypatch.setattr(microbench, "F", F)
    pool, wf, wi, tr = probes.pop_inputs()
    pool = _pool_for(variant, pool)
    if variant == "aabb":  # every box behind every lane: no box test is taken
        wf = -wf.abs() - 0.1
    leaf_k = probes.POP_LEAF_K if variant == "leaf_mt" else 0
    want = pallas_pop(microbench, variant, leaf_k, pool.numpy(), wf.numpy(), wi.numpy(),
                      tr.numpy())
    got = probes.pop(variant, pool, wf, wi, tr, F=F, leaf_k=leaf_k, acc0=acc0)
    assert got.shape == (16, 128) and got.dtype == torch.float32
    assert (want != np.float32(acc0)).any()  # the laps show in the output
    if variant == "leaf_mt":
        # the same lanes take a hit; XLA's CPU build of the interpreted
        # kernel rounds a few t (4 of 2,048 lanes) one ulp apart from the
        # card's operation order, which the plain version keeps
        np.testing.assert_array_equal(got.numpy() != acc0, want != acc0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _np_slab(box, o, inv):
    lo = (box[0:3, None] - o) * inv
    hi = (box[3:6, None] - o) * inv
    te = np.minimum(lo, hi).max(0)
    tx = np.maximum(lo, hi).min(0)
    return (te <= tx) & (tx > 0), te


def np_pop(variant, pool, wf, wi, tr, F, leaf_k, acc0):
    """The card's semantics of P2, restated in numpy (float32 throughout)."""
    f = np.float32
    o = pool.reshape(3, -1)
    inv = f(1) / np.maximum(o, f(0.1))
    m = wf.size // 48
    warp_any = lambda a: np.repeat(a.reshape(-1, 32).any(1), 32)  # noqa: E731
    acc = np.full(o.shape[1], acc0, f)
    out_r = np.zeros(o.shape[1], f)
    for i in range(F):
        node = i % m
        box = lambda c: wf[node * 48 + c * 6: node * 48 + c * 6 + 6]  # noqa: E731
        if variant == "any1":
            hit, te = _np_slab(box(0), o, inv)
            acc = acc + warp_any(hit & (te <= acc)).astype(f)
        elif variant == "aabb":
            for c in range(8):
                hit, te = _np_slab(box(c), o, inv)
                acc = acc + (wi[node * 24 + c] + (hit & (te <= acc))).astype(f) * f(1e-30)
        elif variant == "aabb_any":
            n_any = np.zeros(o.shape[1], np.int32)
            for c in range(8):
                hit, te = _np_slab(box(c), o, inv)
                n_any += warp_any(hit & (te <= acc))
            acc = acc + n_any.astype(f) * f(1e-30)
        elif variant in ("push_branchless", "push_packed"):  # a ballot's bit c is slot c's any
            sp = np.zeros(o.shape[1], np.int32)
            for c in range(8):
                hit, te = _np_slab(box(c), o, inv)
                sp += warp_any(hit & (te <= acc)) & (wi[node * 24 + c] >= 0)
            acc = acc + sp.astype(f) * f(1e-30)
        elif variant == "leaf_mt":
            for k in range(leaf_k):
                v = tr[min(node * 8 + k, tr.shape[0] - 1)]
                e1, e2 = v[3:6] - v[0:3], v[6:9] - v[0:3]
                p = np.cross(o.T, e2).T
                det = e1 @ p
                inv_det = f(1) / np.where(det == 0, f(1), det)
                tv = o - v[0:3, None]
                u = (tv * p).sum(0) * inv_det
                q = np.cross(tv.T, e1).T
                w = (o * q).sum(0) * inv_det
                t = (e2 @ q) * inv_det
                hit = (det != 0) & (t >= 0) & (u >= 0) & (w >= 0) & (1 - u - w >= 0)
                out_r = np.where(hit & (t < acc), t, out_r)
    return (out_r + acc).reshape(16, 128)


@pytest.mark.parametrize(
    "variant", ["aabb", "any1", "aabb_any", "push_branchless", "push_packed", "leaf_mt"])
def test_pop_at_zero_start_matches_numpy(variant):
    """On the probe's own pool and tables, from a start of 0 (50 for
    leaf_mt), where the warp votes, push_packed's OR and aabb's box results
    show in the output; the box and triangle arithmetic is restated in
    numpy's own operation order, so t within rtol 1e-5."""
    acc0 = _start(variant)
    pool, wf, wi, tr = probes.pop_inputs()
    got = probes.pop(variant, pool, wf, wi, tr, F=F_SMALL, acc0=acc0).numpy()
    want = np_pop(variant, *(x.numpy() for x in (pool, wf, wi, tr)), F_SMALL,
                  probes.POP_LEAF_K, np.float32(acc0))
    assert len(np.unique(got)) > 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize(
    "variant", ["loads", "loads4", "aabb", "any1", "aabb_any", "push_branchless", "push_packed"])
def test_only_the_small_start_shows_which_nodes_are_read(variant):
    """Why chip_smoke.py phase 9 holds the node variants to their plain
    versions past the wrap of the node index from a small start: from the
    probe's start 1e30 absorbs every pop's addend, so the result is the same
    whichever nodes a pop reads; from 0 it is not."""
    pool, wf, wi, tr = probes.pop_inputs()
    tables = ((wf, wi), (torch.roll(wf, -48), torch.roll(wi, -24)))  # node k+1 in node k's place
    big, other = (probes.pop(variant, pool, a, b, tr, F=8) for a, b in tables)
    assert torch.equal(big, other)
    assert torch.equal(big, torch.full_like(big, probes.POP_ACC0))
    small, other = (probes.pop(variant, pool, a, b, tr, F=8, acc0=0.0) for a, b in tables)
    assert not torch.equal(small, other)
    assert chip_smoke.P2_WRAP_F > probes.POP_M  # the node index wraps in every variant


def np_rowprim(tab, rays, laps):
    """tools/rowprim_probe.py `kernel` (:27-51), restated in numpy."""
    m = tab.shape[0]
    acc = np.float32(0)
    for i in range(laps):
        tab8 = np.stack([tab[(i * 8 + r * 37) % m] for r in range(8)])
        hit_bits = np.zeros((8, 1), np.int32)
        for c in range(8):
            lo, hi = tab8[:, c:c + 1], tab8[:, 64 + c:65 + c]
            anyc = ((rays > lo) & (rays < hi)).any(axis=1, keepdims=True)
            hit_bits = hit_bits + (anyc.astype(np.int32) << c)
        s = np.int32(hit_bits[:, 0].sum())
        acc = acc + np.sum(tab8, dtype=np.float32) + np.float32(s)
    return np.float32(acc)


def test_rowprim_matches_numpy():
    tab, rays = probes.rowprim_inputs()
    assert tuple(tab.shape) == (1024, 128) and tuple(rays.shape) == (8, 128)
    got = probes.rowprim(tab, rays, laps=40)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    want = np_rowprim(tab.numpy(), rays.numpy(), 40)
    np.testing.assert_allclose(float(got[0, 0]), float(want), rtol=1e-6)


def _np_card_row_sum(tab8):
    """The sum of an (8, 128) lap as the card adds it: thread j of row r's
    warp holds lanes 4j .. 4j+3 and adds (x0 + x1) + (x2 + x3); a shuffle
    tree over the warp (lane j takes lane j + 16, then j + 8, ...); then the
    8 row sums in a tree (row r takes row r + 4, then r + 2, then r + 1)."""
    q = tab8.reshape(8, 32, 4)
    v = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    for off in (16, 8, 4, 2, 1):
        v = v[:, :off] + v[:, off:2 * off]
    w = v[:, 0]
    for off in (4, 2, 1):
        w = w[:off] + w[off:2 * off]
    return w[0]


def np_rowprim_card(tab, rays, laps):
    """P1 as the card computes it, in numpy: the row words' sum exactly, the
    rows' sum in the card's order, acc = (acc + sum) + words."""
    m = tab.shape[0]
    acc = np.float32(0)
    for i in range(laps):
        tab8 = np.stack([tab[(i * 8 + r * 37) % m] for r in range(8)])
        words = 0
        for r in range(8):
            for c in range(8):
                words += int(((rays[r] > tab8[r, c]) & (rays[r] < tab8[r, 64 + c])).any()) << c
        acc = np.float32(acc + _np_card_row_sum(tab8)) + np.float32(words)
    return np.float32(acc)


def test_rowprim_tree_sum_is_the_cards_order():
    """The plain version's row sum adds as the card does (`_np_card_row_sum`),
    and on values of mixed magnitude that order differs from a left-to-right
    sum, so the test tells orders apart."""
    rng = np.random.default_rng(3)
    x = (rng.random((8, 128)) * 10.0 ** rng.integers(-3, 4, (8, 128))).astype(np.float32)
    got = probes._row_sum(torch.from_numpy(x))
    want = _np_card_row_sum(x)
    assert got.dtype == torch.float32
    assert np.float32(got.item()).tobytes() == want.tobytes()
    left_to_right = np.float32(0)
    for v in x.reshape(-1):
        left_to_right = np.float32(left_to_right + v)
    assert left_to_right != want


@pytest.mark.parametrize("laps", [1, 3, 5])
def test_rowprim_plain_is_the_cards_order(laps):
    """At lap counts under and not a multiple of the kernel's 4 stages, the
    plain version (what the card's result is held to) is bitwise the numpy
    restatement of the card's order."""
    tab, rays = probes.rowprim_inputs()
    got = probes.rowprim(tab, rays, laps=laps)
    want = np_rowprim_card(tab.numpy(), rays.numpy(), laps)
    assert np.float32(got[0, 0].item()).tobytes() == want.tobytes()


def test_rowprim_inside_by_differences_is_exact():
    """P1's kernel decides lo < r < hi for any of a thread's 4 values by
    differences and min/max (csrc/probes.cu any_inside): per value the
    NaN-propagating min of r - lo and hi - r, then the NaN-dropping max of
    the 4 against 0.  In float32 without flush to zero that equals the
    comparisons for every input: +-0, subnormals, the largest floats, +-inf
    and NaN among them."""
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 0.5, 1.0, -1.0, 1.0000001,
                        3.4e38, -3.4e38, np.inf, -np.inf, np.nan], np.float32)
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(np.concatenate([special, rng.standard_normal(25).astype(np.float32)]))
    r, lo, hi = torch.meshgrid(vals, vals, vals, indexing="ij")
    inside = torch.minimum(r - lo, hi - r) > 0
    assert torch.equal(inside, (r > lo) & (r < hi))
    picks = torch.from_numpy(rng.integers(0, len(vals), (20000, 6)))
    r4, lo, hi = vals[picks[:, :4]], vals[picks[:, 4]], vals[picks[:, 5]]
    a = torch.minimum(r4 - lo[:, None], hi[:, None] - r4)
    got = torch.fmax(torch.fmax(a[:, 0], a[:, 1]), torch.fmax(a[:, 2], a[:, 3])) > 0
    want = ((r4 > lo[:, None]) & (r4 < hi[:, None])).any(dim=1)
    assert torch.equal(got, want) and want.any() and not want.all()


# clocks a lap of each probe's three terms on one SM: (operations, bytes, chain)
BOUND_CLOCKS = {
    "P1": (33801 / 128, 4096 / 128, 8),
    "loop_empty": (1, 0, 4), "while_empty": (3, 0, 4), "loop_and": (3, 0, 4),
    "loop_only": (3, 0, 4), "loads": (65, 224 / 128, 4), "loads4": (257, 896 / 128, 4),
    "aabb": (232, 224 / 128, 96), "any1": (28, 24 / 128, 16), "aabb_any": (219, 192 / 128, 24),
    "push_branchless": (227, 224 / 128, 24), "push_packed": (236, 224 / 128, 24),
    "leaf_mt": (496, 288 / 128, 4),
}


@pytest.mark.parametrize("probe", ["P1", *probes.P2_VARIANTS])
def test_probe_bound_on_one_sm(probe):
    """chip_smoke.probe_bound: each term in clocks a lap from the probe's
    counts, the largest binds, and the bound in ms is its clocks times the
    laps at the sampled clock."""
    assert set(chip_smoke.PROBE_COUNTS) == set(BOUND_CLOCKS)
    b = chip_smoke.probe_bound(probe, 2000, 1980.0)
    want = dict(zip(("operations", "bytes", "chain"), BOUND_CLOCKS[probe]))
    assert b["clocks"] == pytest.approx(want, rel=1e-12)
    assert b["by"] == max(want, key=want.get)
    assert b["clocks_per_lap"] == pytest.approx(want[b["by"]], rel=1e-12)
    assert b["ms"] == pytest.approx(want[b["by"]] * 2000 / 1.98e6, rel=1e-12)
    # half the clock, twice the time
    assert chip_smoke.probe_bound(probe, 2000, 990.0)["ms"] == pytest.approx(2 * b["ms"], rel=1e-12)


def test_wrappers_refuse():
    pool, wf, wi, tr = probes.pop_inputs()
    with pytest.raises(ValueError, match="unknown P2 variant"):
        probes.pop("push4_packed", pool, wf, wi, tr, F=1)
    with pytest.raises(ValueError, match="pool"):
        probes.pop("loads", pool[:, :8], wf, wi, tr, F=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        probes.pop("loads", *(x.to("meta") for x in (pool, wf, wi, tr)), F=1)
    with pytest.raises(ValueError, match="leaf_k >= 0"):
        probes.pop("leaf_mt", pool, wf, wi, tr, F=1, leaf_k=-1)
    tab, rays = probes.rowprim_inputs()
    with pytest.raises(ValueError, match="table"):
        probes.rowprim(tab[:, :64], rays, laps=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        probes.rowprim(tab.to("meta"), rays.to("meta"), laps=1)
