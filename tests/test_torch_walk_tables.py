"""What surrounds the redesigned kernels K1/K3 (closest hit) and K2/K4 (shadow
any-hit), on the CPU.

The CUDA kernels run only on the card.  Here:

- the two tables K3 reads beside the stream tables (`FlatScene.str_subt12`,
  `str_blocks`, built by `scene/flatscene.py stream_walk_tables`) against
  the tables they derive from: padded rows equal `str_subt` row for row, a
  block's row holds `str_base`, its first row and the wrapped-leaf rule with
  its [start, end); every row the kernels read as a vector is 16-byte
  aligned;
- `tagged_walk`, a numpy restatement of K3's kernel (csrc/walk_core.cuh over
  csrc/stream_traverse.cu StreamTables: one stack of tagged entries, flat
  s*S + m block rows, the derived tables, all eight slab tests before any
  branch, the cap read again at each visit), against
  `closest_hit_stream_plain` on t, tri, u and v exactly,
  and through it against the JAX package's `closest_hit_stream_pallas` in
  interpret mode (triangle ids exactly, t/u/v within rtol 1e-5, as
  tests/test_torch_stream.py compares them);
- the same restatement over the wide tables (K1's instantiation) against
  `closest_hit_wbvh_plain`, exactly;
- the stack bound 7*(top_depth + sub_depth) + 1 of the tagged walk, against
  the deepest stack the restatement reaches and against the wrapper's check;
- `any_hit_walk`, a numpy restatement of K2's and K4's kernel
  (csrc/walk_core.cuh any_hit_rays: the pass mask at min_t, a node's leaf
  cuts before its inner children, out at the first blocker, the tagged stack
  over `str_subt12`/`str_blocks` or the wide tables), against
  `occlusion_stream_plain` and `occlusion_wbvh_plain`, which visit in slot
  order, and against the JAX package's `occlusion_stream_pallas` and
  `occlusion_wbvh_pallas` in interpret mode: booleans, exactly, on every
  lane; its stack against the same bound, and K4's wrapper's checks;
- `blockmajor_walk`, a numpy restatement of K5's kernel
  (csrc/stream_traverse.cu closest_hit_blockmajor_kernel: groups of blocks
  culled by their union box, the root test, and inside a block the tagged
  walk of `tagged_walk` from the block's root entry), against
  `closest_hit_blockmajor_plain` with and without its cull, bit for bit, and
  against the JAX package's `closest_hit_blockmajor_pallas` in interpret
  mode; the cull tables (`str_roots8`, `str_groups`) against `str_roots`,
  and K5's wrapper's checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu.scene.flatscene as jfs
import pathtracer_tpu_torch.scene.flatscene as tfs
from pathtracer_tpu_torch.ops import traverse_cuda as tc
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu.ops.traverse_pallas import (
    closest_hit_blockmajor_pallas,
    occlusion_wbvh_pallas,
)
from pathtracer_tpu_torch.scene.parser import load_scene
from tests.test_torch_stream import (
    DEAD_T,
    FLT_MAX,
    STR_FIELDS,
    _pallas_k3,
    _pallas_k4,
    _sizes,
    _t,
    build_both,
    force_stream,
)
from tests.test_traverse import random_rays, tri_soup_scene

F = np.float32


# ---------------------------------------------------------------------------
# scenes


@pytest.fixture(scope="module")
def multi_block(tmp_path_factory):
    """300 triangles over 15 blocks of 8 nodes / 48 triangles: two top nodes,
    five blocks that wrap one leaf cut."""
    path = tri_soup_scene(tmp_path_factory.mktemp("walk_multi"), n=300, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        force_stream(mp, jfs, tfs)
        return build_both(path)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """3,000 triangles over 239 blocks of 16 nodes / 48 triangles: a top tree
    three levels deep over blocks with inner nodes of their own."""
    path = tri_soup_scene(tmp_path_factory.mktemp("walk_deep"), n=3000, seed=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfs, "RESIDENT_SMEM_BUDGET", 0)
        mp.setattr(tfs, "STREAM_SUB_NODES", 16)
        mp.setattr(tfs, "STREAM_SUB_TRIS", 48)
        return tfs.build_flat_scene(load_scene(path), device="cpu")


@pytest.fixture(scope="module")
def forced_env(tmp_path_factory):
    """A resident-size mesh sent down the streaming path by PT_FORCE_STREAM,
    at the default block sizes (512 nodes / 4,096 triangles)."""
    path = tri_soup_scene(tmp_path_factory.mktemp("walk_env"), n=300, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_FORCE_STREAM", "1")
        return build_both(path)


# ---------------------------------------------------------------------------
# the derived tables


def _derived_checks(flat, static):
    n_sub, S, Tmax = static.stream_subs, static.stream_sub_nodes, static.stream_sub_tris
    rows12 = flat.str_subt12.numpy().reshape(n_sub * Tmax, 12)
    rows9 = flat.str_subt.numpy().reshape(n_sub * Tmax, 9)
    assert rows12.dtype == np.float32
    np.testing.assert_array_equal(rows12[:, :9], rows9)
    assert not rows12[:, 9:].any()
    blocks = flat.str_blocks.numpy().reshape(n_sub, 4)
    assert blocks.dtype == np.int32
    np.testing.assert_array_equal(blocks[:, 0], flat.str_base.numpy())
    np.testing.assert_array_equal(blocks[:, 1], np.arange(n_sub) * Tmax)
    subi = flat.str_subi.numpy().reshape(n_sub, S, 24)
    for s in range(n_sub):
        root = subi[s, 0]
        # the rule of the kernels' wrapped_leaf (csrc/stream_traverse.cu)
        wrapped = root[1] < 0 and root[16 + 1] <= root[8 + 1]
        want = (s * Tmax + root[8], s * Tmax + root[16]) if wrapped else (-1, -1)
        assert tuple(blocks[s, 2:]) == want, s
    return blocks


@pytest.mark.parametrize("scene", ["multi_block", "forced_env", "deep"])
def test_derived_tables_equal_their_sources(scene, request):
    built = request.getfixturevalue(scene)
    flat, static = built[-2:]
    blocks = _derived_checks(flat, static)
    if scene == "multi_block":
        assert (blocks[:, 2] >= 0).sum() >= 2 and (blocks[:, 2] < 0).sum() >= 2


def test_flat_from_arrays_derives_them(multi_block):
    """The JAX package's tables lack the derived ones; flat_from_arrays builds
    the same rows from them."""
    jflat, jstatic, tflat, _ = multi_block
    from_jax = tfs.flat_from_arrays({k: np.asarray(v) for k, v in jflat._asdict().items()}, "cpu",
                                    jstatic)
    assert torch.equal(from_jax.str_subt12, tflat.str_subt12)
    assert torch.equal(from_jax.str_blocks, tflat.str_blocks)


def test_resident_scene_has_placeholder_rows(tmp_path):
    flat, static = tfs.build_flat_scene(
        load_scene(tri_soup_scene(tmp_path, n=60, seed=2)), device="cpu")
    assert static.stream_subs == 0
    assert flat.str_subt12.numel() * 9 == flat.str_subt.numel() * 12
    assert flat.str_blocks.tolist() == [0, 0, -1, -1]


@pytest.mark.parametrize("scene", ["multi_block", "deep"])
def test_vector_rows_are_16_byte_aligned(scene, request):
    """Every row the kernels load as float4/int4: a node's 48 box floats and
    its 8 links (first of 24 ints; a top node's 8), a 12-float triangle row,
    a block's 4 ints; and the wrappers' own check."""
    flat = request.getfixturevalue(scene)[-2]
    for name, row_items in (("bvh_wf", 48), ("bvh_wi", 24), ("tri_pk", 12), ("str_topf", 48),
                            ("str_topl", 8), ("str_subf", 48), ("str_subi", 24),
                            ("str_subt12", 12), ("str_blocks", 4)):
        t = getattr(flat, name)
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
        assert (row_items * t.element_size()) % 16 == 0, name
    tc._check_aligned(wf=flat.bvh_wf, tri12=flat.tri_pk)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tc._check_aligned(wf=flat.bvh_wf[1:])
    # str_subt's rows (36 bytes) are what the padded copy is for
    assert (9 * flat.str_subt.element_size()) % 16 != 0


# ---------------------------------------------------------------------------
# the numpy restatement of the kernels' walk


def _slab8(boxes, o, inv):
    """The 8 slab tests of one node: (hit, t_enter), NaN-propagating."""
    with np.errstate(invalid="ignore"):
        lo = (boxes[:, 0:3] - o) * inv
        hi = (boxes[:, 3:6] - o) * inv
        near, far = np.minimum(lo, hi), np.maximum(lo, hi)
        te = np.maximum(np.maximum(near[:, 0], near[:, 1]), near[:, 2])
        tx = np.minimum(np.minimum(far[:, 0], far[:, 1]), far[:, 2])
        return (te <= tx) & (tx > 0), te


def _moller_trumbore(rows, o, d):
    """csrc/traverse_common.cuh moller_trumbore on (K, 12) rows, in float32."""
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    px = d[1] * e2[:, 2] - d[2] * e2[:, 1]
    py = d[2] * e2[:, 0] - d[0] * e2[:, 2]
    pz = d[0] * e2[:, 1] - d[1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv_det = F(1.0) / np.where(det == 0, F(1.0), det)
    tx, ty, tz = o[0] - v0[:, 0], o[1] - v0[:, 1], o[2] - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv_det
    hit = (det != 0) & (t >= 0) & (u >= 0) & (v >= 0) & (F(1.0) - u - v >= 0)
    return hit, t, u, v


class WideTables:
    """csrc/wbvh_traverse.cu WideTables: an entry is a node id."""

    root = 0

    def __init__(self, flat):
        self.wf = flat.bvh_wf.numpy().reshape(-1, 8, 6)
        self.wi = flat.bvh_wi.numpy().reshape(-1, 24)
        self.wp = flat.bvh_wp.numpy().reshape(-1, 8)
        self.tri = flat.tri_pk.numpy().reshape(-1, 12)

    def node(self, e):
        return self.wf[e], self.wi[e], self.wp[e]

    def inner(self, e, link):
        return int(link)

    def child(self, e, ints, slot, link):
        """("push", entry) or ("leaf", lo, hi)."""
        if link >= 0:
            return "push", int(link)
        return "leaf", int(ints[8 + slot]), int(ints[16 + slot])

    def tri_id(self, row):
        return row


class StreamTables:
    """csrc/stream_traverse.cu StreamTables: an entry is ~t for top node t, or
    the flat row s*S + m of block s's node m."""

    root = ~0

    def __init__(self, flat, static):
        self.S, self.Tmax = static.stream_sub_nodes, static.stream_sub_tris
        self.topf = flat.str_topf.numpy().reshape(-1, 8, 6)
        self.topl = flat.str_topl.numpy().reshape(-1, 8)
        self.topp = flat.str_topp.numpy().reshape(-1, 8)
        self.subf = flat.str_subf.numpy().reshape(-1, 8, 6)
        self.subi = flat.str_subi.numpy().reshape(-1, 24)
        self.subp = flat.str_subp.numpy().reshape(-1, 8)
        self.tri = flat.str_subt12.numpy().reshape(-1, 12)
        self.blocks = flat.str_blocks.numpy().reshape(-1, 4)

    def node(self, e):
        if e < 0:
            return self.topf[~e], self.topl[~e], self.topp[~e]
        return self.subf[e], self.subi[e], self.subp[e]

    def inner(self, e, link):
        return ~int(link) if e < 0 else e // self.S * self.S + int(link)

    def child(self, e, ints, slot, link):
        if e < 0:
            if link >= 0:
                return "push", ~int(link)
            if link == -1:
                return "leaf", 0, 0
            s = -(int(link) + 2)
            _, _, lo, hi = self.blocks[s]
            return ("push", s * self.S) if lo < 0 else ("leaf", int(lo), int(hi))
        s = e // self.S
        if link >= 0:
            return "push", s * self.S + int(link)
        return "leaf", s * self.Tmax + int(ints[8 + slot]), s * self.Tmax + int(ints[16 + slot])

    def tri_id(self, row):
        base, row0, _, _ = self.blocks[row // self.Tmax]
        return int(base) + row - int(row0)


class _Ray:
    """One ray as the kernels hold it: origin, direction, reciprocal, octant."""

    def __init__(self, o, d):
        self.o, self.d = o.astype(F), d.astype(F)
        with np.errstate(divide="ignore"):
            self.inv = F(1.0) / self.d
        self.octant = int(self.d[0] > 0) | int(self.d[1] > 0) << 1 | int(self.d[2] > 0) << 2


def closest_walk(tb, ray, e, best):
    """csrc/walk_core.cuh closest_walk for one ray from entry `e` until the
    stack is empty again; `best` is [t, row, u, v], updated in place.
    Returns the deepest stack reached."""
    stack, deepest = [], 0
    while True:
        boxes, ints, perms = tb.node(e)
        perm = int(perms[ray.octant])
        hit, te = _slab8(boxes, ray.o, ray.inv)
        passed = hit & (te <= best[0])  # all eight, before any branch
        for rank in range(7, -1, -1):  # far -> near
            slot = (perm >> (3 * rank)) & 7
            if not passed[slot] or not te[slot] <= best[0]:  # the cap as it is now
                continue
            kind, *what = tb.child(e, ints, slot, ints[slot])
            if kind == "push":
                stack.append(what[0])
                deepest = max(deepest, len(stack))
                continue
            closest_leaf(tb, ray, *what, best)
        if not stack:
            return deepest
        e = stack.pop()


def closest_leaf(tb, ray, lo, hi, best):
    """csrc/walk_core.cuh closest_leaf: rows [lo, hi), in cut order, strictly
    closer wins."""
    if hi > lo:
        th, tt, tu, tv = _moller_trumbore(tb.tri[lo:hi], ray.o, ray.d)
        for k in range(hi - lo):
            if th[k] and tt[k] < best[0]:
                best[:] = [tt[k], lo + k, tu[k], tv[k]]


def _results(tb, t_init, bests):
    n = len(bests)
    out_t, out_tri = t_init.astype(F).copy(), np.full(n, -1, np.int32)
    out_u, out_v = np.zeros(n, F), np.zeros(n, F)
    for i, best in enumerate(bests):
        if best is None:
            continue
        out_t[i], out_u[i], out_v[i] = best[0], best[2], best[3]
        if best[1] >= 0:
            out_tri[i] = tb.tri_id(best[1])
    return out_t, out_tri, out_u, out_v


def tagged_walk(tb, o, d, t_init):
    """csrc/walk_core.cuh closest_hit_rays, ray by ray: (t, tri, u, v) and the
    deepest stack any ray reached."""
    bests, deepest = [], 0
    for i in range(o.shape[0]):
        if not t_init[i] >= 0:
            bests.append(None)
            continue
        best = [F(t_init[i]), -1, F(0), F(0)]
        deepest = max(deepest, closest_walk(tb, _Ray(o[i], d[i]), tb.root, best))
        bests.append(best)
    return _results(tb, t_init, bests), deepest


def _k3_plain(flat, static, o, d, t_init):
    return ts.closest_hit_stream_plain(*(getattr(flat, n) for n in STR_FIELDS), _t(o), _t(d),
                                       _t(t_init), **_sizes(static))


def _assert_bitwise(got, want):
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        b = b.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=name)


def _rays(flat, m, seed):
    """m rays: every other one aimed at a triangle of the mesh from a random
    origin (so that many lanes hit), the rest tests/test_traverse.py's random
    rays (mostly misses)."""
    o, d = (np.array(x) for x in random_rays(m, seed=seed))
    rng = np.random.default_rng(seed)
    rows = flat.tri_pk.numpy()[rng.integers(0, flat.tri_pk.shape[0], m)]
    target = rows[:, 0:3] + (rows[:, 3:6] + rows[:, 6:9]) * F(1 / 3)
    aimed = target - o
    aimed /= np.linalg.norm(aimed, axis=1, keepdims=True)
    d[::2] = aimed[::2].astype(F)
    return o.astype(F), d


def _axis_rays(flat, m):
    """Rays along the axes (two direction components exactly 0), half of them
    starting exactly on a bound of some child box, where 0 * inf = NaN rejects
    the box."""
    rng = np.random.default_rng(41)
    boxes = flat.str_subf.numpy().reshape(-1, 6)
    boxes = boxes[~np.isnan(boxes).any(1)]
    o = rng.uniform(-1.0, 1.0, (m, 3)).astype(F)
    pick = boxes[rng.integers(0, boxes.shape[0], m)]
    on_bound = np.arange(m) % 2 == 0
    axis = rng.integers(0, 3, m)
    d = np.zeros((m, 3), F)
    d[np.arange(m), axis] = rng.choice(np.array([-1.0, 1.0], F), m)
    # origin inside the box's slab on the two still axes; on even lanes
    # exactly on its lower bound on one of them
    for i in range(m):
        lo, hi = pick[i, 0:3], pick[i, 3:6]
        o[i] = (lo + hi) * F(0.5)
        o[i, axis[i]] = lo[axis[i]] - F(3.0) * d[i, axis[i]]
        if on_bound[i]:
            still = (axis[i] + 1) % 3
            o[i, still] = lo[still]
    return o, d


CASES = ["forced by PT_FORCE_STREAM", "multi-block", "dead lanes", "t cap", "axis-aligned rays",
         "wrapped leaf cuts", "deep"]


@pytest.mark.parametrize("case", CASES)
def test_tagged_walk_equals_k3_plain(case, request):
    """The restated kernel walk against closest_hit_stream_plain, bit for bit
    on t, tri, u and v on every lane."""
    scene = {"forced by PT_FORCE_STREAM": "forced_env", "deep": "deep"}.get(case, "multi_block")
    flat, static = request.getfixturevalue(scene)[-2:]
    m = 384
    o, d = _rays(flat, m, seed=51 + CASES.index(case))
    t_init = np.full(m, FLT_MAX, F)
    if case == "dead lanes":
        t_init = np.where(np.arange(m) % 3 == 0, DEAD_T, FLT_MAX).astype(F)
    elif case == "t cap":
        t_init = np.where(np.arange(m) % 4 == 0, DEAD_T, 6.0).astype(F)
    elif case == "axis-aligned rays":
        o, d = _axis_rays(flat, m)
    want = _k3_plain(flat, static, o, d, t_init)
    got, _ = tagged_walk(StreamTables(flat, static), o, d, t_init)
    _assert_bitwise(got, want)
    hits = got[1] >= 0
    assert hits.sum() > 50 and (~hits).sum() > 0
    if case == "dead lanes":
        dead = t_init < 0
        assert (got[1][dead] == -1).all() and (got[0][dead] == F(DEAD_T)).all()
    if case == "t cap":
        full, _ = tagged_walk(StreamTables(flat, static), o, d, np.full(m, FLT_MAX, F))
        assert (got[0][hits] < 6.0).all() and (full[1] >= 0).sum() > hits.sum()
    if case == "axis-aligned rays":
        assert (d == 0).sum() == 2 * m
    if case == "wrapped leaf cuts":
        # some hit lies in a block that wraps one leaf cut, tested off a top node
        blocks = flat.str_blocks.numpy().reshape(-1, 4)
        owner = np.searchsorted(np.sort(blocks[:, 0]), got[1][hits], side="right") - 1
        wrapped = (blocks[np.argsort(blocks[:, 0]), 2] >= 0)[owner]
        assert wrapped.any() and not wrapped.all()


@pytest.mark.parametrize("scene", ["multi_block", "forced_env"])
def test_tagged_walk_matches_pallas_interpret(scene, request):
    """Through the plain version to the JAX package's kernel: triangle ids
    exactly, t/u/v within rtol 1e-5 (tests/test_torch_stream.py's tolerance:
    XLA may round the Möller-Trumbore sums differently in the last bit)."""
    jflat, jstatic, flat, static = request.getfixturevalue(scene)
    m = 2048  # the rays of tests/test_torch_stream.py's comparison
    o, d = random_rays(m, seed=31)
    t_init = np.full(m, FLT_MAX, F)
    pk = _pallas_k3(jflat, jstatic, o, d, jnp.asarray(t_init))
    got, _ = tagged_walk(StreamTables(flat, static), np.asarray(o), np.asarray(d), t_init)
    np.testing.assert_array_equal(got[1], np.asarray(pk[1]))
    hits = got[1] >= 0
    assert hits.sum() > 50
    for a, b in zip((got[0], got[2], got[3]), (pk[0], pk[2], pk[3])):
        np.testing.assert_allclose(a[hits], np.asarray(b)[hits], rtol=1e-5, atol=1e-6)
    assert (got[0][~hits] == F(FLT_MAX)).all()


@pytest.mark.parametrize("variant", ["full", "dead and t cap"])
def test_tagged_walk_over_wide_tables_equals_k1_plain(multi_block, variant):
    """K1's instantiation of the same walk, against closest_hit_wbvh_plain;
    and K3's against it lane for lane (the stream split loses no triangle)."""
    _, _, flat, static = multi_block
    m = 384
    o, d = _rays(flat, m, seed=71)
    t_init = np.full(m, FLT_MAX, F)
    if variant != "full":
        t_init = np.where(np.arange(m) % 4 == 0, DEAD_T, 6.0).astype(F)
    want = tc.closest_hit_wbvh_plain(flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk,
                                     _t(o), _t(d), _t(t_init))
    k1, deepest = tagged_walk(WideTables(flat), o, d, t_init)
    _assert_bitwise(k1, want)
    assert deepest <= 7 * static.wide_depth + 1
    k3, _ = tagged_walk(StreamTables(flat, static), o, d, t_init)
    for a, b in zip(k1, k3):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the stack bound of the tagged walk


@pytest.mark.parametrize("scene", ["multi_block", "deep", "forced_env"])
def test_stack_bound_holds(scene, request):
    """No ray's stack grows past 7*(top_depth + sub_depth) + 1, and the
    bound is the depth of the tables walked as one tree."""
    flat, static = request.getfixturevalue(scene)[-2:]
    o, d = _rays(flat, 256, seed=81)
    _, deepest = tagged_walk(StreamTables(flat, static), o, d, np.full(256, FLT_MAX, F))
    depth = static.stream_top_depth + static.stream_sub_depth
    assert 0 < deepest <= 7 * depth + 1

    # the deepest node of the one tree, by plain recursion over the entries
    tb = StreamTables(flat, static)

    def below(e, level):
        _, ints, _ = tb.node(e)
        kids = [tb.child(e, ints, slot, ints[slot]) for slot in range(8)
                if ints[slot] >= 0 or (e < 0 and ints[slot] < -1)]
        return max([level] + [below(k[1], level + 1) for k in kids if k[0] == "push"])

    assert below(tb.root, 0) <= depth
    if scene == "deep":
        assert static.stream_top_depth >= 2 and static.stream_sub_depth >= 1


def test_wrapper_checks_the_one_stack(multi_block):
    """K3's wrapper holds top_depth + sub_depth against its one stack (each of
    them alone would fit), before it looks at the device."""
    _, _, flat, static = multi_block
    o, d = random_rays(8, seed=82)
    args = [getattr(flat, n) for n in STR_FIELDS] + [_t(o), _t(d), _t(np.full(8, FLT_MAX, F))]
    assert 7 * (5 + 4) + 1 <= ts.STACK < 7 * (5 + 5) + 1
    ts.closest_hit_stream(*args, **_sizes(static), top_depth=5, sub_depth=4)
    with pytest.raises(ValueError, match="stack of 71"):
        ts.closest_hit_stream(*args, **_sizes(static), top_depth=5, sub_depth=5)
    # K5 has a block stack alone
    ts._check_block_depth(5)
    # on a CUDA tensor the kernel needs the derived tables; the check comes
    # before any device work, so a meta tensor shows the order of the checks
    meta = [x.to("meta") for x in args[-3:]]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ts.closest_hit_stream(*args[:-3], *meta, **_sizes(static), top_depth=1, sub_depth=1)


# ---------------------------------------------------------------------------
# the any-hit walk of K2 and K4


def any_hit_walk(tb, o, d, min_t, occ0):
    """csrc/walk_core.cuh any_hit_rays, ray by ray: the (N,) bool, the row of
    the triangle that blocked each lane (-1: none, or blocked on entry) and
    the deepest stack any ray reached."""
    n = o.shape[0]
    occ = occ0.copy()
    blocker = np.full(n, -1, np.int64)
    deepest = 0
    for i in range(n):
        mt = F(min_t[i])
        if occ[i] or not mt >= 0:
            continue
        oi, di = o[i].astype(F), d[i].astype(F)
        with np.errstate(divide="ignore"):
            inv = F(1.0) / di
        t_far = mt - F(1e-5)
        stack, e = [], tb.root
        while not occ[i]:
            boxes, ints, _ = tb.node(e)  # the child order is never read
            hit, te = _slab8(boxes, oi, inv)
            passed = hit & (te <= mt)  # final: min_t never changes
            inner = ints[:8] >= 0
            for slot in np.flatnonzero(passed & ~inner):  # leaf cuts and block links first
                kind, *what = tb.child(e, ints, slot, ints[slot])
                if kind == "push":
                    stack.append(what[0])
                    deepest = max(deepest, len(stack))
                    continue
                lo, hi = what
                if hi > lo:
                    th, tt, _, _ = _moller_trumbore(tb.tri[lo:hi], oi, di)
                    blocks = th & (t_far > tt) & (np.abs(tt - mt) > F(1e-4))
                    if blocks.any():
                        occ[i], blocker[i] = True, lo + int(np.argmax(blocks))
                        break
            if occ[i]:
                break  # before anything else is pushed
            for slot in np.flatnonzero(passed & inner):
                stack.append(tb.inner(e, ints[slot]))
            deepest = max(deepest, len(stack))
            if not stack:
                break
            e = stack.pop()
    return occ, blocker, deepest


def _k4_plain(flat, static, o, d, min_t, occ0):
    names = ("str_topf", "str_topl", "str_subf", "str_subi", "str_subt", "str_base")
    return ts.occlusion_stream_plain(*(getattr(flat, n) for n in names), _t(o), _t(d), _t(min_t),
                                     _t(occ0), **_sizes(static)).numpy()


def _k2_plain(flat, o, d, min_t, occ0):
    return tc.occlusion_wbvh_plain(flat.bvh_wf, flat.bvh_wi, flat.tri_pk, _t(o), _t(d),
                                   _t(min_t), _t(occ0)).numpy()


SHADOW_CASES = ["plain", "occluded0 every 7th", "25% at -FLT_MAX", "min_t clamped short",
                "axis-aligned rays", "blocker in a wrapped leaf cut"]


def _shadow_rays(flat, case, m=384):
    """m shadow rays for `case`: (o, d, min_t, occluded0).  Every other ray is
    aimed at a triangle and reaches past it (min_t in [0.5, 9))."""
    seed = 91 + SHADOW_CASES.index(case)
    o, d = _rays(flat, m, seed=seed)
    min_t = np.random.default_rng(seed).uniform(0.5, 9.0, m).astype(F)
    occ0 = np.zeros(m, bool)
    if case == "occluded0 every 7th":
        occ0 = np.arange(m) % 7 == 0
    elif case == "25% at -FLT_MAX":
        min_t = np.where(np.arange(m) % 4 == 1, DEAD_T, min_t).astype(F)
    elif case == "min_t clamped short":
        min_t = np.minimum(min_t, F(2.5))
    elif case == "axis-aligned rays":
        o, d = _axis_rays(flat, m)
    return o, d, min_t, occ0


def _check_shadow_case(case, got, blocker, full, o, d, min_t, occ0):
    """What each case is there to show, beyond equality with the plain version."""
    assert got[~occ0].any() and not got[~occ0].all()
    if case == "occluded0 every 7th":
        assert got[occ0].all() and (blocker[occ0] == -1).all()
    if case == "25% at -FLT_MAX":
        assert (min_t < 0).sum() == len(min_t) // 4 and not got[min_t < 0].any()
    if case == "min_t clamped short":
        # the cap cuts blockers off: lanes blocked within 9.0 (`full`) are clear now
        assert (full & ~got).sum() > 5 and not (got & ~full).any()
    if case == "axis-aligned rays":
        assert (d == 0).sum() == 2 * len(d)


@pytest.mark.parametrize("scene", ["multi_block", "deep", "forced_env"])
@pytest.mark.parametrize("case", SHADOW_CASES)
def test_any_hit_walk_equals_k4_plain(case, scene, request):
    """K4's restated walk (leaf cuts first, out at the first blocker) against
    occlusion_stream_plain (slot order): the same bool on every lane."""
    flat, static = request.getfixturevalue(scene)[-2:]
    o, d, min_t, occ0 = _shadow_rays(flat, case)
    tb = StreamTables(flat, static)
    got, blocker, deepest = any_hit_walk(tb, o, d, min_t, occ0)
    np.testing.assert_array_equal(got, _k4_plain(flat, static, o, d, min_t, occ0))
    assert deepest <= 7 * (static.stream_top_depth + static.stream_sub_depth) + 1
    full = got
    if case == "min_t clamped short":
        full, _, _ = any_hit_walk(tb, o, d, np.full(len(o), 9.0, F), occ0)
    _check_shadow_case(case, got, blocker, full, o, d, min_t, occ0)
    if case == "blocker in a wrapped leaf cut" and scene != "forced_env":
        # some lane's blocker lies in a block that wraps one leaf cut, tested
        # off its top node; others inside blocks with nodes of their own
        blocks = flat.str_blocks.numpy().reshape(-1, 4)
        rows = blocker[blocker >= 0]
        wrapped = blocks[rows // static.stream_sub_tris, 2] >= 0
        assert wrapped.any() and not wrapped.all()


@pytest.mark.parametrize("scene", ["multi_block", "deep"])
@pytest.mark.parametrize("case", SHADOW_CASES)
def test_any_hit_walk_over_wide_tables_equals_k2_plain(case, scene, request):
    """K2's instantiation of the same walk against occlusion_wbvh_plain, and
    K4's against it lane for lane (the stream split loses no triangle)."""
    flat, static = request.getfixturevalue(scene)[-2:]
    o, d, min_t, occ0 = _shadow_rays(flat, case)
    got, blocker, deepest = any_hit_walk(WideTables(flat), o, d, min_t, occ0)
    np.testing.assert_array_equal(got, _k2_plain(flat, o, d, min_t, occ0))
    assert deepest <= 7 * static.wide_depth + 1
    k4, _, _ = any_hit_walk(StreamTables(flat, static), o, d, min_t, occ0)
    np.testing.assert_array_equal(got, k4)
    full = got
    if case == "min_t clamped short":
        full, _, _ = any_hit_walk(WideTables(flat), o, d, np.full(len(o), 9.0, F), occ0)
    _check_shadow_case(case, got, blocker, full, o, d, min_t, occ0)


@pytest.mark.parametrize("scene", ["multi_block", "forced_env"])
@pytest.mark.parametrize("tables", ["stream (K4)", "wide (K2)"])
def test_any_hit_walk_matches_pallas_interpret(tables, scene, request):
    """Against the JAX package's kernels in interpret mode, on the rays of
    tests/test_torch_stream.py's comparison with dead lanes added: exact."""
    jflat, jstatic, flat, static = request.getfixturevalue(scene)
    m = 2048
    o, d = random_rays(m, seed=34)
    min_t = np.random.default_rng(34).uniform(0.5, 9.0, m).astype(F)
    min_t = np.where(np.arange(m) % 4 == 1, DEAD_T, min_t).astype(F)
    occ0 = np.arange(m) % 7 == 0
    if tables.startswith("stream"):
        want = _pallas_k4(jflat, jstatic, o, d, jnp.asarray(min_t), jnp.asarray(occ0))
        tb = StreamTables(flat, static)
    else:
        want = occlusion_wbvh_pallas(jflat.bvh_wf, jflat.bvh_wi, jflat.tri_pk, o, d,
                                     jnp.asarray(min_t), jnp.asarray(occ0),
                                     leaf_k=jstatic.wide_leaf_k, interpret=True)
        tb = WideTables(flat)
    got, _, _ = any_hit_walk(tb, np.asarray(o), np.asarray(d), min_t, occ0)
    np.testing.assert_array_equal(got, np.asarray(want))
    live = ~occ0 & (min_t >= 0)
    assert got[live].any() and not got[live].all() and got[occ0].all()


def test_k4_wrapper_checks_the_one_stack(multi_block):
    """K4's wrapper holds top_depth + sub_depth against its one stack, as
    K3's, before it looks at the device; a tensor that is on neither the CPU
    nor the card is refused, not sent to the plain version."""
    _, _, flat, static = multi_block
    o, d, min_t, occ0 = _shadow_rays(flat, "plain", m=8)
    names = ("str_topf", "str_topl", "str_subf", "str_subi", "str_subt", "str_base")
    args = [getattr(flat, n) for n in names] + [_t(o), _t(d), _t(min_t), _t(occ0)]
    got = ts.occlusion_stream(*args, **_sizes(static), top_depth=5, sub_depth=4)
    np.testing.assert_array_equal(got.numpy(), _k4_plain(flat, static, o, d, min_t, occ0))
    with pytest.raises(ValueError, match="stack of 71"):
        ts.occlusion_stream(*args, **_sizes(static), top_depth=5, sub_depth=5)
    with pytest.raises(ValueError, match="entries"):
        ts.occlusion_stream(*args, sub_nodes=static.stream_sub_nodes + 1,
                            sub_tris=static.stream_sub_tris, top_depth=1, sub_depth=1)
    meta = [x.to("meta") for x in args[-4:]]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ts.occlusion_stream(*args[:-4], *meta, **_sizes(static), top_depth=1, sub_depth=1,
                            subt12=flat.str_subt12, blocks=flat.str_blocks)


# ---------------------------------------------------------------------------
# K5: the block-major closest hit over the shared walk


def blockmajor_walk(tb, roots8, groups, group, o, d, t_init, trace=None):
    """csrc/stream_traverse.cu closest_hit_blockmajor_kernel, ray by ray:
    groups of `group` consecutive blocks; a ray that passes a group's union
    box under its best t tests the group's roots (every ray tests every root
    where `groups` is None); one that passes block s's root enters it: a
    wrapped leaf cut from its row of `blocks`, any other block by the
    closest-hit walk from entry s*S.  Returns ((t, tri, u, v), the group
    tests, the root tests); `trace`, if a list, gets each ray's entered
    blocks."""
    roots = roots8.reshape(-1, 8)[:, :6]
    n_sub = roots.shape[0]
    bests, n_group, n_root = [], 0, 0
    for i in range(o.shape[0]):
        entered = []
        if trace is not None:
            trace.append(entered)
        if not t_init[i] >= 0:
            bests.append(None)
            continue
        ray, best = _Ray(o[i], d[i]), [F(t_init[i]), -1, F(0), F(0)]
        for g, s0 in enumerate(range(0, n_sub, group)):
            if groups is not None:
                n_group += 1
                hit, te = _slab8(groups.reshape(-1, 8)[g:g + 1, :6], ray.o, ray.inv)
                if not (hit[0] and te[0] <= best[0]):
                    continue
            for s in range(s0, min(s0 + group, n_sub)):
                n_root += 1
                hit, te = _slab8(roots[s:s + 1], ray.o, ray.inv)
                if not (hit[0] and te[0] <= best[0]):
                    continue
                entered.append(s)
                _, _, lo, hi = tb.blocks[s]
                if lo >= 0:
                    closest_leaf(tb, ray, int(lo), int(hi), best)
                else:
                    closest_walk(tb, ray, s * tb.S, best)
        bests.append(best)
    return _results(tb, t_init, bests), n_group, n_root


BM_FIELDS = ("str_roots", "str_subf", "str_subi", "str_subp", "str_subt", "str_base")


def _k5_plain(flat, static, o, d, t_init, **kw):
    return ts.closest_hit_blockmajor_plain(*(getattr(flat, n) for n in BM_FIELDS), _t(o), _t(d),
                                           _t(t_init), **_sizes(static), **kw)


def _bound_axis_rays(flat, group, m):
    """Rays along an axis (the other two direction components exactly 0)
    whose origin lies exactly on a block's root bound on one still axis: on
    even lanes a bound that is also its group's (the union's), on odd lanes
    a member's own; inside the block's slab on the other still axis, and
    outside the box on the moving axis, pointing at it."""
    rng = np.random.default_rng(43)
    roots = flat.str_roots.numpy().reshape(-1, 6)
    unions = tfs.stream_cull_tables(flat.str_roots.numpy(), group)[1].reshape(-1, 8)
    live = np.flatnonzero(~np.isnan(roots).any(1))
    o, d = np.zeros((m, 3), F), np.zeros((m, 3), F)
    on_union = 0
    for i in range(m):
        axis = rng.integers(0, 3)
        still, other = (axis + 1) % 3, (axis + 2) % 3
        side = rng.integers(0, 2)  # 0: lower bound, 1: upper bound
        if i % 2 == 0:  # a block whose bound on `still` is its group's
            g = rng.integers(0, unions.shape[0])
            members = [s for s in live if s // group == g
                       and roots[s, 3 * side + still] == unions[g, 3 * side + still]]
            s = members[0] if members else rng.choice(live)
            on_union += bool(members)
        else:
            s = rng.choice(live)
        lo, hi = roots[s, 0:3], roots[s, 3:6]
        o[i] = (lo + hi) * F(0.5)
        o[i, still] = (lo, hi)[side][still]
        sign = rng.choice(np.array([-1.0, 1.0], F))
        d[i, axis] = sign
        o[i, axis] = (lo[axis] if sign > 0 else hi[axis]) - sign * F(2.0)
    assert on_union > m // 4
    return o, d


K5_CASES = ["multi-block", "dead lanes", "t cap", "wrapped leaf cuts", "rays on bounds", "deep"]


@pytest.mark.parametrize("case", K5_CASES)
def test_blockmajor_walk_equals_k5_plain(case, request, monkeypatch):
    """The restated K5 kernel (group cull, root test, the tagged walk inside
    a block) against closest_hit_blockmajor_plain, bit for bit on t, tri, u
    and v, with and without the plain version's own cull.  Groups of 4
    blocks, so that the cull has several groups to skip on these small
    meshes (the kernel's are 32; the rule does not depend on the size).
    The cull changes no entered block: the same blocks, lane for lane, as
    the restatement without it."""
    scene = "deep" if case == "deep" else "multi_block"
    flat, static = request.getfixturevalue(scene)[-2:]
    group = 4
    monkeypatch.setattr(ts, "STREAM_CULL_GROUP", group)
    m = 384
    o, d = _rays(flat, m, seed=61 + K5_CASES.index(case))
    t_init = np.full(m, FLT_MAX, F)
    if case == "dead lanes":
        t_init = np.where(np.arange(m) % 3 == 0, DEAD_T, FLT_MAX).astype(F)
    elif case == "t cap":
        t_init = np.where(np.arange(m) % 4 == 0, DEAD_T, 6.0).astype(F)
    elif case == "rays on bounds":
        o, d = _bound_axis_rays(flat, group, m)
    roots8, groups = tfs.stream_cull_tables(flat.str_roots.numpy(), group)
    tb = StreamTables(flat, static)
    culled, seen = [], []
    got, n_group, n_root = blockmajor_walk(tb, roots8, groups, group, o, d, t_init, culled)
    n_sub = static.stream_subs
    full, _, n_all = blockmajor_walk(tb, roots8, None, group, o, d, t_init, seen)
    assert culled == seen
    for a, b in zip(got, full):
        np.testing.assert_array_equal(a, b)
    live = int((t_init >= 0).sum())
    assert n_all == live * n_sub and n_group == live * -(-n_sub // group)
    counts = {"box": 0, "tri": 0, "group": 0, "root": 0}
    _assert_bitwise(got, _k5_plain(flat, static, o, d, t_init, groups=_t(groups), counts=counts))
    _assert_bitwise(got, _k5_plain(flat, static, o, d, t_init))
    assert (counts["group"], counts["root"]) == (n_group, n_root)
    assert n_root < n_all  # the cull skipped some root tests
    hits = got[1] >= 0
    assert hits.sum() > (10 if case == "rays on bounds" else 50) and (~hits).sum() > 0
    if case == "dead lanes":
        dead = t_init < 0
        assert (got[1][dead] == -1).all() and (got[0][dead] == F(DEAD_T)).all()
    if case == "t cap":
        assert (got[0][hits] < 6.0).all()
    if case == "wrapped leaf cuts":
        blocks = flat.str_blocks.numpy().reshape(-1, 4)
        owner = np.searchsorted(np.sort(blocks[:, 0]), got[1][hits], side="right") - 1
        wrapped = (blocks[np.argsort(blocks[:, 0]), 2] >= 0)[owner]
        assert wrapped.any() and not wrapped.all()
    if case == "rays on bounds":
        assert (d == 0).sum() == 2 * m
    # K5 agrees with K3's walk on t (these rays have no exact-t tie)
    k3, _ = tagged_walk(tb, o, d, t_init)
    np.testing.assert_array_equal(got[0], k3[0])


def test_blockmajor_walk_matches_pallas_interpret(multi_block):
    """Against the JAX package's block-major kernel in interpret mode:
    triangle ids exactly, t/u/v within rtol 1e-5 (as the K3 comparison)."""
    jflat, jstatic, flat, static = multi_block
    m = 2048
    o, d = random_rays(m, seed=33)
    t_init = np.full(m, FLT_MAX, F)
    pk = closest_hit_blockmajor_pallas(
        *(getattr(jflat, n) for n in STR_FIELDS if n != "str_topp"), o, d, jnp.asarray(t_init),
        leaf_k=jstatic.wide_leaf_k, **_sizes(jstatic), interpret=True, chunk_rows=16)
    got, _, _ = blockmajor_walk(StreamTables(flat, static), flat.str_roots8.numpy(),
                                flat.str_groups.numpy(), tfs.STREAM_CULL_GROUP,
                                np.asarray(o), np.asarray(d), t_init)
    np.testing.assert_array_equal(got[1], np.asarray(pk[1]))
    hits = got[1] >= 0
    assert hits.sum() > 50
    for a, b in zip((got[0], got[2], got[3]), (pk[0], pk[2], pk[3])):
        np.testing.assert_allclose(a[hits], np.asarray(b)[hits], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene", ["multi_block", "deep", "forced_env"])
@pytest.mark.parametrize("group", [4, tfs.STREAM_CULL_GROUP])
def test_cull_tables_are_unions_of_the_roots(scene, group, request):
    """str_roots8 is str_roots padded with two zeros a row; each group row is
    the exact union of its members' root boxes (so it contains each), NaN
    only where every member is NaN; both 16-byte aligned as the kernel
    reads them."""
    flat, static = request.getfixturevalue(scene)[-2:]
    roots = flat.str_roots.numpy().reshape(-1, 6)
    n_sub = roots.shape[0]
    if group == tfs.STREAM_CULL_GROUP:
        roots8, groups = flat.str_roots8.numpy(), flat.str_groups.numpy()
        for t in (flat.str_roots8, flat.str_groups):
            assert t.dtype == torch.float32 and t.data_ptr() % 16 == 0
    else:
        roots8, groups = tfs.stream_cull_tables(flat.str_roots.numpy(), group)
    roots8, groups = roots8.reshape(-1, 8), groups.reshape(-1, 8)
    assert roots8.shape == (n_sub, 8) and groups.shape == (-(-n_sub // group), 8)
    np.testing.assert_array_equal(roots8[:, :6], roots)
    assert not roots8[:, 6:].any() and not groups[:, 6:].any()
    for g in range(groups.shape[0]):
        members = roots[g * group:(g + 1) * group]
        members = members[~np.isnan(members).any(1)]
        if not len(members):
            assert np.isnan(groups[g, :6]).all()
            continue
        np.testing.assert_array_equal(groups[g, 0:3], members[:, 0:3].min(0))
        np.testing.assert_array_equal(groups[g, 3:6], members[:, 3:6].max(0))
        assert (groups[g, 0:3] <= members[:, 0:3]).all() and (groups[g, 3:6] >= members[:, 3:6]).all()


def test_k5_wrapper_refuses(multi_block):
    """K5's wrapper: the walk's depth against the one stack before anything
    else; on CUDA tensors it needs K3's derived tables and its cull tables,
    at their sizes and 16-byte aligned (the checks it runs there)."""
    _, _, flat, static = multi_block
    o, d = random_rays(8, seed=84)
    tables = [getattr(flat, n) for n in BM_FIELDS]
    rays = [_t(o), _t(d), _t(np.full(8, FLT_MAX, F))]
    assert 7 * 9 + 1 == ts.STACK
    ts.closest_hit_blockmajor(*tables, *rays, **_sizes(static), sub_depth=9)
    with pytest.raises(ValueError, match="stack of 71"):
        ts.closest_hit_blockmajor(*tables, *rays, **_sizes(static), sub_depth=10)
    base, sizes = flat.str_base, (static.stream_sub_nodes, static.stream_sub_tris)
    with pytest.raises(ValueError, match="needs subt12 and blocks"):
        ts._check_walk_tables("closest_hit_blockmajor", base, *sizes, None, flat.str_blocks)
    with pytest.raises(ValueError, match="needs roots8 and groups"):
        ts._check_cull_tables(base, *sizes, flat.str_roots8, None)
    with pytest.raises(ValueError, match="entries"):
        ts._check_cull_tables(base, *sizes, flat.str_roots8[:-8], flat.str_groups)
    with pytest.raises(ValueError, match="entries"):
        ts._check_cull_tables(base, *sizes, flat.str_roots8, flat.str_groups[:-8])
    ts._check_cull_tables(base, *sizes, flat.str_roots8, flat.str_groups)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tc._check_aligned(roots8=flat.str_roots8[1:])
    meta = [x.to("meta") for x in rays]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ts.closest_hit_blockmajor(*tables, *meta, **_sizes(static), sub_depth=1,
                                  subt12=flat.str_subt12, blocks=flat.str_blocks,
                                  roots8=flat.str_roots8, groups=flat.str_groups)
