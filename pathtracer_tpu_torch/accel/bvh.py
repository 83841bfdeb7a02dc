"""SAH BVH build + stackless (threaded) flatten + 6-way MTBVH.

Port of `pathtracer_tpu/accel/bvh.py`, kept as the port's own copy so
that the port imports nothing of the JAX package.

Host-side rebuild of the reference's CPU BVH pipeline
(reference: src/BVH.cpp:13-239, src/BVH.h):

- top-down recursive SAH with BUCKET_NUM=20 centroid buckets on the
  max-extent axis of the centroid bounds, cost
  (nL·SA(L) + nR·SA(R)) / SA(root), in-place partition of the triangle
  array (reference: src/BVH.cpp:13-92)
- leaves hold <= MAX_PRIM = 1 triangle (reference: src/BVH.h:5)
- preorder flatten to parent/left/right info (reference: src/BVH.cpp:121-147)
- threaded linearization: hit = next preorder index, miss = sibling (for a
  left child) or parent's miss (reference: src/BVH.cpp:149-178)
- MTBVH: 6 direction-ordered replicas [+x,+y,+z,-x,-y,-z]; internal nodes'
  hit link points at the NEAR child for that direction, leaf hit/miss use
  sibling-or-parent-miss (reference: src/BVH.cpp:180-239)

Divergence from the reference (documented per SURVEY.md §7): when a SAH
split is degenerate (all centroids in one bucket / zero-extent axis) the
reference can recurse forever; we fall back to a median split.

The build returns a permutation of the input triangles (the reference
partitions its triangle vector in place) plus flat SoA arrays ready for
upload.  A C++ builder (accel/native) provides a faster drop-in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BUCKET_NUM = 20
MAX_PRIM = 1


@dataclass
class FlatBVH:
    """Flattened threaded BVH (possibly 6-way replicated).

    Arrays have leading axis `num_trees * num_nodes`; tree d occupies
    [d*num_nodes, (d+1)*num_nodes).
    """

    bbox_min: np.ndarray  # (D*N, 3) float32
    bbox_max: np.ndarray  # (D*N, 3) float32
    start: np.ndarray     # (D*N,) int32 — triangle range start
    end: np.ndarray       # (D*N,) int32
    hit: np.ndarray       # (D*N,) int32 — next node on hit (-1 = done)
    miss: np.ndarray      # (D*N,) int32 — next node on miss (-1 = done)
    num_nodes: int
    num_trees: int
    order: np.ndarray     # (T,) permutation applied to the input triangles
    left: np.ndarray = None   # (N,) int32 explicit child links (tree 0) —
    right: np.ndarray = None  # consumed by the Pallas packet traversal


def _surface_area(pmin: np.ndarray, pmax: np.ndarray) -> float:
    if np.any(pmin > pmax):
        return 0.0
    d = pmax - pmin
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def build_bvh(
    tri_verts: np.ndarray,
    use_sah: bool = True,
    mtbvh: bool = True,
    use_native: bool = True,
    max_prim: int = MAX_PRIM,
    bucket_num: int = BUCKET_NUM,
) -> FlatBVH:
    """Build from (T, 3, 3) world-space triangle vertices.

    `use_native` tries the C++ builder (accel/native, ~100x the numpy
    builder on large meshes — the reference's build is C++ too,
    reference: src/BVH.cpp); falls back to numpy when no toolchain exists.
    `max_prim`/`bucket_num` mirror the reference's compile-time knobs
    (reference: src/BVH.h:5-6).
    """
    T = tri_verts.shape[0]
    if T == 0:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        return FlatBVH(z3, z3, zi, zi, zi, zi, 0, 6 if mtbvh else 1, np.zeros(0, np.int64), zi, zi)

    bmin_tri = tri_verts.min(axis=1)  # (T,3)
    bmax_tri = tri_verts.max(axis=1)
    # triangle centroid = mean of vertices (reference: Bounds3.hpp Triangle::Centroid)
    centroids = tri_verts.mean(axis=1)

    if use_sah and use_native:
        try:
            from pathtracer_tpu_torch.accel.native import build_sah_native

            res = build_sah_native(bmin_tri, bmax_tri, centroids, max_prim, bucket_num)
        except Exception:
            res = None
        if res is not None:
            order, bmin, bmax, start_a, end_a, left, right, parent = res
            n = bmin.shape[0]
            return _finish_links(
                bmin, bmax, start_a, end_a, left, right, parent, n, mtbvh, order
            )

    order = np.arange(T, dtype=np.int64)

    # node storage (preorder is assigned in a second pass)
    nodes_start: list[int] = []
    nodes_end: list[int] = []
    nodes_bmin: list[np.ndarray] = []
    nodes_bmax: list[np.ndarray] = []
    nodes_left: list[int] = []
    nodes_right: list[int] = []
    nodes_parent: list[int] = []

    # explicit preorder stack: (start, end, parent, is_right_child)
    stack: list[tuple[int, int, int]] = [(0, T, -1)]
    while stack:
        start, end, parent = stack.pop()
        idx = order[start:end]
        nb_min = bmin_tri[idx].min(axis=0)
        nb_max = bmax_tri[idx].max(axis=0)
        me = len(nodes_start)
        nodes_start.append(start)
        nodes_end.append(end)
        nodes_bmin.append(nb_min)
        nodes_bmax.append(nb_max)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_parent.append(parent)
        if parent >= 0:
            if nodes_left[parent] == -2:  # awaiting left
                nodes_left[parent] = me
            else:
                nodes_right[parent] = me

        if end - start <= max(max_prim, 1):
            continue

        cent = centroids[idx]
        cmin = cent.min(axis=0)
        cmax = cent.max(axis=0)
        diag = cmax - cmin
        # max-extent axis (reference: Bounds3::MaxExtent)
        if diag[0] > diag[1] and diag[0] > diag[2]:
            axis = 0
        elif diag[1] > diag[2]:
            axis = 1
        else:
            axis = 2

        mid = -1
        if use_sah and diag[axis] > 0:
            offs = np.clip((cent[:, axis] - cmin[axis]) / diag[axis], 0.0, 1.0)
            bidx = np.where(offs == 1.0, bucket_num - 1, (offs * bucket_num).astype(np.int64))
            bidx = np.minimum(bidx, bucket_num - 1)

            counts = np.bincount(bidx, minlength=bucket_num)
            # per-bucket bounds
            bk_min = np.full((bucket_num, 3), np.inf)
            bk_max = np.full((bucket_num, 3), -np.inf)
            np.minimum.at(bk_min, bidx, bmin_tri[idx])
            np.maximum.at(bk_max, bidx, bmax_tri[idx])

            best_loss = np.inf
            best_bucket = -1
            for i in range(bucket_num - 1):
                nl = counts[: i + 1].sum()
                nr = counts[i + 1 :].sum()
                if nl == 0 or nr == 0:
                    continue
                lmin = bk_min[: i + 1].min(axis=0)
                lmax = bk_max[: i + 1].max(axis=0)
                rmin = bk_min[i + 1 :].min(axis=0)
                rmax = bk_max[i + 1 :].max(axis=0)
                loss = nl * _surface_area(lmin, lmax) + nr * _surface_area(rmin, rmax)
                if loss < best_loss:
                    best_loss = loss
                    best_bucket = i
            if best_bucket >= 0:
                go_left = bidx <= best_bucket
                # stable partition, like std::partition's grouping
                left_idx = idx[go_left]
                right_idx = idx[~go_left]
                mid = start + len(left_idx)
                order[start:mid] = left_idx
                order[mid:end] = right_idx

        if mid <= start or mid >= end:
            # median split fallback (reference: recursiveBuildNaive,
            # src/BVH.cpp:94-118; also our degenerate-SAH guard)
            keys = centroids[idx][:, axis]
            perm = np.argsort(keys, kind="stable")
            order[start:end] = idx[perm]
            mid = (start + end) // 2

        nodes_left[me] = -2  # mark: next pushed preorder child is my left
        # push right first so left pops first (preorder)
        stack.append((mid, end, me))
        stack.append((start, mid, me))

    n = len(nodes_start)
    bmin = np.asarray(nodes_bmin, np.float32).reshape(n, 3)
    bmax = np.asarray(nodes_bmax, np.float32).reshape(n, 3)
    start_a = np.asarray(nodes_start, np.int32)
    end_a = np.asarray(nodes_end, np.int32)
    left = np.asarray(nodes_left, np.int32)
    right = np.asarray(nodes_right, np.int32)
    parent = np.asarray(nodes_parent, np.int32)
    return _finish_links(bmin, bmax, start_a, end_a, left, right, parent, n, mtbvh, order)


def _node_depths(parent: np.ndarray) -> np.ndarray:
    """Per-node depth from parent links (preorder ⇒ parent[i] < i), by
    repeated vectorized passes — one per tree level."""
    n = len(parent)
    depth = np.full(n, -1, np.int64)
    if n:
        depth[0] = 0
    while True:
        pending = depth < 0
        if not pending.any():
            return depth
        ready = pending & (depth[np.maximum(parent, 0)] >= 0)
        depth[ready] = depth[parent[ready]] + 1


def _finish_links(bmin, bmax, start_a, end_a, left, right, parent, n, mtbvh, order):
    """Threaded hit/miss linearization (+6-way MTBVH) from child/parent
    info (reference: src/BVH.cpp:198-236).  The miss/leaf-hit recurrence
    only reads the PARENT's links, so it resolves level-by-level with
    vectorized gathers instead of the per-node Python loop (which cost
    ~10 s at 1.28M nodes)."""
    if not mtbvh:
        hit, miss = _thread_links(left, right, parent)
        return FlatBVH(bmin, bmax, start_a, end_a, hit, miss, n, 1, order, left, right)

    internal = left != -1
    sib = np.full(n, -1, np.int32)
    li, ri = left[internal], right[internal]
    sib[li] = ri
    sib[ri] = li
    cent = (bmin + bmax) * 0.5

    # near child per direction (internal nodes; reference: src/BVH.cpp:198-222)
    near = np.zeros((6, n), np.int32)
    for d in range(6):
        axis = d % 3
        sign = 1.0 if d < 3 else -1.0
        key = cent[:, axis] * sign
        lk = key[np.maximum(left, 0)]
        rk = key[np.maximum(right, 0)]
        near[d] = np.where(internal & (lk > rk), right, left)

    depth = _node_depths(parent)
    misses = np.full((6, n), -1, np.int32)
    for lvl in range(1, int(depth.max()) + 1 if n else 0):
        idx = np.nonzero(depth == lvl)[0].astype(np.int32)
        pi = parent[idx]
        is_near = idx[None, :] == near[:, pi]
        misses[:, idx] = np.where(is_near, sib[idx][None, :], misses[:, pi])
    # internal hit = near child; leaf hit = its own miss link (the
    # sibling-or-parent-miss cases coincide; root leaf = -1)
    hits = np.where(internal[None, :], near, misses)

    tile = lambda a: np.tile(a, 6)
    return FlatBVH(
        np.tile(bmin, (6, 1)),
        np.tile(bmax, (6, 1)),
        tile(start_a),
        tile(end_a),
        hits.reshape(-1),
        misses.reshape(-1),
        n,
        6,
        order,
        left,
        right,
    )


def _thread_links(left: np.ndarray, right: np.ndarray, parent: np.ndarray):
    """Plain (non-MT) threading (reference: src/BVH.cpp:149-178),
    level-vectorized like the MTBVH variant."""
    n = len(left)
    hit = np.arange(1, n + 1, dtype=np.int32)
    if n:
        hit[-1] = -1
    miss = np.full(n, -1, np.int32)
    depth = _node_depths(parent)
    for lvl in range(1, int(depth.max()) + 1 if n else 0):
        idx = np.nonzero(depth == lvl)[0].astype(np.int32)
        pi = parent[idx]
        miss[idx] = np.where(idx == left[pi], right[pi], miss[pi])
    return hit, miss


WIDE_W = 8  # branching factor of the collapsed tree (one pop tests 8 AABBs)


@dataclass
class WideBVH:
    """8-ary collapse of the binary SAH tree for the Pallas packet kernels.

    Node pops are the SERIAL unit of TPU packet traversal (one
    `lax.while_loop` lap per pop); collapsing the binary tree to 8-ary
    cuts pop count ~7x while the extra AABB tests ride the already-paid
    vector lanes.  Children are either internal (link >= 0) or LEAF CUTS:
    contiguous triangle ranges of <= leaf_k (the SAME reference triangle
    ordering — physics identical to the MAX_PRIM=1 tree, reference:
    src/BVH.cpp:13-92).  Empty slots carry NaN AABBs so the packet slab
    test rejects them without branches (inverted ±inf boxes would PASS it:
    the per-axis min/max swap turns them into infinite slabs).
    """

    child_bmin: np.ndarray   # (M, 8, 3) float32; NaN rows = empty slot
    child_bmax: np.ndarray   # (M, 8, 3) float32; NaN rows = empty slot
    child_link: np.ndarray   # (M, 8) int32: >=0 wide-node id, -1 leaf/empty
    child_start: np.ndarray  # (M, 8) int32 (leaf triangle range; 0,0 = empty)
    child_end: np.ndarray    # (M, 8) int32
    perm: np.ndarray         # (M, 8) int32 — per-direction-octant near→far
    # child visit order, 3 bits per rank (octant bit k = d[k] > 0)
    num_nodes: int
    max_depth: int           # root = 0; stack holds <= max_depth+1 nodes
    leaf_k: int


def collapse_wide(bvh: FlatBVH, leaf_k: int, width: int = WIDE_W) -> WideBVH:
    """Collapse the binary tree: repeatedly expand the largest-surface-area
    internal candidate until `width` children, cutting subtrees that span
    <= leaf_k triangles into leaf children."""
    n = bvh.num_nodes
    if n == 0:
        return WideBVH(
            np.full((1, width, 3), np.nan, np.float32),
            np.full((1, width, 3), np.nan, np.float32),
            np.full((1, width), -1, np.int32),
            np.zeros((1, width), np.int32),
            np.zeros((1, width), np.int32),
            np.zeros((1, width), np.int32),
            1, 0, leaf_k,
        )
    bmin = bvh.bbox_min[:n]
    bmax = bvh.bbox_max[:n]
    start, end = bvh.start[:n], bvh.end[:n]
    left, right = bvh.left, bvh.right
    span = end - start
    ext = np.maximum(bmax - bmin, 0.0)
    sa = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0])

    def gather_children(bid: int) -> list[int]:
        cand = [int(left[bid]), int(right[bid])]
        while len(cand) < width:
            exp = [c for c in cand if span[c] > leaf_k]
            if not exp:
                break
            best = max(exp, key=lambda c: sa[c])
            i = cand.index(best)
            cand[i : i + 1] = [int(left[best]), int(right[best])]
        return cand

    rows: list[list[int]] = []       # wide node -> binary child ids
    depth_of: list[int] = []
    wide_of: dict[int, int] = {}

    if span[0] <= leaf_k:
        # whole tree fits one leaf: a single wide node with one leaf child
        rows.append([0])
        depth_of.append(0)
    else:
        wide_of[0] = 0
        rows.append(gather_children(0))
        depth_of.append(0)
        qi = 0
        while qi < len(rows):
            for c in rows[qi]:
                if span[c] > leaf_k and c not in wide_of:
                    wide_of[c] = len(rows)
                    rows.append(gather_children(c))
                    depth_of.append(depth_of[qi] + 1)
            qi += 1

    m = len(rows)
    cb_min = np.full((m, width, 3), np.nan, np.float32)
    cb_max = np.full((m, width, 3), np.nan, np.float32)
    clink = np.full((m, width), -1, np.int32)
    cstart = np.zeros((m, width), np.int32)
    cend = np.zeros((m, width), np.int32)
    for w, row in enumerate(rows):
        for j, c in enumerate(row):
            cb_min[w, j] = bmin[c]
            cb_max[w, j] = bmax[c]
            if span[c] > leaf_k:
                clink[w, j] = wide_of[c]
            else:
                cstart[w, j] = start[c]
                cend[w, j] = end[c]

    # per-octant near→far visit order by signed centroid (the wide analogue
    # of the MTBVH's near-child-first hit links, reference: src/BVH.cpp:180-239)
    cent = (cb_min + cb_max) * 0.5  # (m, 8, 3); empty slots are NaN
    empty = (clink < 0) & (cstart >= cend)
    perm = np.zeros((m, width), np.int32)
    for o in range(8):
        s = np.array(
            [1.0 if o & 1 else -1.0, 1.0 if o & 2 else -1.0, 1.0 if o & 4 else -1.0],
            np.float32,
        )
        key = (cent * s).sum(axis=2)
        key = np.where(empty, np.inf, key)
        order = np.argsort(key, axis=1, kind="stable").astype(np.int64)  # (m, 8)
        packed = np.zeros(m, np.int64)
        for rank in range(width):
            packed |= order[:, rank] << (3 * rank)
        perm[:, o] = packed.astype(np.int32)

    return WideBVH(
        cb_min, cb_max, clink, cstart, cend, perm,
        m, int(max(depth_of) if depth_of else 0), leaf_k,
    )


@dataclass
class StreamBVH:
    """Two-level split of a WideBVH for meshes beyond the on-chip budget.

    The TOP tree (every wide node whose subtree exceeds the per-subtree
    budget) stays SMEM-resident during traversal; SUBTREES (uniformly
    padded blocks of `sub_nodes` wide nodes + `sub_tris` triangle rows)
    live in HBM and are DMA-streamed into a double-buffered on-chip cache
    when a packet reaches them (ops/traverse_pallas.py streaming kernels).
    Top child links: >= 0 top node id, -1 empty, -(2+s) = subtree s.
    Subtree-local links/cuts index within the block; global triangle id =
    tri_base[s] + local id.  Same global triangle order as the WideBVH —
    physics identical (reference: src/pathtrace.cu:236-279 handles
    arbitrary mesh sizes from device memory; this is the TPU equivalent).
    """

    # top tree, WideBVH-compatible per-node layout
    top_bmin: np.ndarray    # (T, 8, 3) f32, NaN = empty
    top_bmax: np.ndarray    # (T, 8, 3) f32
    top_link: np.ndarray    # (T, 8) i32: >=0 top node, -1 empty, -(2+s) sub
    top_perm: np.ndarray    # (T, 8) i32 packed per-octant orders
    # subtree blocks
    sub_bmin: np.ndarray    # (n_sub, S, 8, 3) f32
    sub_bmax: np.ndarray    # (n_sub, S, 8, 3) f32
    sub_link: np.ndarray    # (n_sub, S, 8) i32: >=0 local node, -1 leaf/empty
    sub_start: np.ndarray   # (n_sub, S, 8) i32 local tri cut start
    sub_end: np.ndarray     # (n_sub, S, 8) i32
    sub_perm: np.ndarray    # (n_sub, S, 8) i32
    tri_base: np.ndarray    # (n_sub,) i32 global id of the block's first tri
    tri_count: np.ndarray   # (n_sub,) i32
    num_top: int
    num_sub: int
    sub_nodes: int          # S: node slots per block
    sub_tris: int           # Tmax: triangle rows per block
    leaf_k: int


def partition_stream(w: WideBVH, sub_nodes: int = 256,
                     sub_tris: int = 4096) -> StreamBVH:
    """Split a WideBVH at the maximal frontier of subtrees that fit the
    (sub_nodes, sub_tris) block budget; everything above stays top."""
    M = w.num_nodes
    # subtree node counts + tri spans per wide node (children DFS)
    size = np.ones(M, np.int64)
    lo = np.full(M, np.iinfo(np.int64).max, np.int64)
    hi = np.zeros(M, np.int64)
    order = []
    stack = [0]
    seen = np.zeros(M, bool)
    while stack:  # postorder via two-phase stack
        nid = stack.pop()
        if seen[nid]:
            order.append(nid)
            continue
        seen[nid] = True
        stack.append(nid)
        for c in range(8):
            ln = int(w.child_link[nid, c])
            if ln >= 0:
                stack.append(ln)
    for nid in order:
        for c in range(8):
            ln = int(w.child_link[nid, c])
            if ln >= 0:
                size[nid] += size[ln]
                lo[nid] = min(lo[nid], lo[ln])
                hi[nid] = max(hi[nid], hi[ln])
            elif w.child_end[nid, c] > w.child_start[nid, c]:
                lo[nid] = min(lo[nid], int(w.child_start[nid, c]))
                hi[nid] = max(hi[nid], int(w.child_end[nid, c]))

    def fits(nid: int) -> bool:
        return size[nid] <= sub_nodes and hi[nid] - lo[nid] <= sub_tris

    # top-down: collect top nodes and subtree roots (wide-node ids);
    # a leaf-cut child of a top node becomes a one-node pseudo-subtree
    top_ids: list[int] = []
    sub_roots: list[tuple[int, int]] = []  # (wide node id, -1) or
    # (top node id, child slot) for wrapped leaf cuts
    top_of: dict[int, int] = {}
    sub_of: dict[tuple[int, int], int] = {}
    queue = [0]
    while queue:
        nid = queue.pop()
        top_of[nid] = len(top_ids)
        top_ids.append(nid)
        for c in range(8):
            ln = int(w.child_link[nid, c])
            if ln >= 0:
                if fits(ln):
                    sub_of[(ln, -1)] = len(sub_roots)
                    sub_roots.append((ln, -1))
                else:
                    queue.append(ln)
            elif w.child_end[nid, c] > w.child_start[nid, c]:
                sub_of[(nid, c)] = len(sub_roots)
                sub_roots.append((nid, c))

    T = len(top_ids)
    n_sub = len(sub_roots)
    top_bmin = np.full((T, 8, 3), np.nan, np.float32)
    top_bmax = np.full((T, 8, 3), np.nan, np.float32)
    top_link = np.full((T, 8), -1, np.int32)
    top_perm = np.zeros((T, 8), np.int32)
    for t, nid in enumerate(top_ids):
        top_bmin[t] = w.child_bmin[nid]
        top_bmax[t] = w.child_bmax[nid]
        top_perm[t] = w.perm[nid]
        for c in range(8):
            ln = int(w.child_link[nid, c])
            if ln >= 0:
                top_link[t, c] = (
                    top_of[ln] if ln in top_of else -(2 + sub_of[(ln, -1)])
                )
            elif w.child_end[nid, c] > w.child_start[nid, c]:
                top_link[t, c] = -(2 + sub_of[(nid, c)])

    sub_bmin = np.full((n_sub, sub_nodes, 8, 3), np.nan, np.float32)
    sub_bmax = np.full((n_sub, sub_nodes, 8, 3), np.nan, np.float32)
    sub_link = np.full((n_sub, sub_nodes, 8), -1, np.int32)
    sub_start = np.zeros((n_sub, sub_nodes, 8), np.int32)
    sub_end = np.zeros((n_sub, sub_nodes, 8), np.int32)
    sub_perm = np.zeros((n_sub, sub_nodes, 8), np.int32)
    tri_base = np.zeros(n_sub, np.int32)
    tri_count = np.zeros(n_sub, np.int32)
    for s, (nid, slot) in enumerate(sub_roots):
        if slot >= 0:
            # wrapped leaf cut: one local node with a single leaf child
            st, en = int(w.child_start[nid, slot]), int(w.child_end[nid, slot])
            tri_base[s] = st
            tri_count[s] = en - st
            sub_bmin[s, 0, 0] = w.child_bmin[nid, slot]
            sub_bmax[s, 0, 0] = w.child_bmax[nid, slot]
            sub_start[s, 0, 0] = 0
            sub_end[s, 0, 0] = en - st
            # identity visit order: rank 0 → the leaf in slot 0, ranks
            # 1-7 → the NaN empty slots (prune immediately) — an all-zero
            # perm decodes every rank to slot 0 and re-intersects the
            # same cut 8x per pop (idempotent but wasted laps)
            ident = 0
            for r in range(8):
                ident |= r << (3 * r)
            sub_perm[s, 0, :] = np.int32(ident)
            continue
        base = int(lo[nid])
        tri_base[s] = base
        tri_count[s] = int(hi[nid]) - base
        local_of = {nid: 0}
        ids = [nid]
        qi = 0
        while qi < len(ids):
            cur = ids[qi]
            for c in range(8):
                ln = int(w.child_link[cur, c])
                if ln >= 0 and ln not in local_of:
                    local_of[ln] = len(ids)
                    ids.append(ln)
            qi += 1
        assert len(ids) <= sub_nodes
        for li, cur in enumerate(ids):
            sub_bmin[s, li] = w.child_bmin[cur]
            sub_bmax[s, li] = w.child_bmax[cur]
            sub_perm[s, li] = w.perm[cur]
            for c in range(8):
                ln = int(w.child_link[cur, c])
                if ln >= 0:
                    sub_link[s, li, c] = local_of[ln]
                elif w.child_end[cur, c] > w.child_start[cur, c]:
                    sub_start[s, li, c] = int(w.child_start[cur, c]) - base
                    sub_end[s, li, c] = int(w.child_end[cur, c]) - base

    return StreamBVH(
        top_bmin, top_bmax, top_link, top_perm,
        sub_bmin, sub_bmax, sub_link, sub_start, sub_end, sub_perm,
        tri_base, tri_count, T, n_sub, sub_nodes, sub_tris, w.leaf_k,
    )


def validate_stream_bvh(s: StreamBVH, w: WideBVH, num_tris: int) -> list[str]:
    """Invariants: every wide node lands in top xor exactly one subtree;
    leaf cuts cover [0, num_tris) exactly once; links well-formed."""
    errors = []
    covered = np.zeros(num_tris, np.int64)
    for t in range(s.num_top):
        for c in range(8):
            ln = s.top_link[t, c]
            if ln >= s.num_top:
                errors.append(f"top {t} child {c} link {ln} out of range")
            if ln < -1 and -(ln + 2) >= s.num_sub:
                errors.append(f"top {t} child {c} sub {-(ln+2)} out of range")
    for si in range(s.num_sub):
        base = int(s.tri_base[si])
        for li in range(s.sub_nodes):
            for c in range(8):
                ln = s.sub_link[si, li, c]
                if ln >= 0:
                    if ln >= s.sub_nodes:
                        errors.append(f"sub {si} node {li} link oob")
                elif s.sub_end[si, li, c] > s.sub_start[si, li, c]:
                    st = base + int(s.sub_start[si, li, c])
                    en = base + int(s.sub_end[si, li, c])
                    if en - st > s.leaf_k:
                        errors.append(f"sub {si} cut > leaf_k")
                    if en > num_tris:
                        errors.append(f"sub {si} cut beyond tris")
                    else:
                        covered[st:en] += 1
    if num_tris and not np.all(covered == 1):
        bad = int((covered != 1).sum())
        errors.append(f"{bad} triangles not covered exactly once")
    return errors


def validate_wide_bvh(w: WideBVH, num_tris: int) -> list[str]:
    """Invariants: leaf ranges partition [0, T); links form a tree; every
    child is leaf xor internal xor empty; perms are permutations."""
    errors = []
    covered = []
    seen_link = set()
    for i in range(w.num_nodes):
        for j in range(WIDE_W):
            link = int(w.child_link[i, j])
            s, e = int(w.child_start[i, j]), int(w.child_end[i, j])
            if link >= 0:
                if s or e:
                    errors.append(f"node {i} child {j}: internal with range")
                if link in seen_link or link == 0:
                    errors.append(f"node {i} child {j}: duplicate link {link}")
                seen_link.add(link)
                if not (0 < link < w.num_nodes):
                    errors.append(f"node {i} child {j}: link {link} OOB")
            elif e > s:
                if e - s > w.leaf_k:
                    errors.append(f"node {i} child {j}: leaf span {e - s} > K")
                covered.append((s, e))
        for o in range(8):
            p = int(w.perm[i, o])
            ranks = {(p >> (3 * r)) & 7 for r in range(WIDE_W)}
            if len(ranks) != WIDE_W:
                errors.append(f"node {i} octant {o}: perm not a permutation")
    if num_tris and len(seen_link) != w.num_nodes - 1:
        errors.append(f"links reach {len(seen_link)} != {w.num_nodes - 1} nodes")
    covered.sort()
    pos = 0
    for s, e in covered:
        if s != pos:
            errors.append(f"leaf ranges not a partition at {s}")
            break
        pos = e
    if num_tris and pos != num_tris:
        errors.append(f"leaves cover {pos} != {num_tris}")
    return errors


def validate_bvh(bvh: FlatBVH, tri_verts_ordered: np.ndarray) -> list[str]:
    """Structural invariants used by tests (SURVEY.md §4)."""
    errors = []
    n = bvh.num_nodes
    for d in range(bvh.num_trees):
        o = d * n
        seen = np.zeros(0, np.int64)
        covered = []
        # walk every node; leaves partition [0, T)
        for i in range(n):
            s, e = int(bvh.start[o + i]), int(bvh.end[o + i])
            if e - s <= MAX_PRIM:
                covered.append((s, e))
            for link in (bvh.hit[o + i], bvh.miss[o + i]):
                if not (-1 <= link < n):
                    errors.append(f"tree {d} node {i}: link {link} out of range")
        covered.sort()
        pos = 0
        for s, e in covered:
            if s != pos:
                errors.append(f"tree {d}: leaf ranges not a partition at {s}")
                break
            pos = e
        if covered and pos != tri_verts_ordered.shape[0]:
            errors.append(f"tree {d}: leaves cover {pos} != T")
        # a full hit-walk from the root must visit every node exactly once
        # only for the non-MT layout (preorder next); for MT trees the walk
        # depends on AABB outcomes, so just check link ranges above.
        if bvh.num_trees == 1:
            visited = set()
            node = 0
            while node != -1 and len(visited) <= n:
                visited.add(node)
                node = int(bvh.hit[o + node])
            if len(visited) != n:
                errors.append(f"tree {d}: hit-chain visits {len(visited)} != {n}")
    return errors
