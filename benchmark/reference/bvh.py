"""The benchmark's own BVH over a scene's triangles, and the plain walks over
it: the reference's closest hit and shadow test for triangles, and the count
of box and triangle tests that `walk_roofline_pct` charges the traversal
kernels for.

The tree is binary, built top-down by binned SAH (16 bins on the centroids'
longest axis; a set of at most LEAF triangles is a leaf), with each box widened by a
few ulps so that no rounding in the slab test loses a triangle the
Möller-Trumbore test would hit.  The walks are the textbook ones: a stack per
ray; at an inner node both child boxes are tested and the entered ones
pushed, the nearer last; a leaf's triangles are tested in order.  The
closest-hit walk keeps a triangle strictly nearer than its best; the shadow
walk stops at the first triangle inside the segment's window (t < min_t -
1e-5 and |t - min_t| > 1e-4, the window of the renderer's shadow test).  The
triangle test is Möller-Trumbore on edge-form rows in the operation order
the renderer's kernels use, so a triangle both find gives the same t, u, v.

The counts depend only on this tree and the rays, so they read the same
whatever tables, tree or kernel the program uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LEAF = 4
BINS = 16
STACK = 64


@dataclass
class BVH:
    lo: torch.Tensor      # (M, 3) node boxes
    hi: torch.Tensor      # (M, 3)
    left: torch.Tensor    # (M,) int64: first child, -1 at a leaf
    right: torch.Tensor   # (M,) int64: second child, or the leaf's first triangle
    count: torch.Tensor   # (M,) int64: the leaf's triangles, 0 at an inner node
    tri: torch.Tensor     # (T, 9) float32: v0, e1 = v1 - v0, e2 = v2 - v0, in leaf order
    order: torch.Tensor   # (T,) int64: the scene's triangle index of each row

    @property
    def nbytes(self) -> int:
        """Bytes of the tables a walk reads: a node as two float32 boxes'
        halves and two int32 links (32 bytes), a triangle as 9 float32."""
        return 32 * self.lo.shape[0] + 36 * self.tri.shape[0]


def _sah_split(cent, lo, hi, idx):
    """(axis, threshold) of the cheapest binned SAH split of triangles
    `idx`, or None for a leaf."""
    if len(idx) <= LEAF:
        return None
    c = cent[idx]
    cmin, cmax = c.min(0), c.max(0)
    axis = int(np.argmax(cmax - cmin))
    ext = cmax[axis] - cmin[axis]
    if ext <= 0.0:
        return None
    b = np.minimum(((c[:, axis] - cmin[axis]) / ext * BINS).astype(np.int64), BINS - 1)
    area = lambda l, h: (lambda e: e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])(np.maximum(h - l, 0.0))  # noqa: E731
    blo = np.full((BINS, 3), np.inf)
    bhi = np.full((BINS, 3), -np.inf)
    np.minimum.at(blo, b, lo[idx])
    np.maximum.at(bhi, b, hi[idx])
    n = np.bincount(b, minlength=BINS)
    llo, lhi = np.minimum.accumulate(blo), np.maximum.accumulate(bhi)
    rlo, rhi = np.minimum.accumulate(blo[::-1])[::-1], np.maximum.accumulate(bhi[::-1])[::-1]
    nl, nr = np.cumsum(n), np.cumsum(n[::-1])[::-1]
    cost = area(llo[:-1], lhi[:-1]) * nl[:-1] + area(rlo[1:], rhi[1:]) * nr[1:]
    cost = np.where((nl[:-1] > 0) & (nr[1:] > 0), cost, np.inf)
    k = int(np.argmin(cost))
    if not np.isfinite(cost[k]):
        return None
    return axis, cmin[axis] + ext * (k + 1) / BINS


def build(tri_v: np.ndarray, device) -> BVH:
    """The tree over triangles `tri_v` (T, 3, 3) float32."""
    lo, hi = tri_v.min(1).astype(np.float64), tri_v.max(1).astype(np.float64)
    cent = (lo + hi) * 0.5
    nodes, order = [], []  # node: [lo, hi, left, right, count]
    todo = [(np.arange(len(tri_v)), -1, 0)]
    while todo:
        idx, parent, side = todo.pop()
        me = len(nodes)
        if parent >= 0:
            nodes[parent][2 + side] = me
        box_lo, box_hi = lo[idx].min(0), hi[idx].max(0)
        split = _sah_split(cent, lo, hi, idx) if len(idx) > 1 else None
        if split is None and len(idx) > LEAF:  # equal centroids: halve the list
            split = "half"
        if split is None:
            nodes.append([box_lo, box_hi, -1, len(order), len(idx)])
            order.extend(idx.tolist())
            continue
        if split == "half":
            a, b = idx[: len(idx) // 2], idx[len(idx) // 2:]
        else:
            axis, thr = split
            below = cent[idx, axis] < thr
            a, b = idx[below], idx[~below]
        nodes.append([box_lo, box_hi, 0, 0, 0])
        todo.append((b, me, 1))
        todo.append((a, me, 0))
    nlo = np.array([n[0] for n in nodes])
    nhi = np.array([n[1] for n in nodes])
    pad = 4e-7 * np.maximum(np.abs(nlo), np.abs(nhi)) + 1e-30
    order = np.asarray(order, np.int64)
    v = tri_v[order]
    rows = np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=1).astype(np.float32)
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    return BVH(lo=as_t(nlo - pad, torch.float32), hi=as_t(nhi + pad, torch.float32),
               left=as_t([n[2] for n in nodes], torch.int64),
               right=as_t([n[3] for n in nodes], torch.int64),
               count=as_t([n[4] for n in nodes], torch.int64),
               tri=as_t(rows, torch.float32), order=as_t(order, torch.int64))


def moller_trumbore(r, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore on (..., 9) edge-form rows, ray components
    broadcast against them: (hit, t, u, v)."""
    e1x, e1y, e1z = r[..., 3], r[..., 4], r[..., 5]
    e2x, e2y, e2z = r[..., 6], r[..., 7], r[..., 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tx, ty, tz = ox - r[..., 0], oy - r[..., 1], oz - r[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det != 0.0) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
    return hit, t, u, v


def _box(bvh: BVH, node, o, inv):
    """Slab test of boxes `node` against rays (o, 1/d): (hit, t_enter)."""
    a = (bvh.lo[node] - o) * inv
    b = (bvh.hi[node] - o) * inv
    te = torch.minimum(a, b).amax(-1)
    tx = torch.maximum(a, b).amin(-1)
    return (te <= tx) & (tx > 0.0), te


def _walk(bvh: BVH, o, d, cap, leaf_fn, counts):
    """Drive the stack walk over rays (o, d) whose boxes count while
    entered at t <= cap (a tensor `leaf_fn` may lower): `leaf_fn(lanes,
    first, count)` tests a leaf's triangles for lanes `lanes` and returns
    the lanes that stop."""
    n = o.shape[0]
    inv = 1.0 / d
    stack = torch.zeros((n, STACK + 1), dtype=torch.int64, device=o.device)
    root = torch.zeros((n,), dtype=torch.int64, device=o.device)
    hit, te = _box(bvh, root, o, inv)
    sp = (hit & (te <= cap)).long()
    if counts is not None:
        counts["box"] += n
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            return
        spa = sp[act] - 1
        node = stack[act, spa]
        sp[act] = spa
        inner = bvh.left[node] >= 0
        ia = act[inner]
        if ia.numel():
            kids = torch.stack([bvh.left[node[inner]], bvh.right[node[inner]]], 1)  # (k, 2)
            h, t = _box(bvh, kids, o[ia, None], inv[ia, None])
            h = h & (t <= cap[ia, None])
            if counts is not None:
                counts["box"] += 2 * ia.numel()
            near = (t[:, 0] > t[:, 1]).long()  # the nearer child goes in last
            for col in (1 - near, near):
                sel = h.gather(1, col[:, None])[:, 0]
                kid = kids.gather(1, col[:, None])[:, 0]
                pos = sp[ia]
                stack[ia, pos] = torch.where(sel, kid, stack[ia, pos])
                sp[ia] = pos + sel.long()
        la = act[~inner]
        if la.numel():
            stop = leaf_fn(la, bvh.right[node[~inner]], bvh.count[node[~inner]])
            if stop is not None:
                sp[la[stop]] = 0


def _leaf_rows(bvh: BVH, first, count, counts):
    ks = torch.arange(LEAF, device=first.device)
    tid = first[:, None] + ks
    valid = ks < count[:, None]
    if counts is not None:
        counts["tri"] += int(valid.sum())
    return tid.clamp(max=bvh.tri.shape[0] - 1), valid


def walk_closest(bvh: BVH, o, d, t_cap, counts: dict | None = None):
    """Nearest triangle strictly below `t_cap` along each ray: (t, tri, u,
    v), tri the scene's triangle index or -1 (t then t_cap).  `counts`, if
    given, gains the walk's "box" and "tri" tests."""
    best_t = t_cap.clone()
    best_tri = torch.full_like(best_t, -1, dtype=torch.int64)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)

    def leaf(lanes, first, count):
        tid, valid = _leaf_rows(bvh, first, count, counts)
        oo, dd = o[lanes], d[lanes]
        th, tt, tu, tv = moller_trumbore(bvh.tri[tid], *(c[:, None] for c in (
            oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0], dd[:, 1], dd[:, 2])))
        lt, ltri, lu, lv = best_t[lanes], best_tri[lanes], best_u[lanes], best_v[lanes]
        for k in range(LEAF):
            upd = valid[:, k] & th[:, k] & (tt[:, k] < lt)
            lt = torch.where(upd, tt[:, k], lt)
            ltri = torch.where(upd, tid[:, k], ltri)
            lu = torch.where(upd, tu[:, k], lu)
            lv = torch.where(upd, tv[:, k], lv)
        best_t[lanes], best_tri[lanes], best_u[lanes], best_v[lanes] = lt, ltri, lu, lv
        return None

    _walk(bvh, o, d, best_t, leaf, counts)
    tri = torch.where(best_tri >= 0, bvh.order[best_tri.clamp(min=0)], -1)
    return best_t, tri, best_u, best_v


def walk_occluded(bvh: BVH, o, d, min_t, enabled, counts: dict | None = None):
    """Lanes `enabled` whose segment of length `min_t` a triangle blocks."""
    occ = torch.zeros_like(enabled)
    cap = torch.where(enabled, min_t, torch.full_like(min_t, -torch.inf))

    def leaf(lanes, first, count):
        tid, valid = _leaf_rows(bvh, first, count, counts)
        oo, dd = o[lanes], d[lanes]
        th, tt, _, _ = moller_trumbore(bvh.tri[tid], *(c[:, None] for c in (
            oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0], dd[:, 1], dd[:, 2])))
        mt = min_t[lanes, None]
        blocked = (valid & th & (mt - 1e-5 > tt) & (torch.abs(tt - mt) > 1e-4)).any(1)
        occ[lanes] = occ[lanes] | blocked
        return blocked

    _walk(bvh, o, d, cap, leaf, counts)
    return occ


# The reference's walks: the same tree, breadth first.  Every (ray, node)
# pair of one level is tested at once, so a walk takes as many steps as the
# tree is deep, not as many as its longest ray visits; boxes entered beyond
# a ray's best hit so far are dropped after each level.  The results are the
# stack walks' (a tie of two triangles at one t goes to the lower row, where
# a stack walk keeps the one it met first).


def _frontier(bvh: BVH, o, d, cap, leaf_fn, done=None):
    """Drive the level-by-level walk: `leaf_fn(rays, first, count)` tests
    the leaves reached; `cap` (a tensor leaf_fn may lower) culls boxes; rays
    `done` marks (a tensor leaf_fn may set) leave the walk."""
    inv = 1.0 / d
    ray = torch.arange(o.shape[0], device=o.device)
    node = torch.zeros_like(ray)
    while ray.numel():
        h, te = _box(bvh, node, o[ray], inv[ray])
        keep = h & (te <= cap[ray])
        if done is not None:
            keep &= ~done[ray]
        ray, node = ray[keep], node[keep]
        leaf = bvh.left[node] < 0
        if leaf.any():
            leaf_fn(ray[leaf], bvh.right[node[leaf]], bvh.count[node[leaf]])
        ray, node = ray[~leaf].repeat_interleave(2), node[~leaf]
        node = torch.stack([bvh.left[node], bvh.right[node]], 1).reshape(-1)


def _pairs(bvh: BVH, o, d, rays, first, count):
    """The (ray, triangle row) pairs of leaves reached, and their tests."""
    ks = torch.arange(LEAF, device=first.device)
    valid = ks < count[:, None]
    pr = rays[:, None].expand(-1, LEAF)[valid]
    pt = (first[:, None] + ks)[valid]
    oo, dd = o[pr], d[pr]
    return pr, pt, moller_trumbore(bvh.tri[pt], oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0], dd[:, 1], dd[:, 2])


def closest(bvh: BVH, o, d, t_cap):
    """As `walk_closest`: (t, tri, u, v), tri the scene's triangle index or
    -1 (t then t_cap)."""
    best_t = t_cap.clone()
    row = torch.full(best_t.shape, -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)

    def leaf(rays, first, count):
        pr, pt, (th, tt, tu, tv) = _pairs(bvh, o, d, rays, first, count)
        c = th & (tt < best_t[pr])
        pr, pt, tt, tu, tv = pr[c], pt[c], tt[c], tu[c], tv[c]
        if not pr.numel():
            return
        best_t.scatter_reduce_(0, pr, tt, "amin")
        w = tt == best_t[pr]
        win = torch.full_like(row, bvh.tri.shape[0])
        win.scatter_reduce_(0, pr[w], pt[w], "amin")
        w &= pt == win[pr]
        row[pr[w]], best_u[pr[w]], best_v[pr[w]] = pt[w], tu[w], tv[w]

    _frontier(bvh, o, d, best_t, leaf)
    tri = torch.where(row >= 0, bvh.order[row.clamp(min=0)], -1)
    return best_t, tri, best_u, best_v


def occluded(bvh: BVH, o, d, min_t, enabled):
    """As `walk_occluded`: lanes `enabled` whose segment a triangle blocks."""
    occ = torch.zeros_like(enabled)
    cap = torch.where(enabled, min_t, torch.full_like(min_t, -torch.inf))

    def leaf(rays, first, count):
        pr, _, (th, tt, _, _) = _pairs(bvh, o, d, rays, first, count)
        mt = min_t[pr]
        hit = th & (mt - 1e-5 > tt) & (torch.abs(tt - mt) > 1e-4)
        occ[pr[hit]] = True

    _frontier(bvh, o, d, cap, leaf, done=occ)
    return occ
