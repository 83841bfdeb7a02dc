"""Wide-BVH traversal kernels K1 (closest hit) and K2 (shadow any-hit).

Port of the two resident Pallas kernels of
`pathtracer_tpu/ops/traverse_pallas.py`: `closest_hit_wbvh_pallas` (K1) and
`occlusion_wbvh_pallas` (K2).  The CUDA kernels live in
`csrc/wbvh_traverse.cu`, their walks in `csrc/walk_core.cuh` (K1 shares its
closest-hit walk with K3, K2 its any-hit walk with K4); this module holds,
for each:

- the wrapper (`closest_hit_wbvh`, `occlusion_wbvh`): on a CPU tensor it
  runs the plain PyTorch version; on a CUDA tensor it launches the kernel
  (building it on first use) or raises.  It never falls back.
- the plain PyTorch version (`*_plain`): a lockstep, masked walk of the same
  tables with an (N, STACK) stack tensor.  K1's has the kernel's per-ray
  visit order, so kernel and plain version agree exactly (ties included).
  K2's visits children in slot order where the kernel tests a node's leaf
  cuts before it pushes its inner children; both cap the box test at min_t,
  which a ray never changes, so both reach the same boxes and agree on
  every lane.

The wrappers launch through `ops/_build.py launch`, which counts K1's and
K2's launches in its table.  `slab` and `moller_trumbore` are the plain
versions' box and triangle tests, which the streaming walks and the probes
share.

Semantics (as the Pallas kernels): K1 starts from t = t_init, tri = -1,
u = v = 0 and takes a triangle only if strictly closer; lanes with
t_init = -FLT_MAX never enter.  K2 keeps `occluded0` lanes blocked, never
blocks lanes with min_t = -FLT_MAX, and blocks on a hit with
t < min_t - 1e-5 and |t - min_t| > 1e-4.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import _build

STACK = 64  # per-ray traversal stack (csrc/walk_core.cuh WALK_STACK)


def _check_depth(wide_depth: int) -> None:
    # an 8-ary walk keeps at most 7 pending siblings per level plus the node
    if 7 * int(wide_depth) + 1 > STACK:
        raise ValueError(
            f"wide BVH depth {wide_depth} needs a stack of {7 * wide_depth + 1} "
            f"entries; the kernels have {STACK}"
        )


# ---------------------------------------------------------------------------
# plain PyTorch versions


def slab(box, ox, oy, oz, idx, idy, idz):
    """(hit, t_enter) of (A, 6) boxes; NaN-propagating like the kernel's
    nan_min/nan_max (an empty NaN slot, or 0 * inf, rejects)."""
    lo_x, hi_x = (box[:, 0] - ox) * idx, (box[:, 3] - ox) * idx
    lo_y, hi_y = (box[:, 1] - oy) * idy, (box[:, 4] - oy) * idy
    lo_z, hi_z = (box[:, 2] - oz) * idz, (box[:, 5] - oz) * idz
    te = torch.maximum(
        torch.maximum(torch.minimum(lo_x, hi_x), torch.minimum(lo_y, hi_y)),
        torch.minimum(lo_z, hi_z),
    )
    tx = torch.minimum(
        torch.minimum(torch.maximum(lo_x, hi_x), torch.maximum(lo_y, hi_y)),
        torch.maximum(lo_z, hi_z),
    )
    return (te <= tx) & (tx > 0.0), te


def moller_trumbore(r, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore on (..., 12) edge-form rows; the kernel's operation
    order.  Ray components broadcast against r[..., k]."""
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


class _Walk:
    """Per-ray state of a lockstep walk: the rays, their stacks, and the
    active subset popped this step."""

    def __init__(self, wf, wi, tri12, o, d, live, counts=None):
        n = o.shape[0]
        self.counts = counts
        self.boxes = wf.view(-1, 8, 6)
        self.links = wi.view(-1, 3, 8)
        self.tri = tri12.view(-1, 12)
        self.o, self.d = o, d
        self.inv = 1.0 / d
        # one spare column: a push stores unconditionally at the live top
        self.stack = torch.zeros((n, STACK + 1), dtype=torch.int32, device=o.device)
        self.sp = live.to(torch.int64)  # the root (node 0) is pushed for live lanes
        # widest leaf cut: the kernel loops [start, end), the plain walk
        # tests this many rows per cut, masked
        self.leaf_k = max(int((self.links[:, 2] - self.links[:, 1]).max()), 1)

    def pop(self):
        """Pop one node per active lane; returns (lanes, node, sp) or None."""
        act = torch.nonzero(self.sp > 0).squeeze(1)
        if act.numel() == 0:
            return None
        if self.counts is not None:
            self.counts["box"] += 8 * act.numel()
        sp = self.sp[act] - 1
        node = self.stack[act, sp].long()
        o, d, inv = self.o[act], self.d[act], self.inv[act]
        self.ray = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
        self.ray_inv = (o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2])
        return act, node, sp

    def child(self, node, slot):
        """Slab test of child `slot` of each popped node, with its link and
        leaf range: (hit, t_enter, link, start, end)."""
        hit, te = slab(self.boxes[node, slot], *self.ray_inv)
        return hit, te, self.links[node, 0, slot], self.links[node, 1, slot], self.links[node, 2, slot]

    def push(self, act, sp, link, take):
        self.stack[act, sp] = link
        return sp + take.to(torch.int64)

    def leaf_rows(self, li, start, end):
        """Triangle ids (L, leaf_k), rows (L, leaf_k, 12) and validity of the
        cuts [start, end), for the leaf lanes `li`."""
        ks = torch.arange(self.leaf_k, device=start.device)
        tid = start[li, None] + ks
        rows = self.tri[tid.clamp(max=self.tri.shape[0] - 1).long()]
        valid = tid < end[li, None]
        if self.counts is not None:
            self.counts["tri"] += int(valid.sum())
        return tid, rows, valid

    def ray_cols(self, li):
        ox, oy, oz, dx, dy, dz = self.ray
        return tuple(c[li, None] for c in (ox, oy, oz, dx, dy, dz))


def closest_hit_wbvh_plain(wf, wi, wp, tri12, o, d, t_init, counts: dict | None = None):
    """Plain PyTorch K1 (any device): returns (t, tri, u, v).  `counts`, if
    given, accumulates the box tests ("box", 8 per pop) and triangle tests
    ("tri") of the walk."""
    n = o.shape[0]
    dev = o.device
    w = _Walk(wf, wi, tri12, o, d, t_init >= 0.0, counts)
    perms = wp.view(-1, 8)
    octant = ((d[:, 0] > 0).long() + 2 * (d[:, 1] > 0).long() + 4 * (d[:, 2] > 0).long())
    best_t = t_init.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    while (popped := w.pop()) is not None:
        act, node, sp = popped
        bt, btri, bu, bv = best_t[act], best_tri[act], best_u[act], best_v[act]
        perm = perms[node, octant[act]]
        for rank in range(7, -1, -1):  # far -> near: the nearest child is pushed last
            slot = ((perm >> (3 * rank)) & 7).long()
            hit, te, link, start, end = w.child(node, slot)
            take = hit & (te <= bt)
            sp = w.push(act, sp, link, take & (link >= 0))
            li = torch.nonzero(take & (link < 0)).squeeze(1)
            if li.numel() == 0:
                continue
            tid, rows, valid = w.leaf_rows(li, start, end)
            th, tt, tu, tv = moller_trumbore(rows, *w.ray_cols(li))
            th = th & valid
            lt, ltri, lu, lv = bt[li], btri[li], bu[li], bv[li]
            for k in range(w.leaf_k):  # in cut order, strictly closer wins
                upd = th[:, k] & (tt[:, k] < lt)
                lt = torch.where(upd, tt[:, k], lt)
                ltri = torch.where(upd, tid[:, k].to(torch.int32), ltri)
                lu = torch.where(upd, tu[:, k], lu)
                lv = torch.where(upd, tv[:, k], lv)
            bt[li], btri[li], bu[li], bv[li] = lt, ltri, lu, lv
        w.sp[act] = sp
        best_t[act], best_tri[act], best_u[act], best_v[act] = bt, btri, bu, bv
    return best_t, best_tri, best_u, best_v


def occlusion_wbvh_plain(wf, wi, tri12, o, d, min_t, occluded0, counts: dict | None = None):
    """Plain PyTorch K2 (any device): returns (N,) bool."""
    occ = occluded0.clone()
    w = _Walk(wf, wi, tri12, o, d, ~occluded0 & (min_t >= 0.0), counts)
    t_far = min_t - 1e-5
    while (popped := w.pop()) is not None:
        act, node, sp = popped
        mt, tf, blocked = min_t[act], t_far[act], occ[act]
        for slot in range(8):  # any-hit: order-free
            slot_t = torch.full_like(node, slot)
            hit, te, link, start, end = w.child(node, slot_t)
            take = hit & (te <= mt) & ~blocked
            sp = w.push(act, sp, link, take & (link >= 0))
            li = torch.nonzero(take & (link < 0)).squeeze(1)
            if li.numel() == 0:
                continue
            tid, rows, valid = w.leaf_rows(li, start, end)
            th, tt, _, _ = moller_trumbore(rows, *w.ray_cols(li))
            hits = (
                th & valid & (tf[li, None] > tt)
                & (torch.abs(tt - mt[li, None]) > 1e-4)
            )
            blocked[li] = blocked[li] | hits.any(dim=1)
        occ[act] = blocked
        w.sp[act] = torch.where(blocked, 0, sp)  # a blocked ray stops
    return occ


# ---------------------------------------------------------------------------
# wrappers


def closest_hit_wbvh(wf, wi, wp, tri12, o, d, t_init, *, wide_depth: int):
    """K1: closest hit of N rays against the resident wide BVH.

    Returns (t, tri, u, v); tri is -1 where nothing beat t_init.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_depth(wide_depth)
    _build.check_rays(o, d)
    if _build.device_type(o, "closest_hit_wbvh") == "cpu":
        return closest_hit_wbvh_plain(wf, wi, wp, tri12, o, d, t_init)
    f32, i32 = torch.float32, torch.int32
    _build.check_cuda_args(
        dict(wf=wf, wi=wi, wp=wp, tri12=tri12, o=o, d=d, t_init=t_init),
        dict(wf=f32, wi=i32, wp=i32, tri12=f32, o=f32, d=f32, t_init=f32),
    )
    _build.check_aligned(wf=wf, wi=wi, tri12=tri12)
    n = o.shape[0]
    t = torch.empty((n,), dtype=f32, device=o.device)
    tri = torch.empty((n,), dtype=i32, device=o.device)
    u = torch.empty((n,), dtype=f32, device=o.device)
    v = torch.empty((n,), dtype=f32, device=o.device)
    _build.launch("pt_closest_hit_wbvh", o.device, wf, wi, wp, tri12, o, d, t_init, t, tri, u, v,
                  n)
    return t, tri, u, v


def occlusion_wbvh(wf, wi, tri12, o, d, min_t, occluded0, *, wide_depth: int):
    """K2: shadow any-hit against the resident wide BVH; (N,) bool.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    reads wf, wi and tri12 in 16-byte loads."""
    _check_depth(wide_depth)
    _build.check_rays(o, d)
    if _build.device_type(o, "occlusion_wbvh") == "cpu":
        return occlusion_wbvh_plain(wf, wi, tri12, o, d, min_t, occluded0)
    f32 = torch.float32
    _build.check_cuda_args(
        dict(wf=wf, wi=wi, tri12=tri12, o=o, d=d, min_t=min_t, occluded0=occluded0),
        dict(wf=f32, wi=torch.int32, tri12=f32, o=f32, d=f32, min_t=f32,
             occluded0=torch.bool),
    )
    _build.check_aligned(wf=wf, wi=wi, tri12=tri12)
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    _build.launch("pt_occlusion_wbvh", o.device, wf, wi, tri12, o, d, min_t, occluded0, occ,
                  o.shape[0])
    return occ
