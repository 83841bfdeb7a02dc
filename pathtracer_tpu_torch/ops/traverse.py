"""Batched scene queries: closest hit and occlusion (any hit).

Port of `pathtracer_tpu/ops/traverse.py`.  Analytic geoms (spheres and cubes)
are swept on (N,) component columns exactly as the JAX package does; the
triangle part goes, by `packet_mode`, through the resident wide-BVH kernels
of `ops/traverse_cuda.py` (K1 closest hit, K2 shadow any-hit) or the
two-level streaming kernels of `ops/traverse_stream_cuda.py` (K3, K4; K5 for
closest hits when its `STREAM_BLOCKMAJOR` is true), which take the same
tables, rays and sentinels as the Pallas kernels they replace.

Two plain PyTorch walks stand beside the kernels, as the XLA loops of the
JAX package do (`pathtracer_tpu/ops/traverse.py _bvh_closest`,
`_brute_closest` and the two branches of `occlusion_test`): the threaded
MTBVH walk (`use_kernels=False`, the route of `pallas_traversal=False`) and
the brute-force sweep over every triangle (`use_bvh=False`, the reference's
USE_BVH=0).  They are cross-checks, not fast paths, but for one case: a
mesh that fits neither kernel table (`packet_mode` None) takes the MTBVH
walk, as the JAX package's takes its XLA walk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.scene.parser import CUBE, SPHERE
from pathtracer_tpu_torch.ops.intersect import (
    mat_rows,
    normalize_cols,
    ray_aabb,
    ray_triangle,
    xform_point_cols,
    xform_vector_cols,
)
from pathtracer_tpu_torch.ops.traverse_cuda import (
    closest_hit_wbvh,
    occlusion_wbvh,
)
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu_torch.ops.traverse_stream_cuda import (
    closest_hit_blockmajor,
    closest_hit_stream,
    occlusion_stream,
)
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic

FLT_MAX = 3.402823466e38
# Dead or unreachable lanes carry this t: node visits need
# `t_enter <= t`, and -FLT_MAX is below every finite t_enter.
DEAD_T = -FLT_MAX


class Hit(NamedTuple):
    t: torch.Tensor          # (N,) world distance; FLT_MAX = miss
    geom: torch.Tensor       # (N,) int32 geom index, -1 = miss
    tri: torch.Tensor        # (N,) int32 triangle index, -1 = analytic geom
    point: torch.Tensor      # (N, 3)
    normal: torch.Tensor     # (N, 3) geometric/interpolated normal
    uv: torch.Tensor         # (N, 2)
    tangent: torch.Tensor    # (N, 3)
    bitangent: torch.Tensor  # (N, 3)


def _geom_t_soa(flat: FlatScene, gi: int, gtype: int, ox, oy, oz, dx, dy, dz):
    """Column-form analytic test for one geom.

    Returns (valid, t_world, (px,py,pz) object hit, (wx,wy,wz) world hit,
    (nx,ny,nz) OBJECT normal) as (N,) columns, with the formulas of
    intersect.ray_sphere / ray_cube (pull-back and world-t quirk included).
    """
    inv = mat_rows(flat.geom_inv[gi])
    tr = mat_rows(flat.geom_transform[gi])
    rox, roy, roz = xform_point_cols(inv, ox, oy, oz)
    rdx, rdy, rdz = normalize_cols(*xform_vector_cols(inv, dx, dy, dz))
    if gtype == SPHERE:
        vdd = rox * rdx + roy * rdy + roz * rdz
        rad = vdd * vdd - ((rox * rox + roy * roy + roz * roz) - 0.25)
        root = torch.sqrt(torch.clamp(rad, min=0.0))
        t1, t2 = -vdd + root, -vdd - root
        valid = (rad >= 0.0) & ~((t1 < 0.0) & (t2 < 0.0))
        t_obj = torch.where((t1 > 0.0) & (t2 > 0.0),
                            torch.minimum(t1, t2), torch.maximum(t1, t2))
    else:
        i1x, i2x = (-0.5 - rox) / rdx, (0.5 - rox) / rdx
        i1y, i2y = (-0.5 - roy) / rdy, (0.5 - roy) / rdy
        i1z, i2z = (-0.5 - roz) / rdz, (0.5 - roz) / rdz
        gx = torch.minimum(i1x, i2x)
        gy = torch.minimum(i1y, i2y)
        gz = torch.minimum(i1z, i2z)
        gx = torch.where(gx > 0.0, gx, -1e38)
        gy = torch.where(gy > 0.0, gy, -1e38)
        gz = torch.where(gz > 0.0, gz, -1e38)
        tmin = torch.maximum(gx, torch.maximum(gy, gz))
        tmax = torch.minimum(torch.maximum(i1x, i2x),
                             torch.minimum(torch.maximum(i1y, i2y),
                                           torch.maximum(i1z, i2z)))
        valid = (tmax >= tmin) & (tmax > 0.0)
        t_obj = torch.where(tmin <= 0.0, tmax, tmin)
    px = rox + (t_obj - 1e-4) * rdx
    py = roy + (t_obj - 1e-4) * rdy
    pz = roz + (t_obj - 1e-4) * rdz
    wx, wy, wz = xform_point_cols(tr, px, py, pz)
    ex, ey, ez = wx - ox, wy - oy, wz - oz
    t = torch.sqrt(torch.clamp(ex * ex + ey * ey + ez * ez, min=0.0))
    if gtype == SPHERE:
        nx, ny, nz = px, py, pz
    else:
        # slab-entry axis basis * sign; argmax/argmin ties go to the FIRST axis
        sx = torch.where(i2x < i1x, 1.0, -1.0)
        sy = torch.where(i2y < i1y, 1.0, -1.0)
        sz = torch.where(i2z < i1z, 1.0, -1.0)
        inside = tmin <= 0.0
        tbx = torch.maximum(i1x, i2x)
        tby = torch.maximum(i1y, i2y)
        amin_x = gx >= tmin
        amin_y = ~amin_x & (gy >= tmin)
        amax_x = tbx <= tmax
        amax_y = ~amax_x & (tby <= tmax)
        ax_x = torch.where(inside, amax_x, amin_x)
        ax_y = torch.where(inside, amax_y, amin_y)
        sign = torch.where(ax_x, sx, torch.where(ax_y, sy, sz))
        nx = torch.where(ax_x, sign, 0.0)
        ny = torch.where(ax_y, sign, 0.0)
        nz = torch.where(ax_x | ax_y, 0.0, sign)
    return valid, t, (px, py, pz), (wx, wy, wz), (nx, ny, nz)


def _geoms_closest(flat: FlatScene, static: SceneStatic, o, d):
    """Closest analytic geom per ray: (t, geom, world point, world normal)."""
    N = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zero = torch.zeros((N,), dtype=torch.float32, device=o.device)
    t_min = torch.full((N,), FLT_MAX, dtype=torch.float32, device=o.device)
    geom = torch.full((N,), -1, dtype=torch.int32, device=o.device)
    wx_w = wy_w = wz_w = zero
    nxc = nyc = nzc = zero

    sweep = [(gi, gt) for gi, gt in enumerate(static.geom_types) if gt in (SPHERE, CUBE)]
    for gi, gtype in sweep:
        valid, t, _, (wx, wy, wz), (nx, ny, nz) = _geom_t_soa(
            flat, gi, gtype, ox, oy, oz, dx, dy, dz
        )
        better = valid & (t > 0.0) & (t < t_min)
        t_min = torch.where(better, t, t_min)
        geom = torch.where(better, gi, geom)
        wx_w = torch.where(better, wx, wx_w)
        wy_w = torch.where(better, wy, wy_w)
        wz_w = torch.where(better, wz, wz_w)
        nxc = torch.where(better, nx, nxc)
        nyc = torch.where(better, ny, nyc)
        nzc = torch.where(better, nz, nzc)

    if not sweep:
        z3 = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
        return t_min, geom, z3, z3.clone()

    # the winner's world normal: ONE normalize(invt @ n_obj), with the
    # winner's invt entries gathered per ray (the values equal the winner's
    # matrix exactly, so this matches transforming per geom)
    invt = flat.geom_invt[geom.clamp(min=0).long()]  # (N, 4, 4)
    m3 = tuple(tuple(invt[:, i, j] for j in range(3)) for i in range(3))
    nwx, nwy, nwz = normalize_cols(*xform_vector_cols(m3, nxc, nyc, nzc))
    found = geom >= 0
    point = torch.stack(
        [torch.where(found, wx_w, 0.0), torch.where(found, wy_w, 0.0),
         torch.where(found, wz_w, 0.0)], dim=1,
    )
    normal = torch.stack(
        [torch.where(found, nwx, 0.0), torch.where(found, nwy, 0.0),
         torch.where(found, nwz, 0.0)], dim=1,
    )
    return t_min, geom, point, normal


def packet_mode(static: SceneStatic) -> str | None:
    """Which kernels walk the scene's triangles: "resident" (K1/K2), "stream"
    (K3/K4) when the tables were built with the streaming split, or None for
    a mesh that fits neither, whose triangles take the MTBVH walk.
    `build_flat_scene` applied the JAX package's rule
    (`pathtracer_tpu/ops/traverse.py:308`) when it built the tables and
    recorded the answer, so the route follows the tables, not the budgets
    at call time."""
    return static.traversal


def _stream_args(static: SceneStatic) -> dict:
    return dict(sub_nodes=static.stream_sub_nodes, sub_tris=static.stream_sub_tris,
                top_depth=static.stream_top_depth, sub_depth=static.stream_sub_depth)


# The sort key of lanes that are dead or do not enter the walk: behind every
# live key (octant and cell keys are below 2^12, the root-box bit adds 2^12).
DEAD_KEY = 1 << 20


def octant_cell_key(flat: FlatScene, o, d):
    """((octant * 8 + cx) * 8 + cy) * 8 + cz: the direction's octant and the
    origin's cell of an 8^3 grid over the scene bounds (the JAX package's
    ray sort key, `pathtracer_tpu/integrator/wavefront.py:292-307`)."""
    bmin, bmax = flat.scene_lo, flat.scene_hi
    inv_ext = 7.999 / torch.clamp(bmax - bmin, min=1e-6)
    cell = torch.clamp((o - bmin) * inv_ext, 0.0, 7.999).to(torch.int32)
    octant = ((d[:, 0] > 0.0).to(torch.int32) + 2 * (d[:, 1] > 0.0).to(torch.int32)
              + 4 * (d[:, 2] > 0.0).to(torch.int32))
    return ((octant * 8 + cell[:, 0]) * 8 + cell[:, 1]) * 8 + cell[:, 2]


def _root_box_cull(flat: FlatScene, o, d, t_cap):
    """Lanes whose ray cannot reach the triangle root box within `t_cap`
    get DEAD_T, so the kernels skip them (the JAX pre-test at
    ops/traverse.py:377-383)."""
    rb = flat.root_box
    rb_hit, rb_enter = ray_aabb(rb[0:3], rb[3:6], o, d)
    reachable = rb_hit & (rb_enter <= t_cap)
    return torch.where(reachable, t_cap, DEAD_T)


# Triangles the sweep tests against every ray at once: (rays, SWEEP_CHUNK)
# intermediates instead of one triangle a step.
SWEEP_CHUNK = 256


def _lanes(mask, n: int, device):
    """Indices of the lanes `mask` selects (all n when it is None)."""
    if mask is None:
        return torch.arange(n, device=device)
    return torch.nonzero(mask).squeeze(1)


def _tri_test(flat: FlatScene, rows, o, d):
    """ray_triangle on the rows `rows` of `tri_data`, broadcast against o, d."""
    return ray_triangle(rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], o, d)


def sweep_closest(flat: FlatScene, static: SceneStatic, o, d, t_min, live=None):
    """The brute-force closest hit over every triangle (the reference's
    USE_BVH=0; the JAX package's `_brute_closest`): (t, tri, u, v), tri -1
    where no triangle is nearer than `t_min`, and on lanes `live` leaves
    out.  Chunks of SWEEP_CHUNK triangles keep the JAX package's rule that
    the first index wins a tie: strict < across chunks, the lowest index
    within one."""
    N, dev = o.shape[0], o.device
    t = t_min.clone()
    tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((N,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    idx = _lanes(live, N, dev)
    lo, ld, lt = o[idx][:, None, :], d[idx][:, None, :], t[idx]
    ltri, lu, lv = tri[idx], u[idx], v[idx]
    for c0 in range(0, static.num_tris, SWEEP_CHUNK):
        th, tt, tu, tv = _tri_test(flat, flat.tri_data[None, c0:c0 + SWEEP_CHUNK], lo, ld)
        tt = torch.where(th, tt, float("inf"))
        k = torch.argmin(tt, dim=1, keepdim=True)  # the first of equal minima
        best = tt.gather(1, k)[:, 0]
        take = best < lt
        lt = torch.where(take, best, lt)
        ltri = torch.where(take, (c0 + k[:, 0]).to(torch.int32), ltri)
        lu = torch.where(take, tu.gather(1, k)[:, 0], lu)
        lv = torch.where(take, tv.gather(1, k)[:, 0], lv)
    for full, part in ((t, lt), (tri, ltri), (u, lu), (v, lv)):
        full[idx] = part
    return t, tri, u, v


def sweep_occluded(flat: FlatScene, static: SceneStatic, ori, dir, min_t, enabled):
    """The brute-force shadow test: lanes `enabled` whose segment any
    triangle blocks, in the BVH walk's window (t < minT-1e-5 &&
    |t-minT| > 1e-4; the JAX package keeps that window here rather than the
    reference's inverted USE_BVH=0 branch)."""
    occ = torch.zeros_like(enabled)
    idx = _lanes(enabled, ori.shape[0], ori.device)
    lo, ld, lm = ori[idx][:, None, :], dir[idx][:, None, :], min_t[idx][:, None]
    blocked = torch.zeros((idx.shape[0],), dtype=torch.bool, device=ori.device)
    for c0 in range(0, static.num_tris, SWEEP_CHUNK):
        th, tt, _, _ = _tri_test(flat, flat.tri_data[None, c0:c0 + SWEEP_CHUNK], lo, ld)
        hit = th & (lm - 1e-5 > tt) & (torch.abs(tt - lm) > 1e-4)
        blocked = blocked | hit.any(dim=1)
    occ[idx] = blocked
    return occ


def _mtbvh_offset(static: SceneStatic, d):
    """The first node of each ray's tree: the direction's dominant axis and
    its sign pick one of the six (the JAX package's `_mtbvh_offset`)."""
    ad = torch.abs(d)
    axis = torch.where((ad[:, 0] > ad[:, 1]) & (ad[:, 0] > ad[:, 2]), 0,
                       torch.where(ad[:, 1] > ad[:, 2], 1, 2))
    comp = torch.gather(d, 1, axis[:, None])[:, 0]
    octant = axis + torch.where(comp > 0.0, 0, 3)
    return (octant * static.num_bvh_nodes).to(torch.int32)


class _Walk:
    """The lanes still walking the threaded MTBVH: their ids, their columns
    and their node.  `step` visits one node per lane; `advance` moves each
    lane along its hit or miss link and drops the lanes that leave the
    tree, with the step's one host read (the count of lanes left)."""

    def __init__(self, flat: FlatScene, static: SceneStatic, idx, o, d, cols: dict):
        self.flat, self.static, self.idx = flat, static, idx
        offset = (_mtbvh_offset(static, d) if static.num_bvh_trees == 6
                  else torch.zeros((d.shape[0],), dtype=torch.int32, device=d.device))
        self.cols = {"o": o, "d": d, "offset": offset, **cols}
        self.cols = {k: c[idx] for k, c in self.cols.items()}
        self.node = torch.zeros((idx.shape[0],), dtype=torch.int32, device=d.device)
        self.max_prim = max(static.max_prim, 1)

    def visit(self, t_cap):
        """(box_ok, node int row, leaf test) for each lane's node: its box
        entered within `t_cap`, and a function giving the k-th triangle's
        test and whether the k-th slot lies in a leaf of the node."""
        c, nn = self.cols, self.static.num_bvh_nodes
        nidx = (c["offset"] + self.node.clamp(0, nn - 1)).long()
        nf, ni = self.flat.bvh_f32[nidx], self.flat.bvh_i32[nidx]
        box_hit, t_enter = ray_aabb(nf[:, 0:3], nf[:, 3:6], c["o"], c["d"])
        box_ok = box_hit & (t_enter <= t_cap)
        is_leaf = (ni[:, 1] - ni[:, 0]) <= self.max_prim
        last = self.flat.tri_data.shape[0] - 1

        def leaf(k):
            tidx = (ni[:, 0] + k).clamp(0, last)
            test = _tri_test(self.flat, self.flat.tri_data[tidx.long()], c["o"], c["d"])
            return tidx, test, box_ok & is_leaf & (ni[:, 0] + k < ni[:, 1])

        return box_ok, ni, leaf

    def advance(self, box_ok, ni, stop=None) -> int:
        """Follow the hit link where the box was entered, else the miss
        link; lanes that leave the tree (or `stop`) drop out."""
        node = torch.where(box_ok, ni[:, 2], ni[:, 3])
        if stop is not None:
            node = torch.where(stop, -1, node)
        keep = torch.nonzero(node != -1).squeeze(1)
        if keep.shape[0] < node.shape[0]:
            self.idx, self.node = self.idx[keep], node[keep]
            self.cols = {k: c[keep] for k, c in self.cols.items()}
        else:
            self.node = node
        return keep.shape[0]

    @property
    def max_steps(self) -> int:
        return 4 * self.static.num_bvh_nodes + 4


def mtbvh_closest(flat: FlatScene, static: SceneStatic, o, d, t_min, live=None):
    """The stackless threaded walk of the MTBVH (the JAX package's
    `_bvh_closest`, its XLA route): (t, tri, u, v) as `sweep_closest`.  A
    lane whose node's box it enters within its best t follows the hit
    link, else the miss link; a leaf's triangles are tested in order, a
    nearer t wins.  The walk stops at 4 * nodes + 4 steps, as there."""
    N, dev = o.shape[0], o.device
    t = t_min.clone()
    tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((N,), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    w = _Walk(flat, static, _lanes(live, N, dev), o, d,
              {"t": t, "tri": tri, "u": u, "v": v})

    def write_back():
        for k, full in (("t", t), ("tri", tri), ("u", u), ("v", v)):
            full[w.idx] = w.cols[k]

    for _ in range(w.max_steps):
        if w.idx.shape[0] == 0:
            break
        c = w.cols
        box_ok, ni, leaf = w.visit(c["t"])
        for k in range(w.max_prim):
            tidx, (th, tt, tu, tv), in_leaf = leaf(k)
            take = in_leaf & th & (tt < c["t"])
            c["t"] = torch.where(take, tt, c["t"])
            c["tri"] = torch.where(take, tidx, c["tri"])
            c["u"] = torch.where(take, tu, c["u"])
            c["v"] = torch.where(take, tv, c["v"])
        write_back()
        w.advance(box_ok, ni)
    write_back()
    return t, tri, u, v


def mtbvh_occluded(flat: FlatScene, static: SceneStatic, ori, dir, min_t, enabled):
    """The MTBVH any-hit walk (the JAX package's `occlusion_test` XLA
    branch): lanes `enabled` whose segment a triangle blocks in the window
    (t < minT-1e-5 && |t-minT| > 1e-4); a lane stops at its first block."""
    occ = torch.zeros_like(enabled)
    w = _Walk(flat, static, _lanes(enabled, ori.shape[0], ori.device), ori, dir,
              {"min_t": min_t})
    for _ in range(w.max_steps):
        if w.idx.shape[0] == 0:
            break
        mt = w.cols["min_t"]
        box_ok, ni, leaf = w.visit(mt)
        blocked = torch.zeros_like(box_ok)
        for k in range(w.max_prim):
            _, (th, tt, _, _), in_leaf = leaf(k)
            blocked = blocked | (in_leaf & th & (mt - 1e-5 > tt) & (torch.abs(tt - mt) > 1e-4))
        occ[w.idx] = blocked
        w.advance(box_ok, ni, stop=blocked)
    return occ


def _kernel_closest(flat: FlatScene, static: SceneStatic, o, d, t_min, alive):
    """The triangles' closest hit through K1, K3 or K5: dead lanes and those
    the root box culls carry DEAD_T into the kernel."""
    t_init = t_min if alive is None else torch.where(alive, t_min, DEAD_T)
    t_init = _root_box_cull(flat, o, d, t_init)
    if packet_mode(static) == "stream" and ts.STREAM_BLOCKMAJOR:
        return closest_hit_blockmajor(
            flat.str_roots, flat.str_subf, flat.str_subi, flat.str_subp,
            flat.str_subt, flat.str_base, o, d, t_init, sub_nodes=static.stream_sub_nodes,
            sub_tris=static.stream_sub_tris, sub_depth=static.stream_sub_depth,
            subt12=flat.str_subt12, blocks=flat.str_blocks, roots8=flat.str_roots8,
            groups=flat.str_groups,
        )
    if packet_mode(static) == "stream":
        return closest_hit_stream(
            flat.str_topf, flat.str_topl, flat.str_topp, flat.str_subf, flat.str_subi,
            flat.str_subp, flat.str_subt, flat.str_base, o, d, t_init,
            **_stream_args(static), subt12=flat.str_subt12, blocks=flat.str_blocks,
        )
    return closest_hit_wbvh(
        flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk, o, d, t_init,
        wide_depth=static.wide_depth,
    )


def closest_hit(flat: FlatScene, static: SceneStatic, o, d, alive=None,
                use_kernels: bool = True, use_bvh: bool = True) -> Hit:
    """Full-scene closest hit (analytic geoms + triangles).  The triangles go
    through the kernels, or with `use_kernels=False` (or no kernel table,
    `packet_mode` None) the MTBVH walk, or with `use_bvh=False` the
    brute-force sweep; lanes not `alive` test no triangle."""
    N = o.shape[0]
    dev = o.device
    t_min, geom, point, normal = _geoms_closest(flat, static, o, d)
    tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    uv = torch.zeros((N, 2), dtype=torch.float32, device=dev)
    tangent = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    bitangent = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    if static.num_tris == 0:
        return Hit(t_min, geom, tri, point, normal, uv, tangent, bitangent)

    if not (use_bvh and use_kernels and packet_mode(static)):
        walk = sweep_closest if not use_bvh else mtbvh_closest
        t_tri, tri, u, v = walk(flat, static, o, d, t_min, live=alive)
    else:
        t_tri, tri, u, v = _kernel_closest(flat, static, o, d, t_min, alive)
    t_min = torch.where(tri >= 0, t_tri, t_min)

    # barycentric hit attributes
    got_tri = tri >= 0
    trow = flat.tri_data[tri.clamp(min=0).long()]
    w0 = (1.0 - u - v)[..., None]
    uw, vw = u[..., None], v[..., None]
    p_tri = w0 * trow[:, 0:3] + uw * trow[:, 3:6] + vw * trow[:, 6:9]
    n_tri = w0 * trow[:, 9:12] + uw * trow[:, 12:15] + vw * trow[:, 15:18]
    uv_tri = w0 * trow[:, 18:20] + uw * trow[:, 20:22] + vw * trow[:, 22:24]
    gm = got_tri[..., None]
    point = torch.where(gm, p_tri, point)
    normal = torch.where(gm, n_tri, normal)
    uv = torch.where(gm, torch.clamp(uv_tri, 0.0, 1.0), uv)
    tangent = torch.where(gm, trow[:, 24:27], tangent)
    bitangent = torch.where(gm, trow[:, 27:30], bitangent)
    geom = torch.where(got_tri, trow[:, 30].to(torch.int32), geom)
    return Hit(t_min, geom, tri, point, normal, uv, tangent, bitangent)


def occlusion_test(flat: FlatScene, static: SceneStatic, ori, dir, des, enabled=None,
                   shadow_sort: bool = False, use_kernels: bool = True, use_bvh: bool = True):
    """Is the segment ori -> des blocked?  Analytic geoms with the window
    (t < minT-1e-5 && |t-minT| > 1e-2), then triangles through K2 (K4 for a
    streamed mesh), or with `use_kernels=False` (or no kernel table,
    `packet_mode` None) the MTBVH walk, or with
    `use_bvh=False` the brute-force sweep, with (t < minT-1e-5 &&
    |t-minT| > 1e-4).

    `shadow_sort` hands the kernel its rays sorted by `octant_cell_key`,
    the lanes that do not enter the walk (disabled or culled by the root
    box) behind them, and un-permutes the result: the same booleans, in
    an order whose neighbouring lanes share nodes.  The walks ignore it, as
    the JAX package's do."""
    N = ori.shape[0]
    e = des - ori
    min_t = torch.sqrt(torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2], min=0.0))
    occluded = torch.zeros((N,), dtype=torch.bool, device=ori.device)

    ox, oy, oz = ori[:, 0], ori[:, 1], ori[:, 2]
    dx, dy, dz = dir[:, 0], dir[:, 1], dir[:, 2]
    for gi, gtype in enumerate(static.geom_types):
        if gtype not in (SPHERE, CUBE):
            continue
        valid, t, _, _, _ = _geom_t_soa(flat, gi, gtype, ox, oy, oz, dx, dy, dz)
        blocked = valid & (t > 0.0) & (min_t - 1e-5 > t) & (torch.abs(t - min_t) > 1e-2)
        occluded = occluded | blocked

    if static.num_tris == 0:
        return occluded
    if not (use_bvh and use_kernels and packet_mode(static)):
        walk = sweep_occluded if not use_bvh else mtbvh_occluded
        on = ~occluded if enabled is None else enabled & ~occluded
        return occluded | walk(flat, static, ori, dir, min_t, on)
    min_t_eff = min_t if enabled is None else torch.where(enabled, min_t, DEAD_T)
    min_t_eff = _root_box_cull(flat, ori, dir, min_t_eff)
    perm = None
    if shadow_sort:
        key = torch.where(min_t_eff <= DEAD_T, DEAD_KEY, octant_cell_key(flat, ori, dir))
        perm = torch.sort(key, stable=True).indices
        ori, dir, min_t_eff, occluded = (
            a.index_select(0, perm) for a in (ori, dir, min_t_eff, occluded))
    if packet_mode(static) == "stream":
        occluded = occlusion_stream(
            flat.str_topf, flat.str_topl, flat.str_subf, flat.str_subi, flat.str_subt,
            flat.str_base, ori, dir, min_t_eff, occluded, **_stream_args(static),
            subt12=flat.str_subt12, blocks=flat.str_blocks,
        )
    else:
        occluded = occlusion_wbvh(
            flat.bvh_wf, flat.bvh_wi, flat.tri_pk, ori, dir, min_t_eff, occluded,
            wide_depth=static.wide_depth,
        )
    if perm is not None:
        out = torch.empty_like(occluded)
        out[perm] = occluded
        occluded = out
    return occluded
