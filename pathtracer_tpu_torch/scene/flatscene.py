"""FlatScene: the device-resident scene tables as tensors.

Port of `pathtracer_tpu/scene/flatscene.py`.  The tables are built with the
same numpy code as the JAX package (each function names its counterpart), so
the two packages hold equal tables for the same scene: identical BVH tables
are what make triangle-id parity exact.  The fields carry the JAX names.

A mesh within `resident_tables_fit` is walked through the wide tables
(`bvh_w*`, `tri_pk`; kernels K1/K2); a larger one through the two-level
streaming tables (`str_*`, `build_stream_tables`; kernels K3/K4, and K5,
whose plain version reads the blocks' root boxes `str_roots`; K3, K4 and K5
read the padded triangle rows `str_subt12` and the per-block rows
`str_blocks`, and K5 its cull tables `str_roots8` and `str_groups`: five
tables only the port has, each derived from the stream tables once per
scene).

Textures sit in one packed atlas (`atlas_u32`, one int32 word a texel, with
`tex_table` rows [offset, width, height, format]); an environment map adds
its luminance * sin(theta) CDF over all texels (`env_flat_cdf`) and the
matching pdf table (`env_pdf`).  The JAX package's float planes (`atlas`)
feed only its `gather_material`, which the port does not have, so the port
holds no copy of them.

Four small tables of the port's own restate facts of `SceneStatic` on the
device, for the code that runs every lap (`scene_constants`): the scene
bounds (`scene_lo`, `scene_hi`), the triangle root box (`root_box`) and
which geoms are lights (`light_geoms`).  Built with the other tables, they
spare a lap every copy of host data to the device, which a CUDA graph could
not hold (integrator/graphs.py).
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from pathtracer_tpu_torch.accel.bvh import (
    FlatBVH,
    build_bvh,
    collapse_wide,
    partition_stream,
)
from pathtracer_tpu_torch.scene.parser import LIGHT, OBJ, SceneData

TRI_ROW = 32  # packed triangle row width
WIDE_LEAF_K = 8  # triangles per wide-BVH leaf cut
STREAM_SUB_NODES = 512
STREAM_SUB_TRIS = 4096
RESIDENT_SMEM_BUDGET = 900_000
RESIDENT_TRI_VMEM_BUDGET = 8_000_000
# The JAX package sizes its blocks for the TPU kernels' on-chip memory
# (`pathtracer_tpu/scene/flatscene.py:356`, `ops/traverse_pallas.py:535`).
# The port keeps the same numbers so that both packages pick the same block
# split; they mean nothing on the card, where the tables sit in device memory.
STREAM_SMEM_BUDGET = 900_000
STREAM_BUFS = 2
# K5's cull: one union box per this many consecutive blocks (stream_cull_tables)
STREAM_CULL_GROUP = 32


@dataclass
class FlatScene:
    """Scene tables on one device, with the JAX package's field names."""

    geom_type: torch.Tensor        # (G,) int32: 0 sphere, 1 cube, 2 obj
    geom_mat: torch.Tensor         # (G,) int32
    geom_transform: torch.Tensor   # (G, 4, 4) float32
    geom_inv: torch.Tensor         # (G, 4, 4)
    geom_invt: torch.Tensor        # (G, 4, 4)
    tri_data: torch.Tensor         # (T, 32) float32: v0 v1 v2 | n0 n1 n2 | uv0-2 | tan bit | geom pad
    tri_geom: torch.Tensor         # (T,) int32
    bvh_f32: torch.Tensor          # (D*N, 8) threaded MTBVH bounds (ops/traverse.py mtbvh_*)
    bvh_i32: torch.Tensor          # (D*N, 4) threaded MTBVH links: start end hit miss
    bvh_wf: torch.Tensor           # (M*48,) f32: node m child c AABB [bmin bmax]; NaN = empty slot
    bvh_wi: torch.Tensor           # (M*24,) i32: node m [link x8 | start x8 | end x8]
    bvh_wp: torch.Tensor           # (M*8,) i32: per-octant child order, 3 bits per rank
    tri_pk: torch.Tensor           # (T, 12) f32 EDGE form: v0, e1=v1-v0, e2=v2-v0, pad
    str_topf: torch.Tensor         # (T*48,) f32: top node child AABBs, as bvh_wf
    str_topl: torch.Tensor         # (T*8,) i32: >= 0 top node, -1 empty, -(2+s) block s
    str_topp: torch.Tensor         # (T*8,) i32: per-octant child order, as bvh_wp
    str_subf: torch.Tensor         # (n_sub*S*48,) f32: block node child AABBs
    str_subi: torch.Tensor         # (n_sub*S*24,) i32: [local link x8 | start x8 | end x8]
    str_subp: torch.Tensor         # (n_sub*S*8,) i32: per-octant child order
    str_subt: torch.Tensor         # (n_sub*Tmax*9,) f32: v0, e1, e2 of block-local triangles
    str_base: torch.Tensor         # (n_sub,) i32: global id of each block's first triangle
    str_roots: torch.Tensor        # (n_sub*6,) f32: each block's root box (K5; `stream_roots`)
    str_subt12: torch.Tensor       # (n_sub*Tmax*12,) f32: str_subt's rows padded to 48 bytes (K3, K4)
    str_blocks: torch.Tensor       # (n_sub*4,) i32: [base, s*Tmax, wrapped leaf lo, hi] (K3-K5)
    str_roots8: torch.Tensor       # (n_sub*8,) f32: str_roots padded to 32 bytes a block (K5)
    str_groups: torch.Tensor       # (n_groups*8,) f32: union of STREAM_CULL_GROUP roots, padded (K5)
    mat_f32: torch.Tensor          # (8, M): albedo(3) roughness metallic ior pad(2)
    mat_i32: torch.Tensor          # (8, M): type atex mtex rtex ntex pad(3)
    atlas_u32: torch.Tensor        # (P,) int32: packed texels, 8-bit RGB (+ RGBE exponent)
    tex_table: torch.Tensor        # (Ntex, 4) int32: offset width height format(0 rgb8, 1 rgbe)
    light_geom: torch.Tensor       # (L,) int32
    light_tri: torch.Tensor        # (L,) int32 (-1 for analytic geoms)
    light_type: torch.Tensor       # (L,) int32
    env_flat_cdf: torch.Tensor     # (H*W+1,) f32: CDF of luminance * sin(theta) over env texels
    env_pdf: torch.Tensor          # (H, W) f32: the joint pdf over [0,1]^2
    scene_lo: torch.Tensor         # (3,) f32: scene_bounds[0:3], the ray sort key's grid
    scene_hi: torch.Tensor         # (3,) f32: scene_bounds[3:6]
    root_box: torch.Tensor         # (6,) f32: tri_root_box [min, max], the kernels' cull
    light_geoms: torch.Tensor      # (max(G, 1),) bool: the geom's material is a LIGHT

    @property
    def device(self) -> torch.device:
        return self.tri_pk.device


@dataclass(frozen=True)
class SceneStatic:
    """Host-side facts about the scene; the same fields as the JAX twin."""

    geom_types: tuple
    geom_mats: tuple
    geom_mat_types: tuple
    material_types: tuple
    mat_rows_f: tuple
    mat_rows_i: tuple
    scene_bounds: tuple
    analytic_lights: tuple
    stream_top: int
    stream_subs: int
    stream_sub_nodes: int
    stream_sub_tris: int
    wide_depth: int
    wide_nodes: int
    wide_leaf_k: int
    tri_root_box: tuple
    max_prim: int
    num_geoms: int
    num_tris: int
    num_bvh_nodes: int
    num_bvh_trees: int
    num_lights: int
    num_materials: int
    env_map_id: int
    has_textures: bool
    tex_slots: tuple
    tex_rows: tuple
    width: int
    height: int
    trace_depth: int
    iterations: int
    image_name: str
    # the port's own: depths of the streaming walk (stream_depths), which the
    # K3/K4 wrappers hold against their stacks
    stream_top_depth: int = 0
    stream_sub_depth: int = 0
    # the port's own: which kernels the built tables serve, "resident" (K1/K2),
    # "stream" (K3/K4) or None for a mesh that fits neither (the MTBVH walk).
    # The JAX package reads its route from the budgets at call time; the port
    # fixes it here, so the route always follows the tables
    traversal: str | None = "resident"


def scene_constants(static) -> dict:
    """FlatScene's tables made from a SceneStatic (the port's or the JAX
    package's: the same fields): the scene bounds, the triangle root box
    and the light-geom mask."""
    sb = np.asarray(static.scene_bounds, np.float32)
    return dict(scene_lo=sb[0:3], scene_hi=sb[3:6],
                root_box=np.asarray(static.tri_root_box, np.float32),
                light_geoms=np.array([t == LIGHT for t in static.geom_mat_types] or [False]))


# copied from pathtracer_tpu/scene/flatscene.py:156 _pack_triangles
def _pack_triangles(
    scene: SceneData,
    vertex_normal: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """World-space bake + TBN.  `vertex_normal=False` forces face normals."""
    rows = []
    geom_ids = []
    for gi, g in enumerate(scene.geoms):
        if g.type != OBJ or g.mesh_key is None:
            continue
        mesh = scene.meshes[g.mesh_key]
        v = mesh["positions"]
        n = mesh["normals"]
        if not vertex_normal:
            fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = np.where(ln > 0, fn / np.maximum(ln, 1e-38), fn)
            n = np.repeat(fn[:, None, :], 3, axis=1)
        uv = mesh["uvs"]
        T = v.shape[0]
        if T == 0:
            continue
        m = g.transform.astype(np.float64)
        it = g.inv_transpose.astype(np.float64)
        vw = np.einsum("ij,tcj->tci", m[:3, :3], v.astype(np.float64)) + m[:3, 3]
        nw = np.einsum("ij,tcj->tci", it[:3, :3], n.astype(np.float64))
        nlen = np.linalg.norm(nw, axis=-1, keepdims=True)
        nw = np.where(nlen > 0, nw / np.maximum(nlen, 1e-38), nw)

        e1 = vw[:, 1] - vw[:, 0]
        e2 = vw[:, 2] - vw[:, 0]
        duv1 = uv[:, 1] - uv[:, 0]
        duv2 = uv[:, 2] - uv[:, 0]
        f = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        ok = np.abs(f) >= 1e-8
        fsafe = np.where(ok, f, 1.0)
        tan = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) / fsafe[:, None]
        bit = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) / fsafe[:, None]

        def _norm(x):
            ln = np.linalg.norm(x, axis=-1, keepdims=True)
            return np.where(ln > 0, x / np.maximum(ln, 1e-38), x)

        tan = np.where(ok[:, None], _norm(tan), 0.0)
        bit = np.where(ok[:, None], _norm(bit), 0.0)

        row = np.zeros((T, TRI_ROW), np.float32)
        row[:, 0:9] = vw.reshape(T, 9)
        row[:, 9:18] = nw.reshape(T, 9)
        row[:, 18:24] = uv.reshape(T, 6)
        row[:, 24:27] = tan
        row[:, 27:30] = bit
        row[:, 30] = gi  # geom id rides the row (exact in f32 below 2^24)
        rows.append(row)
        geom_ids.append(np.full(T, gi, np.int32))

    if rows:
        return np.concatenate(rows, axis=0), np.concatenate(geom_ids)
    return np.zeros((0, TRI_ROW), np.float32), np.zeros((0,), np.int32)


# copied from pathtracer_tpu/scene/flatscene.py:297 _scene_bounds
def _scene_bounds(scene: SceneData, bvh: FlatBVH) -> tuple:
    """Conservative world bounds of all geometry (unit shapes span +-0.5)."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for g in scene.geoms:
        if g.type == OBJ:
            continue
        c = g.transform[:3, 3]
        ext = np.abs(g.transform[:3, :3]).sum(axis=1) * 0.5
        lo = np.minimum(lo, c - ext)
        hi = np.maximum(hi, c + ext)
    if bvh.num_nodes > 0:
        lo = np.minimum(lo, bvh.bbox_min[0])
        hi = np.maximum(hi, bvh.bbox_max[0])
    if not np.isfinite(lo).all():
        lo = np.zeros(3)
        hi = np.ones(3)
    return tuple(float(x) for x in lo) + tuple(float(x) for x in hi)


# copied from pathtracer_tpu/scene/flatscene.py:317 build_wide_tables
def build_wide_tables(bvh: FlatBVH, leaf_k: int | None = None):
    """8-ary collapse of the SAH tree (accel/bvh.py collapse_wide), flattened:

    - wf (M*48,) f32: node m child c AABB at [m*48 + c*6 : +6] as
      [bmin bmax]; NaN for empty slots
    - wi (M*24,) i32: node m [link x8 | start x8 | end x8]; link >= 0 is an
      internal wide node, else [start, end) is a leaf triangle cut
    - wp (M*8,) i32: per-octant child visit order, 3 bits per rank

    Returns (wf, wi, wp, max_depth, num_nodes, root_box, wide).
    """
    if leaf_k is None:
        leaf_k = WIDE_LEAF_K
    wide = collapse_wide(bvh, leaf_k)
    m = wide.num_nodes
    wf = np.concatenate(
        [wide.child_bmin, wide.child_bmax], axis=2
    ).reshape(-1).astype(np.float32)
    wi = np.concatenate(
        [wide.child_link, wide.child_start, wide.child_end], axis=1
    ).reshape(-1).astype(np.int32)
    wp = wide.perm.reshape(-1).astype(np.int32)
    if bvh.num_nodes > 0:
        root = tuple(float(x) for x in bvh.bbox_min[0]) + tuple(
            float(x) for x in bvh.bbox_max[0]
        )
    else:
        root = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    return wf, wi, wp, wide.max_depth, m, root, wide


# copied from pathtracer_tpu/scene/flatscene.py:359 resident_tables_fit
def resident_tables_fit(num_wide_nodes: int, num_tris: int) -> bool:
    """Does the scene fit the JAX package's resident-kernel budgets?  The
    port keeps the same gate, so both packages take the resident kernels
    for the same scenes.  PT_FORCE_STREAM=1 forces the streaming path."""
    if os.environ.get("PT_FORCE_STREAM"):
        return False
    smem = (48 + 24 + 8 + 9) * num_wide_nodes * 4 + 256
    return (
        smem <= RESIDENT_SMEM_BUDGET
        and num_tris * 48 <= RESIDENT_TRI_VMEM_BUDGET
    )


# copied from pathtracer_tpu/scene/flatscene.py:372 build_stream_tables
def build_stream_tables(bvh: FlatBVH, tri_pk: np.ndarray,
                        num_wide_nodes: int, leaf_k: int,
                        wide=None):
    """Two-level streaming tables (accel/bvh.py partition_stream) for
    meshes past the resident budget; dummy (zero-block) tables when the
    resident kernels suffice.

    Returns (topf, topl, topp, subf, subi, subp, subt, tri_base,
    num_top, num_sub, sub_nodes, sub_tris); num_sub == 0 means 'not
    streaming'."""
    nt = tri_pk.shape[0]
    dummy = (
        np.zeros(48, np.float32), np.full(8, -1, np.int32),
        np.zeros(8, np.int32),
        np.zeros(STREAM_SUB_NODES * 48, np.float32),
        np.zeros(STREAM_SUB_NODES * 24, np.int32),
        np.zeros(STREAM_SUB_NODES * 8, np.int32),
        np.zeros(STREAM_SUB_TRIS * 9, np.float32),
        np.zeros(1, np.int32), 0, 0, 0, 0,
    )
    if nt == 0 or resident_tables_fit(num_wide_nodes, nt):
        return dummy
    if wide is None or wide.num_nodes != num_wide_nodes:
        wide = collapse_wide(bvh, leaf_k)
    # the largest blocks whose (TPU) footprint fits STREAM_SMEM_BUDGET,
    # halving as the JAX package does, so both packages split alike
    s = None
    for div in (1, 2, 4):
        cand = partition_stream(
            wide, STREAM_SUB_NODES // div, STREAM_SUB_TRIS // div
        )
        T, n_sub, S = cand.num_top, cand.num_sub, cand.sub_nodes
        B = STREAM_BUFS
        smem = (
            T * (48 + 8 + 8) + B * S * (48 + 24 + 8) + B * cand.sub_tris * 9
            + T + 3 * n_sub + S + S * 8 + 256
        ) * 4
        if smem <= STREAM_SMEM_BUDGET:
            s = cand
            break
    if s is None:
        return dummy
    T, n_sub = s.num_top, s.num_sub
    topf = np.concatenate([s.top_bmin, s.top_bmax], axis=2).reshape(-1)
    topl = s.top_link.reshape(-1).astype(np.int32)
    topp = s.top_perm.reshape(-1).astype(np.int32)
    subf = np.concatenate([s.sub_bmin, s.sub_bmax], axis=3).reshape(-1)
    subi = np.concatenate(
        [s.sub_link, s.sub_start, s.sub_end], axis=2
    ).reshape(-1).astype(np.int32)
    subp = s.sub_perm.reshape(-1).astype(np.int32)
    # only the 9 floats Möller-Trumbore reads (v0, e1, e2), stride 9
    subt = np.zeros((n_sub, s.sub_tris, 9), np.float32)
    for si in range(n_sub):
        b, c = int(s.tri_base[si]), int(s.tri_count[si])
        subt[si, :c] = tri_pk[b : b + c, 0:9]
    subt = subt.reshape(-1)
    return (
        topf.astype(np.float32), topl, topp,
        subf.astype(np.float32), subi, subp, subt,
        s.tri_base.astype(np.int32), T, n_sub, s.sub_nodes, s.sub_tris,
    )


def stream_roots(topf: np.ndarray, topl: np.ndarray, n_sub: int) -> np.ndarray:
    """(n_sub*6,) f32 root boxes of the blocks: the top child slot whose link
    is -(2+s) holds block s's bounds (as pathtracer_tpu/ops/traverse_pallas.py
    :1136-1145 builds them per call; here once per scene).  A block no slot
    links keeps NaN, which no ray passes."""
    links = np.asarray(topl).reshape(-1).astype(np.int64)
    sid = np.where(links < -1, -(links + 2), n_sub)
    roots = np.full((n_sub + 1, 6), np.nan, np.float32)
    roots[sid] = np.asarray(topf, np.float32).reshape(-1, 6)
    return roots[:n_sub].reshape(-1)


def stream_walk_tables(subi: np.ndarray, subt: np.ndarray, base: np.ndarray,
                       sub_nodes: int, sub_tris: int) -> tuple[np.ndarray, np.ndarray]:
    """The two tables K3's and K4's walks read beside the stream tables, derived
    from them (`ops/traverse_stream_cuda.py closest_hit_stream`, `occlusion_stream`):

    - subt12 (n_sub*Tmax*12,) f32: `subt`'s rows [v0, e1, e2] padded with
      three zeros to 12 floats, so that a row is 48 bytes and 16-byte aligned
      (as `tri_pk`'s are), and row s*Tmax + k is block s's triangle k;
    - blocks (n_sub*4,) i32: block s's row [base[s], s*Tmax, lo, hi].  A block
      that wraps one leaf cut (its root has nothing in slot 1: a real wide
      node has at least two children) has lo, hi = s*Tmax + the cut's
      [start, end), the rows of subt12 to test as soon as the block's box
      passes; any other block has lo = hi = -1 and is entered at its root.
    """
    n_sub = int(np.asarray(base).size)
    subt12 = np.zeros((n_sub * sub_tris, 12), np.float32)
    subt12[:, 0:9] = np.asarray(subt, np.float32).reshape(n_sub * sub_tris, 9)
    roots = np.asarray(subi, np.int32).reshape(n_sub, sub_nodes, 3, 8)[:, 0]
    wrapped = (roots[:, 0, 1] < 0) & (roots[:, 2, 1] <= roots[:, 1, 1])
    row0 = np.arange(n_sub, dtype=np.int64) * sub_tris
    blocks = np.empty((n_sub, 4), np.int32)
    blocks[:, 0] = np.asarray(base, np.int32).reshape(-1)
    blocks[:, 1] = row0
    blocks[:, 2] = np.where(wrapped, row0 + roots[:, 1, 0], -1)
    blocks[:, 3] = np.where(wrapped, row0 + roots[:, 2, 0], -1)
    return subt12.reshape(-1), blocks.reshape(-1)


def stream_cull_tables(roots: np.ndarray, group: int = STREAM_CULL_GROUP
                       ) -> tuple[np.ndarray, np.ndarray]:
    """The two tables K5's kernel culls blocks with, derived from the blocks'
    root boxes `roots` (n_sub*6,) (`stream_roots`):

    - roots8 (n_sub*8,) f32: block s's root box [bmin, bmax, 0, 0], padded
      to 32 bytes, so that it is two loads of 16 bytes;
    - groups (ceil(n_sub/group)*8,) f32: for each run of `group` consecutive
      blocks the exact union of their root boxes, padded the same way.  A
      group whose roots are all NaN (no top slot links them) keeps NaN.

    The cull never rejects a block that its root test would pass.  On an
    axis where the ray's direction is not 0, the slab test's near and far
    distances are monotone in the bounds (rounding is monotone), so a
    group's interval holds each member's.  Where the direction is exactly 0,
    a member passes only if the origin lies strictly between its bounds
    (on a bound, 0 * inf = NaN rejects it, ROADMAP "Decisions that stand";
    outside them, +inf does); then it lies strictly inside the group's too,
    and the group's distances on that axis are -inf and +inf, never NaN.
    """
    boxes = np.asarray(roots, np.float32).reshape(-1, 6)
    n_sub = boxes.shape[0]
    n_groups = -(-n_sub // group)
    roots8 = np.zeros((n_sub, 8), np.float32)
    roots8[:, 0:6] = boxes
    members = np.full((n_groups * group, 6), np.nan, np.float32)
    members[:n_sub] = boxes
    members = members.reshape(n_groups, group, 6)
    groups = np.zeros((n_groups, 8), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN groups stay NaN
        groups[:, 0:3] = np.nanmin(members[:, :, 0:3], axis=1)
        groups[:, 3:6] = np.nanmax(members[:, :, 3:6], axis=1)
    return roots8.reshape(-1), groups.reshape(-1)


def _tree_depth(links: np.ndarray) -> np.ndarray:
    """Depth of the deepest node reachable from node 0 of each tree in
    `links` (B, nodes, 8), following links >= 0; returns (B,)."""
    b_n, n_nodes, _ = links.shape
    depth = np.full((b_n, n_nodes), -1, np.int64)
    depth[:, 0] = 0
    level = 0
    while True:
        ch = np.where((depth == level)[:, :, None], links, -1)
        b, _, _ = np.nonzero(ch >= 0)
        if b.size == 0:
            return depth.max(axis=1)
        depth[b, ch[ch >= 0]] = level + 1
        level += 1


def stream_depths(topl: np.ndarray, subi: np.ndarray, sub_nodes: int) -> tuple[int, int]:
    """(top_depth, sub_depth) of the streaming tables.  The top walk pushes
    top nodes and block entries, one level below the deepest top node, so
    its stack holds at most 7*top_depth+1 entries; a block walk's stack at
    most 7*sub_depth+1 (sub_depth: the deepest block-local node)."""
    top = _tree_depth(topl.reshape(1, -1, 8))
    sub = _tree_depth(subi.reshape(-1, sub_nodes, 3, 8)[:, :, 0, :])
    return int(top.max()) + 1, int(sub.max())


# copied from pathtracer_tpu/scene/flatscene.py:225 _pack_textures
def _pack_textures(scene: SceneData):
    if not scene.textures:
        return (
            np.zeros((3, 1), np.float32),
            np.zeros((1,), np.uint32),
            np.zeros((1, 4), np.int32),
        )
    table = []
    chunks = []
    offset = 0
    for img in scene.textures:
        h, w, _ = img.shape
        table.append((offset, w, h))
        chunks.append(img.reshape(-1, 3))
        offset += w * h
    flat = np.concatenate(chunks, axis=0).astype(np.float32)
    # LDR texels pack as plain 8-bit RGB; HDR texels as RGBE with a shared
    # exponent (lossless against the .hdr file's own encoding)
    fmt = []
    packed = np.zeros(flat.shape[0], np.uint32)
    pos = 0
    for k, img in enumerate(scene.textures):
        n = img.shape[0] * img.shape[1]
        chunk = flat[pos : pos + n]
        if chunk.max() > 1.0:  # HDR → RGBE
            maxc = chunk.max(axis=-1)
            with np.errstate(divide="ignore"):
                e = np.where(maxc > 1e-32, np.floor(np.log2(maxc)) + 1, 0).astype(np.int32)
            scale = np.where(maxc > 1e-32, np.ldexp(1.0, -e) * 256.0, 0.0)
            q = np.clip(chunk * scale[:, None], 0, 255).astype(np.uint32)
            eb = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint32)
            packed[pos : pos + n] = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (eb << 24)
            fmt.append(1)
        else:
            q = np.clip(chunk * 255.0 + 0.5, 0, 255).astype(np.uint32)
            packed[pos : pos + n] = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)
            fmt.append(0)
        pos += n
    table = [(o, w, h, f) for (o, w, h), f in zip(table, fmt)]
    return flat.T.copy(), packed, np.asarray(table, np.int32)


# copied from pathtracer_tpu/scene/flatscene.py:269 _env_cdfs
def _env_cdfs(scene: SceneData) -> tuple[np.ndarray, np.ndarray]:
    """2D luminance·sin(θ) CDFs for env importance sampling: row weighting
    lum(pixel) · sin((0.5+i)/H · π), one flat CDF over all texels."""
    if scene.env_map_id < 0:
        return np.zeros((1,), np.float32), np.zeros((1, 1), np.float32)
    img = scene.textures[scene.env_map_id]
    h, w, _ = img.shape
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    sin_t = np.sin((0.5 + np.arange(h)) / h * np.pi)
    f = (lum * sin_t[:, None]).astype(np.float64)
    flat_cdf = np.zeros(h * w + 1, np.float64)
    np.cumsum(f.reshape(-1), out=flat_cdf[1:])
    total = flat_cdf[-1] if flat_cdf[-1] > 0 else 1.0
    flat_cdf /= total
    # joint pdf over [0,1]²: f / mean(f)
    mean_f = f.mean() if f.mean() > 0 else 1.0
    pdf = (f / mean_f).astype(np.float32)
    return flat_cdf.astype(np.float32), pdf


def flat_from_arrays(arrays: Mapping[str, np.ndarray], device, static=None) -> FlatScene:
    """Tables as numpy arrays (for instance the JAX package's FlatScene
    fields) -> the port's FlatScene on `device`.  `str_roots`, `str_subt12`,
    `str_blocks`, `str_roots8` and `str_groups`, which the JAX package does
    not hold, are built from the stream tables when absent (the block sizes
    follow from the tables: 24 ints a node, 9 floats a triangle), and the
    tables of `scene_constants` from `static` (a SceneStatic of either
    package).  A uint32 `atlas_u32` is carried over as int32, bit for bit."""
    if "root_box" not in arrays:
        if static is None:
            raise ValueError("flat_from_arrays: the tables lack root_box and no static is given")
        arrays = {**arrays, **scene_constants(static)}
    atlas = np.asarray(arrays["atlas_u32"])
    if atlas.dtype == np.uint32:
        arrays = {**arrays, "atlas_u32": atlas.view(np.int32)}
    base = np.asarray(arrays["str_base"])
    if "str_roots" not in arrays:
        arrays = {**arrays, "str_roots": stream_roots(arrays["str_topf"], arrays["str_topl"],
                                                      base.size)}
    if "str_roots8" not in arrays:
        roots8, groups = stream_cull_tables(arrays["str_roots"])
        arrays = {**arrays, "str_roots8": roots8, "str_groups": groups}
    if "str_subt12" not in arrays:
        subi, subt = np.asarray(arrays["str_subi"]), np.asarray(arrays["str_subt"])
        subt12, blocks = stream_walk_tables(subi, subt, base, subi.size // (24 * base.size),
                                            subt.size // (9 * base.size))
        arrays = {**arrays, "str_subt12": subt12, "str_blocks": blocks}
    return FlatScene(**{
        f.name: torch.from_numpy(np.array(arrays[f.name])).to(device)
        for f in fields(FlatScene)
    })


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request without CUDA raises (the
    port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def build_flat_scene(
    scene: SceneData, opts=None, device="cuda", spans=None
) -> tuple[FlatScene, SceneStatic]:
    """Build the scene tables on `device` (the card unless the caller asks
    for the CPU; a CUDA request without CUDA raises before the build).
    `opts` (RenderOptions) wires the build knobs
    use_sah/use_mtbvh/max_prim/bucket_num/vertex_normal.  `spans`, a
    utils/profiling.py Tracer, gets the host's build (`bvh.build`: the BVH
    and every table) and the upload (`tables.upload`)."""
    t_build = time.perf_counter_ns()
    device = resolve_device(device)
    use_sah = opts.use_sah if opts is not None else True
    use_mtbvh = opts.use_mtbvh if opts is not None else True
    max_prim = opts.max_prim if opts is not None else 1
    bucket_num = opts.bucket_num if opts is not None else 20
    vertex_normal = opts.vertex_normal if opts is not None else True

    # copied from pathtracer_tpu/scene/flatscene.py:459-610 build_flat_scene
    G = max(len(scene.geoms), 1)
    geom_type = np.full(G, -1, np.int32)
    geom_mat = np.zeros(G, np.int32)
    xf = np.tile(np.eye(4, dtype=np.float32), (G, 1, 1))
    inv = xf.copy()
    invt = xf.copy()
    for i, g in enumerate(scene.geoms):
        geom_type[i] = g.type
        geom_mat[i] = g.material_id
        xf[i] = g.transform
        inv[i] = g.inverse_transform
        invt[i] = g.inv_transpose

    tri_data, tri_geom = _pack_triangles(scene, vertex_normal=vertex_normal)
    if tri_data.shape[0] * 48 > RESIDENT_TRI_VMEM_BUDGET:
        use_mtbvh = False
    bvh: FlatBVH = build_bvh(
        tri_data[:, 0:9].reshape(-1, 3, 3) if tri_data.shape[0] else tri_data.reshape(0, 3, 3),
        use_sah=use_sah,
        mtbvh=use_mtbvh,
        max_prim=max_prim,
        bucket_num=bucket_num,
    )
    if tri_data.shape[0]:
        tri_data = tri_data[bvh.order]
        tri_geom = tri_geom[bvh.order]

    M = max(len(scene.materials), 1)
    mat_f32 = np.zeros((M, 8), np.float32)
    mat_i32 = np.full((M, 8), -1, np.int32)
    for i, m in enumerate(scene.materials):
        mat_f32[i, 0:3] = m.albedo
        mat_f32[i, 3] = m.roughness
        mat_f32[i, 4] = m.metallic
        mat_f32[i, 5] = m.ior
        mat_i32[i, 0] = m.type
        mat_i32[i, 1] = m.albedo_tex
        mat_i32[i, 2] = m.metallic_tex
        mat_i32[i, 3] = m.roughness_tex
        mat_i32[i, 4] = m.normal_tex

    # lights: analytic geoms first, then emissive triangles in post-BVH order
    lg, lt, lty = [], [], []
    for i, g in enumerate(scene.geoms):
        if (
            0 <= g.material_id < len(scene.materials)
            and scene.materials[g.material_id].type == LIGHT
            and g.type != OBJ
        ):
            lg.append(i)
            lt.append(-1)
            lty.append(g.type)
    for ti in range(tri_data.shape[0]):
        gi = int(tri_geom[ti])
        mid = int(geom_mat[gi])
        if 0 <= mid < len(scene.materials) and scene.materials[mid].type == LIGHT:
            lg.append(gi)
            lt.append(ti)
            lty.append(OBJ)
    L = max(len(lg), 1)
    light_geom = np.zeros(L, np.int32)
    light_tri = np.full(L, -1, np.int32)
    light_type = np.full(L, -1, np.int32)
    light_geom[: len(lg)] = lg
    light_tri[: len(lg)] = lt
    light_type[: len(lg)] = lty

    if tri_data.shape[0] == 0:
        tri_data = np.zeros((1, TRI_ROW), np.float32)
        tri_geom = np.zeros((1,), np.int32)
    bvh_f32 = np.zeros((max(bvh.bbox_min.shape[0], 1), 8), np.float32)
    bvh_i32 = np.zeros((max(bvh.bbox_min.shape[0], 1), 4), np.int32)
    if bvh.bbox_min.shape[0]:
        bvh_f32[:, 0:3] = bvh.bbox_min
        bvh_f32[:, 3:6] = bvh.bbox_max
        bvh_i32[:, 0] = bvh.start
        bvh_i32[:, 1] = bvh.end
        bvh_i32[:, 2] = bvh.hit
        bvh_i32[:, 3] = bvh.miss
    wide_k = max(WIDE_LEAF_K, max_prim)
    bvh_wf, bvh_wi, bvh_wp, wide_depth, wide_nodes, tri_root_box, wide = (
        build_wide_tables(bvh, leaf_k=wide_k)
    )
    num_tris = int(bvh.order.shape[0])
    # EDGE-FORM rows [v0, e1=v1-v0, e2=v2-v0, pad] for the traversal kernels
    tri_pk = np.zeros((tri_data.shape[0], 12), np.float32)
    tri_pk[:, 0:3] = tri_data[:, 0:3]
    tri_pk[:, 3:6] = (
        tri_data[:, 3:6].astype(np.float32) - tri_data[:, 0:3].astype(np.float32)
    )
    tri_pk[:, 6:9] = (
        tri_data[:, 6:9].astype(np.float32) - tri_data[:, 0:3].astype(np.float32)
    )
    # streaming split for meshes past the resident budget (K3/K4)
    (str_topf, str_topl, str_topp, str_subf, str_subi, str_subp, str_subt,
     str_base, stream_top, stream_subs, stream_sub_nodes, stream_sub_tris
     ) = build_stream_tables(bvh, tri_pk, wide_nodes, leaf_k=wide_k, wide=wide)
    top_depth = sub_depth = 0
    traversal = "resident"
    if num_tris and not resident_tables_fit(wide_nodes, num_tris):
        if stream_subs:
            traversal = "stream"
            top_depth, sub_depth = stream_depths(str_topl, str_subi, stream_sub_nodes)
        else:
            # neither table fits: the triangles take the MTBVH walk, as the
            # JAX package's take its XLA walk (`packet_mode` None there too)
            traversal = None

    _, atlas_u32, tex_table = _pack_textures(scene)
    env_flat_cdf, env_pdf = _env_cdfs(scene)
    arrays = dict(
        geom_type=geom_type, geom_mat=geom_mat, geom_transform=xf,
        geom_inv=inv, geom_invt=invt, tri_data=tri_data, tri_geom=tri_geom,
        bvh_f32=bvh_f32, bvh_i32=bvh_i32, bvh_wf=bvh_wf, bvh_wi=bvh_wi,
        bvh_wp=bvh_wp, tri_pk=tri_pk,
        str_topf=str_topf, str_topl=str_topl, str_topp=str_topp,
        str_subf=str_subf, str_subi=str_subi, str_subp=str_subp,
        str_subt=str_subt, str_base=str_base,
        str_roots=stream_roots(str_topf, str_topl, str_base.size),
        mat_f32=mat_f32.T.copy(), mat_i32=mat_i32.T.copy(),
        light_geom=light_geom, light_tri=light_tri, light_type=light_type,
        atlas_u32=atlas_u32, tex_table=tex_table, env_flat_cdf=env_flat_cdf, env_pdf=env_pdf,
    )
    static = SceneStatic(
        geom_types=tuple(int(g.type) for g in scene.geoms),
        geom_mats=tuple(int(g.material_id) for g in scene.geoms),
        geom_mat_types=tuple(
            int(scene.materials[g.material_id].type)
            if 0 <= g.material_id < len(scene.materials) else -1
            for g in scene.geoms
        ),
        material_types=tuple(sorted({int(m.type) for m in scene.materials})),
        mat_rows_f=tuple(
            tuple(float(v) for v in mat_f32[i, 0:6])
            for i in range(len(scene.materials))
        ),
        mat_rows_i=tuple(
            tuple(int(v) for v in mat_i32[i, 0:5])
            for i in range(len(scene.materials))
        ),
        scene_bounds=_scene_bounds(scene, bvh),
        analytic_lights=tuple(
            (li, int(lg[li]), int(lty[li]))
            for li in range(len(lg))
            if lt[li] < 0
        ),
        stream_top=stream_top,
        stream_subs=stream_subs,
        stream_sub_nodes=stream_sub_nodes,
        stream_sub_tris=stream_sub_tris,
        wide_depth=wide_depth,
        wide_nodes=wide_nodes,
        wide_leaf_k=wide_k,
        tri_root_box=tri_root_box,
        max_prim=max_prim,
        num_geoms=len(scene.geoms),
        num_tris=num_tris,
        num_bvh_nodes=bvh.num_nodes,
        num_bvh_trees=bvh.num_trees,
        num_lights=len(lg),
        num_materials=len(scene.materials),
        env_map_id=scene.env_map_id,
        has_textures=len(scene.textures) > 0,
        tex_slots=(
            any(m.albedo_tex >= 0 for m in scene.materials),
            any(m.metallic_tex >= 0 for m in scene.materials),
            any(m.roughness_tex >= 0 for m in scene.materials),
            any(m.normal_tex >= 0 for m in scene.materials),
        ),
        tex_rows=tuple(tuple(int(v) for v in row) for row in tex_table),
        width=scene.camera.resolution[0],
        height=scene.camera.resolution[1],
        trace_depth=scene.trace_depth,
        iterations=scene.iterations,
        image_name=scene.image_name,
        stream_top_depth=top_depth,
        stream_sub_depth=sub_depth,
        traversal=traversal,
    )
    t_upload = time.perf_counter_ns()
    flat = flat_from_arrays(arrays, device, static)
    if spans is not None:
        spans.add("bvh.build", t_build, t_upload)
        spans.add("tables.upload", t_upload, time.perf_counter_ns())
    return flat, static
