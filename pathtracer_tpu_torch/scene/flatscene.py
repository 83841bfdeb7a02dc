"""FlatScene: the device-resident scene tables as tensors.

Port of `pathtracer_tpu/scene/flatscene.py`.  The tables are built with the
same numpy code as the JAX package (the numpy-only pieces are copied here,
each marked with its origin, because that module imports JAX), so the two
packages hold equal tables for the same scene: identical BVH tables are what
make triangle-id parity exact.  The fields carry the JAX names.

Not yet ported (each raises `NotImplementedError`): texture atlases and
normal maps (ROADMAP Queue 1 item 11), environment maps (item 12) and the
two-level streaming tables for meshes past `resident_tables_fit` (item 13).
Their fields hold the JAX package's one-row placeholder tables.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from pathtracer_tpu.accel.bvh import FlatBVH, build_bvh, collapse_wide
from pathtracer_tpu.scene.parser import LIGHT, OBJ, SceneData

TRI_ROW = 32  # packed triangle row width
WIDE_LEAF_K = 8  # triangles per wide-BVH leaf cut
STREAM_SUB_NODES = 512
STREAM_SUB_TRIS = 4096
RESIDENT_SMEM_BUDGET = 900_000
RESIDENT_TRI_VMEM_BUDGET = 8_000_000


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
    bvh_f32: torch.Tensor          # (D*N, 8) threaded MTBVH bounds (unused by the port's walk)
    bvh_i32: torch.Tensor          # (D*N, 4) threaded MTBVH links (unused by the port's walk)
    bvh_wf: torch.Tensor           # (M*48,) f32: node m child c AABB [bmin bmax]; NaN = empty slot
    bvh_wi: torch.Tensor           # (M*24,) i32: node m [link x8 | start x8 | end x8]
    bvh_wp: torch.Tensor           # (M*8,) i32: per-octant child order, 3 bits per rank
    tri_pk: torch.Tensor           # (T, 12) f32 EDGE form: v0, e1=v1-v0, e2=v2-v0, pad
    str_topf: torch.Tensor         # streaming tables: placeholders (not ported)
    str_topl: torch.Tensor
    str_topp: torch.Tensor
    str_subf: torch.Tensor
    str_subi: torch.Tensor
    str_subp: torch.Tensor
    str_subt: torch.Tensor
    str_base: torch.Tensor
    mat_f32: torch.Tensor          # (8, M): albedo(3) roughness metallic ior pad(2)
    mat_i32: torch.Tensor          # (8, M): type atex mtex rtex ntex pad(3)
    atlas: torch.Tensor            # texture tables: placeholders (not ported)
    atlas_u32: torch.Tensor
    tex_table: torch.Tensor
    light_geom: torch.Tensor       # (L,) int32
    light_tri: torch.Tensor        # (L,) int32 (-1 for analytic geoms)
    light_type: torch.Tensor       # (L,) int32
    env_flat_cdf: torch.Tensor     # environment CDF: placeholder (not ported)
    env_pdf: torch.Tensor

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
# (without its PT_FORCE_STREAM override: the port has no streaming path)
def resident_tables_fit(num_wide_nodes: int, num_tris: int) -> bool:
    """Does the scene fit the JAX package's resident-kernel budgets?  The
    port keeps the same gate, so both packages take the resident kernels
    for the same scenes."""
    smem = (48 + 24 + 8 + 9) * num_wide_nodes * 4 + 256
    return (
        smem <= RESIDENT_SMEM_BUDGET
        and num_tris * 48 <= RESIDENT_TRI_VMEM_BUDGET
    )


def _placeholder_tables() -> dict[str, np.ndarray]:
    """The JAX package's one-row tables for the slices the port lacks:
    streaming split (flatscene.py:383-391), textures (:225-231) and the
    environment CDF (:269-276)."""
    return {
        "str_topf": np.zeros(48, np.float32),
        "str_topl": np.full(8, -1, np.int32),
        "str_topp": np.zeros(8, np.int32),
        "str_subf": np.zeros(STREAM_SUB_NODES * 48, np.float32),
        "str_subi": np.zeros(STREAM_SUB_NODES * 24, np.int32),
        "str_subp": np.zeros(STREAM_SUB_NODES * 8, np.int32),
        "str_subt": np.zeros(STREAM_SUB_TRIS * 9, np.float32),
        "str_base": np.zeros(1, np.int32),
        "atlas": np.zeros((3, 1), np.float32),
        "atlas_u32": np.zeros((1,), np.uint32),
        "tex_table": np.zeros((1, 4), np.int32),
        "env_flat_cdf": np.zeros((1,), np.float32),
        "env_pdf": np.zeros((1, 1), np.float32),
    }


def flat_from_arrays(arrays: Mapping[str, np.ndarray], device) -> FlatScene:
    """Tables as numpy arrays (for instance the JAX package's FlatScene
    fields) -> the port's FlatScene on `device`."""
    return FlatScene(**{
        f.name: torch.from_numpy(np.array(arrays[f.name])).to(device)
        for f in fields(FlatScene)
    })


def build_flat_scene(
    scene: SceneData, opts=None, device="cpu"
) -> tuple[FlatScene, SceneStatic]:
    """Build the scene tables on `device`.  `opts` (RenderOptions) wires the
    build knobs use_sah/use_mtbvh/max_prim/bucket_num/vertex_normal."""
    if scene.env_map_id >= 0:
        raise NotImplementedError(
            "environment maps (ENV) come with ROADMAP Queue 1 item 12"
        )
    if scene.textures:
        raise NotImplementedError(
            "textured scenes (materials with texture maps, normal maps) come "
            "with ROADMAP Queue 1 item 11"
        )
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
    bvh_wf, bvh_wi, bvh_wp, wide_depth, wide_nodes, tri_root_box, _ = (
        build_wide_tables(bvh, leaf_k=wide_k)
    )
    num_tris = int(bvh.order.shape[0])
    if num_tris and not resident_tables_fit(wide_nodes, num_tris):
        raise NotImplementedError(
            f"a mesh of {num_tris} triangles is past the resident budget; the "
            "streaming kernels K3/K4 come with ROADMAP Queue 1 item 13"
        )
    # EDGE-FORM rows [v0, e1=v1-v0, e2=v2-v0, pad] for the traversal kernels
    tri_pk = np.zeros((tri_data.shape[0], 12), np.float32)
    tri_pk[:, 0:3] = tri_data[:, 0:3]
    tri_pk[:, 3:6] = (
        tri_data[:, 3:6].astype(np.float32) - tri_data[:, 0:3].astype(np.float32)
    )
    tri_pk[:, 6:9] = (
        tri_data[:, 6:9].astype(np.float32) - tri_data[:, 0:3].astype(np.float32)
    )

    placeholders = _placeholder_tables()
    arrays = dict(
        geom_type=geom_type, geom_mat=geom_mat, geom_transform=xf,
        geom_inv=inv, geom_invt=invt, tri_data=tri_data, tri_geom=tri_geom,
        bvh_f32=bvh_f32, bvh_i32=bvh_i32, bvh_wf=bvh_wf, bvh_wi=bvh_wi,
        bvh_wp=bvh_wp, tri_pk=tri_pk,
        mat_f32=mat_f32.T.copy(), mat_i32=mat_i32.T.copy(),
        light_geom=light_geom, light_tri=light_tri, light_type=light_type,
        **placeholders,
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
        stream_top=0,
        stream_subs=0,
        stream_sub_nodes=0,
        stream_sub_tris=0,
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
        has_textures=False,
        tex_slots=(False, False, False, False),
        tex_rows=tuple(
            tuple(int(v) for v in row) for row in placeholders["tex_table"]
        ),
        width=scene.camera.resolution[0],
        height=scene.camera.resolution[1],
        trace_depth=scene.trace_depth,
        iterations=scene.iterations,
        image_name=scene.image_name,
    )
    return flat_from_arrays(arrays, device), static
