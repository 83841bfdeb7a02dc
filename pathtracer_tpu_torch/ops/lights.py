"""Next-event estimation: light sampling and light pdf.

Port of `pathtracer_tpu/ops/lights.py`, quirks included:

- uniform light pick: id = min(u * L, L-1);
- triangle lights: uniform-area sample, solid-angle pdf
  (1/L) * d^2 / (area * |cos|), two-sided;
- sphere lights: cone sampling in OBJECT space assuming radius 0.5, so a
  non-uniform scale gives the reference's (wrong) pdf;
- CUBE area lights have no sampling branch: their pdf stays 0 and NEE adds
  nothing for them, and light_pdf returns -1 for them;
- the shadow ray starts at viewPos + 1e-5 * dir and goes through
  ops/traverse.occlusion_test (the K2 kernel for triangles);
- occluded => pdf = -1 and emit = 0;
- with `include_env` the environment is one more light, the last of
  L + 1: importance-sampled (`ops/envmap.py`), its light position 1e7 out
  along the sampled direction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pathtracer_tpu_torch.scene.parser import SPHERE
from pathtracer_tpu_torch.utils.config import TWO_PI
from pathtracer_tpu_torch.ops import math as m
from pathtracer_tpu_torch.ops.envmap import sample_env
from pathtracer_tpu_torch.ops.intersect import xform_point
from pathtracer_tpu_torch.ops.traverse import occlusion_test
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic


class LightSampleRecord(NamedTuple):
    pos: torch.Tensor   # (N, 3)
    emit: torch.Tensor  # (N, 3)
    pdf: torch.Tensor   # (N,)  (-1 = occluded / invalid)


def _inv_count(n: int) -> float:
    """1/n rounded to float32, as the JAX package's 1.0 / jnp.float32(n)."""
    return float(np.float32(1.0) / np.float32(n))


def _tri_light_geometry(flat: FlatScene, tri_id):
    trow = flat.tri_data[tri_id.clamp(0, flat.tri_data.shape[0] - 1).long()]
    return trow[:, 0:3], trow[:, 3:6], trow[:, 6:9], trow[:, 9:12], trow[:, 12:15], trow[:, 15:18]


def _sphere_cone_sample(tr, inv, view_pos, xi):
    """Cone sampling toward one sphere light."""
    view_l = xform_point(inv, view_pos)
    center_to_ref = m.normalize(-view_l)
    tan, bit = m.onb_pixar(center_to_ref)

    d2 = m.dot(view_l, view_l)
    sin_tm2 = 0.25 / torch.clamp(d2, min=1e-12)
    cos_tm = torch.sqrt(torch.clamp(1.0 - sin_tm2, min=0.0))
    cos_t = (1.0 - xi[:, 0]) + xi[:, 0] * cos_tm
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = xi[:, 1] * TWO_PI

    dc = torch.sqrt(torch.clamp(d2, min=0.0))
    ds = dc * cos_t - torch.sqrt(torch.clamp(0.25 - dc * dc * sin_t * sin_t, min=0.0))
    sin_a = ds * sin_t / 0.5
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))

    n_obj = (
        (sin_a * torch.cos(phi))[..., None] * tan
        + (sin_a * torch.sin(phi))[..., None] * bit
        + cos_a[..., None] * (-center_to_ref)
    )
    p_obj = n_obj * 0.5
    light_pos = xform_point(tr, p_obj)
    pdf = 1.0 / (TWO_PI * (1.0 - cos_tm))
    return light_pos, pdf


def _sphere_cone_pdf(inv, view_pos):
    view_l = xform_point(inv, view_pos)
    sin_tm2 = 0.25 / torch.clamp(m.dot(view_l, view_l), min=1e-12)
    cos_tm = torch.sqrt(torch.clamp(1.0 - sin_tm2, min=0.0))
    return 1.0 / (TWO_PI * (1.0 - cos_tm))


def _emit_by_geom(flat: FlatScene, static: SceneStatic, geom_idx):
    """Light albedo of each ray's geom; zero for geoms without a LIGHT
    material (as the JAX chain, which selects over light geoms only)."""
    is_light = flat.light_geoms
    albedo = flat.mat_f32[0:3].T[flat.geom_mat.long()]
    table = torch.where(is_light[:, None], albedo, 0.0)
    return table[geom_idx.long()]


def light_sample(
    flat: FlatScene, static: SceneStatic, view_pos, rands, enabled=None,
    include_env: bool = False, shadow_sort: bool = False, **walk,
) -> LightSampleRecord:
    """Sample one light per ray, with occlusion.  `rands` is (N, 3): col 0
    the light pick, cols 1-2 the area/cone sample; (N, 4) with
    `include_env`, col 3 the env texel jitter's second axis.  `enabled`
    masks lanes whose NEE term is zero downstream: their shadow rays are not
    traced.  `shadow_sort` sorts the shadow rays for the kernel, and `walk`
    (`use_kernels`, `use_bvh`) picks the triangle walk
    (ops/traverse.occlusion_test)."""
    N = view_pos.shape[0]
    dev = view_pos.device
    L = static.num_lights
    L_eff = L + (1 if include_env else 0)
    if L_eff == 0:
        return LightSampleRecord(
            pos=torch.zeros((N, 3), device=dev),
            emit=torch.zeros((N, 3), device=dev),
            pdf=torch.full((N,), -1.0, device=dev),
        )
    fl = float(L_eff)
    light_id = torch.clamp(rands[:, 0] * fl, max=fl - 1.0).to(torch.int32)
    is_env = light_id >= L
    lid = light_id.clamp(0, flat.light_geom.shape[0] - 1).long()
    geom_id = flat.light_geom[lid]
    tri_id = torch.where(is_env, -1, flat.light_tri[lid])
    emit = _emit_by_geom(flat, static, geom_id)

    xi = rands[:, 1:3]
    inv_l = _inv_count(L_eff)

    light_pos = torch.zeros((N, 3), device=dev)
    pdf = torch.zeros((N,), device=dev)

    is_tri = tri_id >= 0
    if L > len(static.analytic_lights):  # triangle lights exist
        bary = m.sample_triangle_uniform(xi)
        u, v = bary[:, 0], bary[:, 1]
        v0, v1, v2, n0, n1, n2 = _tri_light_geometry(flat, tri_id)
        w = (1.0 - u - v)[..., None]
        tri_pos = u[..., None] * v0 + v[..., None] * v1 + w * v2
        tri_nrm = m.normalize(u[..., None] * n0 + v[..., None] * n1 + w * n2)
        area = m.length(m.cross(v1 - v0, v2 - v0)) / 2.0
        d2 = m.length2(tri_pos - view_pos)
        cos_l = torch.abs(m.dot(m.normalize(view_pos - tri_pos), tri_nrm))
        tri_pdf = inv_l * d2 / torch.clamp(area * cos_l, min=1e-38)
        light_pos = torch.where(is_tri[..., None], tri_pos, light_pos)
        pdf = torch.where(is_tri, tri_pdf, pdf)

    # analytic lights, one branch per static light; cubes have none
    for li, gi, gtype in static.analytic_lights:
        if gtype != SPHERE:
            continue
        p_i, pdf_i = _sphere_cone_sample(flat.geom_transform[gi], flat.geom_inv[gi], view_pos, xi)
        sel = light_id == li
        light_pos = torch.where(sel[..., None], p_i, light_pos)
        pdf = torch.where(sel, pdf_i * inv_l, pdf)

    if include_env:
        env_dir, env_le, env_pdf_w = sample_env(flat, static, xi[:, 0], xi[:, 1], rands[:, 3])
        em = is_env[..., None]
        light_pos = torch.where(em, view_pos + env_dir * 1e7, light_pos)
        pdf = torch.where(is_env, env_pdf_w * inv_l, pdf)
        emit = torch.where(em, env_le, emit)

    ray_dir = m.normalize(light_pos - view_pos)
    occ_on = pdf > 0.0 if enabled is None else (pdf > 0.0) & enabled
    occ = occlusion_test(
        flat, static, view_pos + 1e-5 * ray_dir, ray_dir, light_pos, enabled=occ_on,
        shadow_sort=shadow_sort, **walk,
    )
    pdf = torch.where(occ, -1.0, pdf)
    emit = torch.where(occ[..., None], 0.0, emit)
    return LightSampleRecord(pos=light_pos, emit=emit, pdf=pdf)


def light_pdf(flat: FlatScene, static: SceneStatic, view_pos, light_pos, normal, tri_id, geom_id,
              include_env: bool = False):
    """Light pdf of a BSDF-sampled hit (the MIS weight's other term); -1 for
    geometries with no sampling branch (cube lights).  `include_env` counts
    the environment as one more light."""
    N = view_pos.shape[0]
    L = static.num_lights + (1 if include_env else 0)
    pdf = torch.full((N,), -1.0, device=view_pos.device)
    if L == 0:
        return pdf
    inv_l = _inv_count(L)

    is_tri = tri_id >= 0
    v0, v1, v2, *_ = _tri_light_geometry(flat, tri_id)
    area = m.length(m.cross(v1 - v0, v2 - v0)) / 2.0
    d2 = m.length2(light_pos - view_pos)
    cos_l = torch.abs(m.dot(m.normalize(view_pos - light_pos), normal))
    tri_pdf = inv_l * d2 / torch.clamp(area * cos_l, min=1e-38)
    pdf = torch.where(is_tri, tri_pdf, pdf)

    # sphere branch: any sphere geom (not only lights), as the reference
    for gi, gtype in enumerate(static.geom_types):
        if gtype != SPHERE:
            continue
        sph_pdf = _sphere_cone_pdf(flat.geom_inv[gi], view_pos) * inv_l
        pdf = torch.where(geom_id == gi, sph_pdf, pdf)
    return pdf
