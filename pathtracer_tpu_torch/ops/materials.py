"""BSDF library: eval / sample / pdf for all five material types.

Port of `pathtracer_tpu/ops/materials.py`, quirks included:

- `wo` is the RAY direction (pointing INTO the surface); the GGX lobes
  negate it internally.
- Dielectric is a delta lobe: exact Fresnel picks reflect or refract,
  refraction carries the (ior2^2/ior1^2) radiance scale, and the bsdf is
  divided by |cos| so the integrator's cosine cancels.
- Microfacet passes `roughness` (not alpha^2) to Smith G and as the VNDF
  alpha; MetallicWorkflow passes roughness^2 to the VNDF.
- Light materials return (albedo constant, pdf 1) from scatter_sample.
- roughness is clamped to [1e-3, 1] and metallic to [0, 1].

Every lobe is evaluated over the whole wavefront and combined with masked
selects.  A material may take its albedo, metallic, roughness and normal from
textures (`ops/texture.py`), sampled at the hit's uv.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.scene.parser import (
    DIELECTRIC,
    LAMBERTIAN,
    METALLIC_WORKFLOW,
    MICROFACET,
)
from pathtracer_tpu_torch.utils.config import INV_PI
from pathtracer_tpu_torch.ops import math as m
from pathtracer_tpu_torch.ops.texture import (
    bilinear_sample_u32_1ch_meta,
    bilinear_sample_u32_meta,
)
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic

ROUGHNESS_MIN = 1e-3
ROUGHNESS_MAX = 1.0


class MatParams(NamedTuple):
    """Per-ray material parameters."""

    type: torch.Tensor         # (N,) int32
    albedo: torch.Tensor       # (N, 3)
    roughness: torch.Tensor    # (N,) clamped
    metallic: torch.Tensor     # (N,) clamped
    ior: torch.Tensor          # (N,)
    emit: torch.Tensor         # (N, 3) constant albedo (Light emission)
    normal_map: torch.Tensor   # (N, 3) normal-map texel ((0.5, 0.5, 1) if none)


class ScatterRecord(NamedTuple):
    bsdf: torch.Tensor   # (N, 3)
    pdf: torch.Tensor    # (N,)
    delta: torch.Tensor  # (N,) bool
    dir: torch.Tensor    # (N, 3)


def material_by_geom(flat: FlatScene, static: SceneStatic, geom_idx, uv) -> MatParams:
    """Material parameters of each ray's geom, textures sampled at `uv`.
    Rays that hit nothing (geom -1) read an all-zero row and no texture, as
    the JAX select chain's default.  A texture slot is sampled only when a
    material some geom uses carries that map (the JAX package's pruning); a
    lane's texture metadata is gathered from `tex_table`, where the JAX
    package chains static immediates, with the same integers."""
    mid = flat.geom_mat.long()
    rows_f = torch.cat([flat.mat_f32[0:6].T[mid], flat.mat_f32.new_zeros((1, 6))])
    rows_i = torch.cat([flat.mat_i32[0:5].T[mid], mid.new_full((1, 5), -1).to(torch.int32)])
    g = torch.where(geom_idx >= 0, geom_idx.long(), rows_f.shape[0] - 1)
    f, i = rows_f[g], rows_i[g]
    const_albedo = f[:, 0:3]
    rough, metal = f[:, 3], f[:, 4]
    mtype = torch.where(geom_idx >= 0, i[:, 0], 0)
    # (0.5, 0.5, 1), the texel of no normal map, made on the device
    flat_normal = torch.where(torch.arange(3, device=uv.device) == 2, 1.0, 0.5)
    nmap_const = flat_normal.expand(const_albedo.shape)

    used = {int(m_) for m_ in static.geom_mats}

    def sample(slot: int, channels: int, fallback):
        """Texture slot `slot` (1 albedo, 2 metallic, 3 roughness, 4 normal)
        where the lane's material has one, else `fallback`."""
        tids = {static.mat_rows_i[m_][slot] for m_ in used} - {-1}
        if not tids:
            return fallback
        tid = i[:, slot]
        has = tid >= 0
        meta = flat.tex_table[tid.clamp(min=0).long()]
        off, w, h = meta[:, 0], meta[:, 1], meta[:, 2]
        if channels == 1:
            return torch.where(has, bilinear_sample_u32_1ch_meta(flat.atlas_u32, off, w, h, uv),
                               fallback)
        fmts = {static.tex_rows[t][3] for t in tids}
        rgbe = fmts == {1} if len(fmts) == 1 else meta[:, 3] == 1
        tex = bilinear_sample_u32_meta(flat.atlas_u32, off, w, h, rgbe, uv)
        return torch.where(has[..., None], tex, fallback)

    return MatParams(
        type=mtype.to(torch.int32),
        albedo=sample(1, 3, const_albedo),
        roughness=torch.clamp(sample(3, 1, rough), ROUGHNESS_MIN, ROUGHNESS_MAX),
        metallic=torch.clamp(sample(2, 1, metal), 0.0, 1.0),
        ior=f[:, 5],
        emit=const_albedo,
        normal_map=sample(4, 3, nmap_const),
    )


# ---------------------------------------------------------------------------
# individual lobes (all take wo = ray direction INTO the surface)


def _lambertian_sample(p: MatParams, n, wo, r):
    bsdf = p.albedo * INV_PI
    d = m.sample_hemisphere_cosine(n, r[:, 0:2])
    pdf = m.dot(d, n) * INV_PI
    return bsdf, pdf, d


def _dielectric_sample(p: MatParams, n, wo, r):
    entering = m.dot(wo, n) < 0.0
    one = torch.ones_like(p.ior)
    ior1 = torch.where(entering, one, p.ior)
    ior2 = torch.where(entering, p.ior, one)
    fres = m.fresnel_maxwell(torch.abs(m.dot(wo, n)), ior1, ior2)
    reflectp = r[:, 2] < fres

    refl = m.reflect_dir(n, wo)
    refr = m.refract_dir(n, wo, ior1, ior2)
    d = torch.where(reflectp[..., None], refl, refr)
    scale = torch.where(reflectp, 1.0, (ior2 * ior2) / (ior1 * ior1))
    bsdf = p.albedo * scale[..., None]
    bsdf = bsdf / torch.clamp(torch.abs(m.dot(d, n)), min=1e-38)[..., None]
    pdf = torch.ones_like(fres)
    return bsdf, pdf, d


def microfacet_bsdf(n, wo_out, wi, albedo, rough):
    """wo_out points AWAY from the surface."""
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    cos_i = m.dot(n, wi)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g2 = m.smith_g2(rough, cos_o, cos_i)  # quirk: roughness, not alpha^2
    f = m.fresnel_schlick(albedo, m.dot(wo_out, wm))
    val = f * (d * g2 / torch.clamp(4.0 * cos_o * cos_i, min=1e-8))[..., None]
    return torch.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def microfacet_pdf(n, wo_out, wi, rough):
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g1 = m.smith_g1(rough, cos_o)  # quirk: roughness, not alpha^2
    return g1 * d / torch.clamp(4.0 * m.dot(wo_out, n), min=1e-8)


def _microfacet_sample(p: MatParams, n, wo, r):
    wo_out = -wo
    wm = m.sample_normal_ggx(n, wo_out, p.roughness, r[:, 0:2])
    d = m.reflect(wo, wm)
    bad = m.dot(d, n) * m.dot(wo_out, n) < 0.0
    bsdf = microfacet_bsdf(n, wo_out, d, p.albedo, p.roughness)
    pdf = microfacet_pdf(n, wo_out, d, p.roughness)
    bsdf = torch.where(bad[..., None], 0.0, bsdf)
    pdf = torch.where(bad, 0.0, pdf)
    return bsdf, pdf, d


def metallic_bsdf(n, wo_out, wi, albedo, rough, metal):
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    cos_i = m.dot(n, wi)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g2 = m.smith_g2(rough, cos_o, cos_i)  # quirk: roughness as a2
    f0 = m.mix(torch.full_like(albedo, 0.08), albedo, metal[..., None])
    f = m.fresnel_schlick(f0, m.dot(wo_out, wm))
    diff = (1.0 - metal)[..., None] * albedo * INV_PI
    spec = (d * g2 / torch.clamp(4.0 * cos_o * cos_i, min=1e-8))[..., None]
    val = m.mix(diff, spec.expand(diff.shape), f)
    return torch.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def metallic_pdf(n, wo_out, wi, rough, metal):
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g1 = m.smith_g1(rough, cos_o)  # quirk
    spec_pdf = g1 * d / torch.clamp(4.0 * m.dot(wo_out, n), min=1e-8)
    diff_pdf = m.dot(wi, n) * INV_PI
    return m.mix(diff_pdf, spec_pdf, 1.0 / (2.0 - metal))


def _metallic_sample(p: MatParams, n, wo, r):
    """VNDF alpha = roughness^2, lobe pick with probability 1/(2-metallic)."""
    wo_out = -wo
    spec_prob = 1.0 / (2.0 - p.metallic)
    pick_spec = r[:, 2] < spec_prob
    wm = m.sample_normal_ggx(n, wo_out, p.roughness * p.roughness, r[:, 0:2])
    d_spec = m.reflect(wo, wm)
    d_diff = m.sample_hemisphere_cosine(n, r[:, 0:2])
    d = torch.where(pick_spec[..., None], d_spec, d_diff)
    bad = (m.dot(wo_out, n) < 0.0) | (m.dot(d, n) < 0.0)
    bsdf = metallic_bsdf(n, wo_out, d, p.albedo, p.roughness, p.metallic)
    pdf = metallic_pdf(n, wo_out, d, p.roughness, p.metallic)
    bsdf = torch.where(bad[..., None], 0.0, bsdf)
    pdf = torch.where(bad, 0.0, pdf)
    return bsdf, pdf, d


_SAMPLERS = {
    LAMBERTIAN: _lambertian_sample,
    DIELECTRIC: _dielectric_sample,
    MICROFACET: _microfacet_sample,
    METALLIC_WORKFLOW: _metallic_sample,
}


def scatter_sample(p: MatParams, n, wo, rands, present=None) -> ScatterRecord:
    """Sample an outgoing direction, bsdf and pdf for every ray.  `rands` is
    (N, 3): cols 0-1 the 2D sample, col 2 the lobe/Fresnel sample.
    `present` (the scene's material types) skips absent lobes."""
    t = p.type
    bsdf = p.emit  # Light default
    pdf = torch.ones_like(p.roughness)
    d = torch.zeros_like(n)
    for mtype, fn in _SAMPLERS.items():
        if present is not None and mtype not in present:
            continue
        b_i, p_i, d_i = fn(p, n, wo, rands)
        sel = t == mtype
        bsdf = torch.where(sel[..., None], b_i, bsdf)
        pdf = torch.where(sel, p_i, pdf)
        d = torch.where(sel[..., None], d_i, d)
    return ScatterRecord(bsdf=bsdf, pdf=pdf, delta=t == DIELECTRIC, dir=d)


def bsdf_eval(p: MatParams, n, wo, wi, present=None):
    """BSDF value for the pair (wo = ray dir into the surface, wi)."""
    wo_out = -wo
    t = p.type
    out = torch.zeros_like(p.albedo)

    def has(mt):
        return present is None or mt in present

    if has(LAMBERTIAN):
        out = torch.where((t == LAMBERTIAN)[..., None], p.albedo * INV_PI, out)
    if has(MICROFACET):
        out = torch.where(
            (t == MICROFACET)[..., None],
            microfacet_bsdf(n, wo_out, wi, p.albedo, p.roughness),
            out,
        )
    if has(METALLIC_WORKFLOW):
        out = torch.where(
            (t == METALLIC_WORKFLOW)[..., None],
            metallic_bsdf(n, wo_out, wi, p.albedo, p.roughness, p.metallic),
            out,
        )
    return out


def pdf_eval(p: MatParams, n, wo, wi, present=None):
    """Solid-angle pdf of sampling wi."""
    wo_out = -wo
    t = p.type
    out = torch.zeros_like(p.roughness)

    def has(mt):
        return present is None or mt in present

    if has(LAMBERTIAN):
        out = torch.where(t == LAMBERTIAN, m.dot(wi, n) * INV_PI, out)
    if has(MICROFACET):
        out = torch.where(t == MICROFACET, microfacet_pdf(n, wo_out, wi, p.roughness), out)
    if has(METALLIC_WORKFLOW):
        out = torch.where(
            t == METALLIC_WORKFLOW, metallic_pdf(n, wo_out, wi, p.roughness, p.metallic), out
        )
    return out
