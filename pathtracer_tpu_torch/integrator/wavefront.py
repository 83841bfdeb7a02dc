"""Wavefront path-tracing integrator (BSDF / direct-light / MIS).

Port of the classic fixed-pool iteration of
`pathtracer_tpu/integrator/wavefront.py`: a pool of W*H lanes, one per pixel,
advanced one bounce at a time by a Python loop over depth that stops as soon
as no lane is alive.  Dead lanes are masked, not compacted.  Radiance
accumulates on the lane (`contrib`) and folds into the image once per
iteration.

Physics conventions, as the JAX package:
- camera AA jitter (r - 0.5) and the pixel -> direction mapping;
- ray-offset epsilons: dielectric 1e-3 * (sign-aligned normal), others
  1e-4 * new_dir;
- a path that exhausts its depth contributes nothing more;
- NaN/Inf are scrubbed before every accumulation;
- MIS: prev_pdf carries the BSDF pdf (-1 for delta), light hits are weighted
  by powerHeuristic(prev_pdf, lightPDF), the NEE term by
  powerHeuristic(lightPdf, bsdfPdf);
- rays are counted as the reference emits them: every live ray, plus one
  shadow ray per NEE-eligible lane even where NEE is statically zero;
- normal mapping through the triangle's tangent frame, where the tangent is
  valid;
- a ray that misses everything in a scene with an environment map dies and
  is flagged; its frozen direction, throughput and pdf fetch the env radiance
  (MIS-weighted against the env's importance pdf with `env_importance`) once,
  after the last bounce;
- `show_normal`: every ray ends at its first hit with normalize(normal) + 1.

Left out, because they only reorder lanes: the per-bounce sort, the pool
shrink ladder and the shadow sort (ROADMAP Queue 1 item 10).  The RNG keys on
the lane's pixel and contributions ride the lane, so the output is the same.
Also left out: the ray-regeneration pool (item 14b).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.scene.parser import DIELECTRIC, LIGHT, SPHERE
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from pathtracer_tpu_torch.ops import math as m
from pathtracer_tpu_torch.ops.envmap import env_pdf
from pathtracer_tpu_torch.ops.lights import light_pdf, light_sample
from pathtracer_tpu_torch.ops.materials import (
    bsdf_eval,
    material_by_geom,
    pdf_eval,
    scatter_sample,
)
from pathtracer_tpu_torch.ops.texture import bilinear_sample_u32_meta
from pathtracer_tpu_torch.ops.traverse import closest_hit
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.utils import rng


class CameraArrays(NamedTuple):
    position: torch.Tensor      # (3,)
    view: torch.Tensor          # (3,)
    up: torch.Tensor            # (3,)
    right: torch.Tensor         # (3,)
    pixel_length: torch.Tensor  # (2,)


def camera_rays(cam: CameraArrays, width: int, height: int, key, iteration, pixel_xy=None):
    """Per-pixel AA-jittered primary rays for the whole frame.

    Lane l draws its jitter from counter l (its pixel index in the JAX
    package's numbering) and renders pixel `pixel_xy[l]` when the spatial
    swizzle is on (else pixel l).
    """
    n = width * height
    dev = cam.position.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if pixel_xy is not None:
        x, y = pixel_xy
    else:
        x = (idx % width).to(torch.float32)
        y = (idx // width).to(torch.float32)
    r = rng.pixel_uniforms(key, iteration, 0, rng.STAGE_CAMERA, idx, 2)
    px = x + (r[:, 0] - 0.5) - width * 0.5
    py = y + (r[:, 1] - 0.5) - height * 0.5
    d = m.normalize(
        cam.view[None, :]
        - cam.right[None, :] * (cam.pixel_length[0] * px)[:, None]
        - cam.up[None, :] * (cam.pixel_length[1] * py)[:, None]
    )
    o = cam.position.expand(n, 3).contiguous()
    return o, d


def nee_live(static: SceneStatic, env_nee: bool = False) -> bool:
    """Can NEE contribute at all?  Only triangle and sphere lights, and the
    environment with `env_nee`, have a sampling branch; a scene lit by cubes
    alone skips the NEE work (its shadow rays are still counted)."""
    return (
        static.num_lights > len(static.analytic_lights)
        or any(g == SPHERE for (_, _, g) in static.analytic_lights)
        or env_nee
    )


class _Pool(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    color: torch.Tensor
    contrib: torch.Tensor
    prev_pdf: torch.Tensor
    alive: torch.Tensor
    env_miss: torch.Tensor  # (N,) bool: the lane died by missing the scene


def new_pool(o, d) -> _Pool:
    """The pool of fresh camera rays (o, d)."""
    n = o.shape[0]
    return _Pool(
        o=o, d=d,
        color=torch.ones((n, 3), device=o.device),
        contrib=torch.zeros((n, 3), device=o.device),
        prev_pdf=torch.full((n,), -1.0, device=o.device),
        alive=torch.ones((n,), dtype=torch.bool, device=o.device),
        env_miss=torch.zeros((n,), dtype=torch.bool, device=o.device),
    )


def _apply_normal_map(hit, params):
    """The shading normal: the normal-map texel in the triangle's tangent
    frame, where the tangent is valid and the texel is not (0, 0, 1); else
    the hit's normal."""
    n = m.normalize(hit.normal)
    local = m.normalize(params.normal_map - 0.5)
    t = hit.tangent
    use_tbn = (m.dot(t, t) > 1e-3) & (torch.abs(local[:, 2] - 1.0) > 1e-5)
    b2 = m.normalize(m.cross(n, t))
    t2 = m.normalize(m.cross(b2, n))
    mapped = m.normalize(local[:, 0:1] * t2 + local[:, 1:2] * b2 + local[:, 2:3] * n)
    return torch.where(use_tbn[..., None], mapped, n)


def bounce(flat: FlatScene, static: SceneStatic, mode: SampleMode, key,
           iteration: int, depth: int, s: _Pool,
           trace: dict | None = None, env_nee: bool = False,
           show_normal: bool = False) -> tuple[_Pool, torch.Tensor]:
    """One intersect + shade pass over the pool; returns (pool, rays emitted).
    `env_nee` samples the environment as one more light (`env_importance`
    with an env map); `show_normal` ends every ray at its first hit.
    `trace`, if given, receives the pass's stage arrays by name (the hit, the
    material parameters and shading normal, the scatter sample, the light
    sample and the BSDF evaluations at its direction, the light-hit and NEE
    terms before process_nan), as tools/stage_diff_torch.py compares them."""
    note = trace.update if trace is not None else (lambda **_: None)
    present = static.material_types
    alive = s.alive
    pixel_idx = torch.arange(alive.shape[0], dtype=torch.int32, device=alive.device)
    contrib = s.contrib
    hit = closest_hit(flat, static, s.o, s.d, alive=alive)
    rays = alive.sum()
    miss = hit.geom < 0

    if show_normal:
        viz = m.process_nan(m.normalize(hit.normal) + 1.0)
        contrib = contrib + torch.where((alive & ~miss)[..., None], viz, 0.0)
        return s._replace(contrib=contrib, alive=torch.zeros_like(alive)), rays
    env_miss = s.env_miss | (alive & miss) if static.env_map_id >= 0 else s.env_miss
    alive = alive & ~miss
    params = material_by_geom(flat, static, hit.geom, hit.uv)
    # no material has a normal map: every lane would keep the hit's normal
    nrm = _apply_normal_map(hit, params) if static.tex_slots[3] else m.normalize(hit.normal)
    is_light = params.type == LIGHT
    is_delta = params.type == DIELECTRIC

    sc_rand = rng.pixel_uniforms(key, iteration, depth, rng.STAGE_SCATTER, pixel_idx, 3)
    srec = scatter_sample(params, nrm, s.d, sc_rand, present=present)
    pdf_ok = srec.pdf != 0.0
    note(hit=hit, params=params, nrm=nrm, srec=srec)

    if mode == SampleMode.DIRECT_LI:
        add_light = alive & is_light
        contrib = contrib + torch.where(
            add_light[..., None], m.process_nan(s.color * params.emit), 0.0
        )
        nee_on = alive & ~is_light & ~is_delta
        rays = rays + nee_on.sum()
        if nee_live(static, env_nee):
            li_rand = rng.pixel_uniforms(key, iteration, depth, rng.STAGE_LIGHT, pixel_idx,
                                         4 if env_nee else 3)
            lrec = light_sample(flat, static, hit.point, li_rand, enabled=nee_on,
                                include_env=env_nee)
            wi = m.normalize(lrec.pos - hit.point)
            bsdf = bsdf_eval(params, nrm, s.d, wi, present=present)
            nee = (
                s.color * bsdf * lrec.emit
                * (torch.clamp(m.dot(wi, nrm), min=0.0) / lrec.pdf)[..., None]
            )
            note(lrec=lrec, li_bsdf=bsdf, nee=nee)
            add_nee = alive & ~is_light & (lrec.pdf > 0.0)
            contrib = contrib + torch.where(add_nee[..., None], m.process_nan(nee), 0.0)
        return s._replace(contrib=contrib, alive=torch.zeros_like(alive), env_miss=env_miss), rays

    # light hit term
    light_color = s.color * srec.bsdf / torch.clamp(srec.pdf, min=1e-38)[..., None]
    if mode == SampleMode.MIS:
        lp = light_pdf(flat, static, s.o, hit.point, nrm, hit.tri, hit.geom, include_env=env_nee)
        weight = torch.where(s.prev_pdf > 0.0, m.power_heuristic(s.prev_pdf, lp), 1.0)
        light_color = light_color * weight[..., None]
    add_light = alive & pdf_ok & is_light
    contrib = contrib + torch.where(add_light[..., None], m.process_nan(light_color), 0.0)
    note(light_color=light_color)

    cont = alive & pdf_ok & ~is_light

    # NEE term (MIS only, non-delta)
    if mode == SampleMode.MIS:
        rays = rays + (cont & ~is_delta).sum()
        if nee_live(static, env_nee):
            li_rand = rng.pixel_uniforms(key, iteration, depth, rng.STAGE_LIGHT, pixel_idx,
                                         4 if env_nee else 3)
            lrec = light_sample(flat, static, hit.point, li_rand, enabled=cont & ~is_delta,
                                include_env=env_nee)
            wi = m.normalize(lrec.pos - hit.point)
            b_pdf = pdf_eval(params, nrm, s.d, wi, present=present)
            li_bsdf = bsdf_eval(params, nrm, s.d, wi, present=present)
            w = m.power_heuristic(lrec.pdf, b_pdf)
            nee = (
                w[..., None] * s.color * lrec.emit * li_bsdf
                * (torch.clamp(m.dot(wi, nrm), min=0.0) / lrec.pdf)[..., None]
            )
            note(lrec=lrec, b_pdf=b_pdf, li_bsdf=li_bsdf, nee=nee)
            add_nee = cont & ~is_delta
            contrib = contrib + torch.where(add_nee[..., None], m.process_nan(nee), 0.0)

    # continuation
    offset_dir = torch.where((m.dot(srec.dir, nrm) > 0.0)[..., None], nrm, -nrm)
    new_o = hit.point + torch.where(is_delta[..., None], 1e-3 * offset_dir, 1e-4 * srec.dir)
    throughput = srec.bsdf * (
        torch.abs(m.dot(srec.dir, nrm)) / torch.clamp(srec.pdf, min=1e-38)
    )[..., None]
    cm = cont[..., None]
    prev_pdf = s.prev_pdf
    if mode == SampleMode.MIS:
        prev_pdf = torch.where(cont, torch.where(is_delta, -1.0, srec.pdf), prev_pdf)
    return _Pool(
        o=torch.where(cm, new_o, s.o),
        d=torch.where(cm, srec.dir, s.d),
        color=torch.where(cm, s.color * throughput, s.color),
        contrib=contrib,
        prev_pdf=prev_pdf,
        alive=cont & (depth + 1 < static.trace_depth),
        env_miss=env_miss,
    ), rays


def resolve_env(flat: FlatScene, static: SceneStatic, mode: SampleMode, s: _Pool,
                env_nee: bool = False):
    """The pool's contributions with the env radiance of its env-missed
    lanes added: the env texel along each lane's frozen direction, times
    its frozen throughput, MIS-weighted in MIS mode with `env_nee`."""
    if static.env_map_id < 0:
        return s.contrib
    eoff, ew, eh, efmt = static.tex_rows[static.env_map_id]
    env = bilinear_sample_u32_meta(flat.atlas_u32, eoff, ew, eh, bool(efmt),
                                   m.sphere_to_plane(s.d))
    env_w = 1.0
    if mode == SampleMode.MIS and env_nee:
        ep = env_pdf(flat, static, s.d) / float(static.num_lights + 1)
        env_w = torch.where(s.prev_pdf > 0.0, m.power_heuristic(s.prev_pdf, ep), 1.0)[..., None]
    env_scale = torch.where(s.env_miss[..., None], s.color, 0.0)
    return s.contrib + m.process_nan(env_scale * env * env_w)


def render_iteration(flat: FlatScene, static: SceneStatic, opts: RenderOptions,
                     cam: CameraArrays, key, iteration: int, pixel_xy=None):
    """One sample per pixel.  Returns (contrib (W*H, 3) in lane order,
    rays emitted (int64 tensor), bounce laps run)."""
    if static.trace_depth > rng.MAX_DEPTH:
        raise ValueError(
            f"trace depth {static.trace_depth} does not fit the RNG counter's "
            f"8 depth bits (max {rng.MAX_DEPTH})"
        )
    w, h = static.width, static.height
    env_nee = bool(opts.env_importance) and static.env_map_id >= 0
    pool = new_pool(*camera_rays(cam, w, h, key, iteration, pixel_xy=pixel_xy))
    rays = torch.zeros((), dtype=torch.int64, device=flat.device)
    laps = 0
    for depth in range(static.trace_depth + 1):
        if not bool(pool.alive.any()):
            break
        pool, r = bounce(flat, static, opts.sample_mode, key, iteration, depth, pool,
                         env_nee=env_nee, show_normal=bool(opts.show_normal))
        rays = rays + r
        laps += 1
    return resolve_env(flat, static, opts.sample_mode, pool, env_nee), rays, laps
