"""Wavefront path-tracing integrator (BSDF / direct-light / MIS).

Port of `pathtracer_tpu/integrator/wavefront.py`: a pool of W*H lanes, one per
pixel, advanced one bounce (a lap) at a time by a host loop that stops as
soon as no lane is alive.  Radiance accumulates on the lane (`contrib`) and
folds into the image once per iteration.  An iteration is a few steps that
run on the device alone (`start_pool`, `lap_step`, `level_down`,
`merge_back`, `finish`) and the host's decisions between them, from one
read of the live count a lap (`drive_laps`); `render_iteration` runs the
steps eagerly, integrator/graphs.py replays them as CUDA graphs.

Each lane carries its own id (`lane`); the RNG keys on it, so lanes may move.
The scheduler (`schedule`, `render_iteration`) moves them, as the JAX
package's default does:
- the per-bounce sort (`compaction`, on for meshes of 512 triangles or more
  and for textured scenes): live lanes by direction octant, origin cell and
  whether the ray meets the triangle root box, dead lanes behind them; at
  lap 0, then every `sort_every` laps while more than a quarter of the pool
  is alive;
- the shrink ladder (`pool_shrink`, `shrink_levels`, `shrink_half`): once the
  live lanes fit the next of a few static pool sizes, they are sorted to the
  front and the laps go on over that prefix; the cut lanes wait in the full
  pool and are merged back after.  The sizes are static per level;
- the shadow sort (`shadow_sort`, with the sort only): ops/traverse.py
  `occlusion_test`.
The contributions are un-permuted by `lane` before the env resolve, so the
returned contrib is bit for bit the unsorted pool's: no per-lane computation
depends on a lane's position or on the pool's length.

Ray regeneration (`nk`, RenderOptions.ray_regen): one persistent pool renders
nk samples per pixel.  At the end of a lap, a lane whose path has ended is
refilled with the camera ray of its pixel's next sample (`refill`), after
cashing its deferred env radiance.  The `meta` column, (sample offset << 8) |
depth, rides every sort and cut and keys the lane's RNG, so the sample set and
the rays are the classic ones; only the order of the float additions changes.
Dead lanes are therefore exhausted ones at every lap boundary, and the ladder
fires only in the final drain.

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
  after the last bounce (or at its refill, under regeneration);
- `show_normal`: every ray ends at its first hit with normalize(normal) + 1.
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
from pathtracer_tpu_torch.ops.intersect import ray_aabb
from pathtracer_tpu_torch.ops.traverse import DEAD_KEY, closest_hit, octant_cell_key
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.utils import profiling, rng


class CameraArrays(NamedTuple):
    position: torch.Tensor      # (3,)
    view: torch.Tensor          # (3,)
    up: torch.Tensor            # (3,)
    right: torch.Tensor         # (3,)
    pixel_length: torch.Tensor  # (2,)


def _lane_rays(cam: CameraArrays, width: int, height: int, key, iteration, lane, x, y):
    """Camera rays of lanes `lane` through film positions (x, y): the AA
    jitter from counter `lane` at `iteration` (an int or a per-lane tensor)."""
    r = rng.pixel_uniforms(key, iteration, 0, rng.STAGE_CAMERA, lane, 2)
    px = x + (r[:, 0] - 0.5) - width * 0.5
    py = y + (r[:, 1] - 0.5) - height * 0.5
    d = m.normalize(
        cam.view[None, :]
        - cam.right[None, :] * (cam.pixel_length[0] * px)[:, None]
        - cam.up[None, :] * (cam.pixel_length[1] * py)[:, None]
    )
    o = cam.position.expand(lane.shape[0], 3).contiguous()
    return o, d


def camera_rays(cam: CameraArrays, width: int, height: int, key, iteration, pixel_xy=None,
                pixel0: int = 0, local_n: int | None = None):
    """Per-pixel AA-jittered primary rays for the whole frame, or for the
    `local_n` pixels from `pixel0` on (a shard of a film of width x height).

    Lane l draws its jitter from counter pixel0 + l (its pixel index in the
    JAX package's numbering) and renders pixel `pixel_xy[l]` when the
    spatial swizzle is on (else pixel pixel0 + l).
    """
    n = width * height if local_n is None else local_n
    idx = torch.arange(n, dtype=torch.int32, device=cam.position.device)
    if pixel0:
        idx = idx + pixel0
    x, y = pixel_xy if pixel_xy is not None else lane_xy(idx, width, height)
    return _lane_rays(cam, width, height, key, iteration, idx, x, y)


SWIZZLE_BLOCK = 32  # integrator/render.py swizzle_map's block


def swizzle_xy_from_lane(lane, width: int, block: int = SWIZZLE_BLOCK):
    """The film (x, y) of `lane` under render.swizzle_map, for a film that
    tiles into block x block squares: there the swizzle key of lane l is l,
    so unpacking it inverts the map without a table."""
    b2 = block * block
    blk, r = lane // b2, lane % b2
    x = (blk % (width // block)) * block + r % block
    y = (blk // (width // block)) * block + r // block
    return x.to(torch.float32), y.to(torch.float32)


def lane_xy(lane, width: int, height: int, pixel_xy=None):
    """The film (x, y) that lanes `lane` render: pixel l, or `pixel_xy[l]`
    under the spatial swizzle (unpacked arithmetically where the film tiles
    into swizzle blocks)."""
    if pixel_xy is None:
        return (lane % width).to(torch.float32), (lane // width).to(torch.float32)
    if width % SWIZZLE_BLOCK == 0 and height % SWIZZLE_BLOCK == 0:
        return swizzle_xy_from_lane(lane, width)
    return pixel_xy[0][lane.long()], pixel_xy[1][lane.long()]


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
    lane: torch.Tensor      # (N,) int32: the lane's id, its pixel's RNG counter
    meta: torch.Tensor | None = None  # (N,) int32 under regeneration:
    # (sample offset << 8) | depth of the lane's path


def new_pool(o, d, regen: bool = False) -> _Pool:
    """The pool of fresh camera rays (o, d), lane l in position l; with the
    regeneration column when `regen`."""
    n = o.shape[0]
    return _Pool(
        o=o, d=d,
        color=torch.ones((n, 3), device=o.device),
        contrib=torch.zeros((n, 3), device=o.device),
        prev_pdf=torch.full((n,), -1.0, device=o.device),
        alive=torch.ones((n,), dtype=torch.bool, device=o.device),
        env_miss=torch.zeros((n,), dtype=torch.bool, device=o.device),
        lane=torch.arange(n, dtype=torch.int32, device=o.device),
        meta=torch.zeros((n,), dtype=torch.int32, device=o.device) if regen else None,
    )


def _map_pool(s: _Pool, f) -> _Pool:
    return _Pool(*(None if c is None else f(c) for c in s))


def sort_pool(flat: FlatScene, static: SceneStatic, s: _Pool) -> _Pool:
    """The pool reordered, stably: live lanes by `octant_cell_key`, those
    whose ray misses the triangle root box after those that meet it, dead
    lanes last."""
    key = octant_cell_key(flat, s.o, s.d)
    if static.num_tris > 0:
        rb = flat.root_box
        rb_hit, _ = ray_aabb(rb[0:3], rb[3:6], s.o, s.d)
        key = key + (~rb_hit).to(torch.int32) * (1 << 12)
    key = torch.where(s.alive, key, DEAD_KEY)
    perm = torch.sort(key, stable=True).indices
    return _map_pool(s, lambda c: c.index_select(0, perm))


def in_lane_order(s: _Pool, names=("contrib",)) -> _Pool:
    """The pool's columns `names` with lane l's entry in position l (`lane`
    is a permutation, so the scatter is exact)."""
    lane = s.lane.long()

    def put(c):
        out = torch.empty_like(c)
        out[lane] = c
        return out

    return s._replace(**{k: put(getattr(s, k)) for k in names})


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
           show_normal: bool = False, shadow_sort: bool = False, pixel0: int = 0,
           use_kernels: bool = True, use_bvh: bool = True, mark=None) -> tuple[_Pool, torch.Tensor]:
    """One intersect + shade pass over the pool; returns (pool, rays emitted).
    Lanes draw their random numbers at (`iteration`, `depth`), or under
    regeneration at their own sample and depth from `meta`.
    `env_nee` samples the environment as one more light (`env_importance`
    with an env map); `show_normal` ends every ray at its first hit;
    `shadow_sort` sorts the NEE shadow rays for the any-hit kernel;
    `use_kernels` / `use_bvh` pick the triangle walks (ops/traverse.py).
    Lane l's RNG counter is pixel0 + l (a shard's first pixel).
    `trace`, if given, receives the pass's stage arrays by name (the hit, the
    material parameters and shading normal, the scatter sample, the light
    sample and the BSDF evaluations at its direction, the light-hit and NEE
    terms before process_nan), as tools/stage_diff_torch.py compares them.
    `mark`, if given, is called with utils/profiling.py's stamp column at
    each stage edge: the closest hit (INTERSECT), the shading after it
    (SHADE), the NEE (NEE) and the shading after that (SHADE_AFTER_NEE)."""
    note = trace.update if trace is not None else (lambda **_: None)
    present = static.material_types
    alive = s.alive
    pixel_idx = s.lane + pixel0 if pixel0 else s.lane
    walk = dict(use_kernels=use_kernels, use_bvh=use_bvh)
    if s.meta is None:
        rng_it, rng_dp = iteration, depth
    else:
        rng_it, rng_dp = iteration + (s.meta >> 8), s.meta & 0xFF
    contrib = s.contrib
    if mark is not None:
        mark(profiling.INTERSECT)
    hit = closest_hit(flat, static, s.o, s.d, alive=alive, **walk)
    if mark is not None:
        mark(profiling.SHADE)
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

    sc_rand = rng.pixel_uniforms(key, rng_it, rng_dp, rng.STAGE_SCATTER, pixel_idx, 3)
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
            if mark is not None:
                mark(profiling.NEE)
            li_rand = rng.pixel_uniforms(key, rng_it, rng_dp, rng.STAGE_LIGHT, pixel_idx,
                                         4 if env_nee else 3)
            lrec = light_sample(flat, static, hit.point, li_rand, enabled=nee_on,
                                include_env=env_nee, shadow_sort=shadow_sort, **walk)
            wi = m.normalize(lrec.pos - hit.point)
            bsdf = bsdf_eval(params, nrm, s.d, wi, present=present)
            nee = (
                s.color * bsdf * lrec.emit
                * (torch.clamp(m.dot(wi, nrm), min=0.0) / lrec.pdf)[..., None]
            )
            note(lrec=lrec, li_bsdf=bsdf, nee=nee)
            add_nee = alive & ~is_light & (lrec.pdf > 0.0)
            contrib = contrib + torch.where(add_nee[..., None], m.process_nan(nee), 0.0)
            if mark is not None:
                mark(profiling.SHADE_AFTER_NEE)
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
            if mark is not None:
                mark(profiling.NEE)
            li_rand = rng.pixel_uniforms(key, rng_it, rng_dp, rng.STAGE_LIGHT, pixel_idx,
                                         4 if env_nee else 3)
            lrec = light_sample(flat, static, hit.point, li_rand, enabled=cont & ~is_delta,
                                include_env=env_nee, shadow_sort=shadow_sort, **walk)
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
            if mark is not None:
                mark(profiling.SHADE_AFTER_NEE)

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
        alive=cont & (rng_dp + 1 < static.trace_depth),
        env_miss=env_miss,
        lane=s.lane,
        meta=None if s.meta is None else torch.where(cont, s.meta + 1, s.meta),
    ), rays


def _env_radiance(flat: FlatScene, static: SceneStatic, mode: SampleMode, s: _Pool,
                  lanes, env_nee: bool):
    """The env radiance of lanes `lanes` (0 elsewhere): the env texel along
    each lane's frozen direction, times its frozen throughput, MIS-weighted
    in MIS mode with `env_nee`."""
    eoff, ew, eh, efmt = static.tex_rows[static.env_map_id]
    env = bilinear_sample_u32_meta(flat.atlas_u32, eoff, ew, eh, bool(efmt),
                                   m.sphere_to_plane(s.d))
    env_w = 1.0
    if mode == SampleMode.MIS and env_nee:
        ep = env_pdf(flat, static, s.d) / float(static.num_lights + 1)
        env_w = torch.where(s.prev_pdf > 0.0, m.power_heuristic(s.prev_pdf, ep), 1.0)[..., None]
    env_scale = torch.where(lanes[..., None], s.color, 0.0)
    return m.process_nan(env_scale * env * env_w)


def resolve_env(flat: FlatScene, static: SceneStatic, mode: SampleMode, s: _Pool,
                env_nee: bool = False):
    """The pool's contributions with the env radiance of its env-missed
    lanes added."""
    if static.env_map_id < 0:
        return s.contrib
    return s.contrib + _env_radiance(flat, static, mode, s, s.env_miss, env_nee)


class Regen(NamedTuple):
    """What a refill needs: the camera, the film, the lane -> pixel map, the
    batch's sample count (an int, or a 0-d tensor) and the pool's first
    pixel."""
    cam: CameraArrays
    width: int
    height: int
    pixel_xy: tuple | None
    nk: int | torch.Tensor
    pixel0: int = 0


def refill(flat: FlatScene, static: SceneStatic, mode: SampleMode, key, iteration: int,
           s: _Pool, rg: Regen, env_nee: bool = False) -> _Pool:
    """Lanes whose path has ended and whose pixel has samples left start the
    next one: its camera ray (sample `iteration` + offset + 1), throughput
    1, meta (offset + 1) << 8.  An env-missed lane cashes its deferred env
    radiance first, while its direction, throughput and pdf are still its
    path's."""
    it_ofs = s.meta >> 8
    regen = ~s.alive & (it_ofs < rg.nk - 1)
    contrib, env_miss = s.contrib, s.env_miss
    if static.env_map_id >= 0:
        contrib = contrib + _env_radiance(flat, static, mode, s, regen & env_miss, env_nee)
        env_miss = env_miss & ~regen
    gid = s.lane + rg.pixel0 if rg.pixel0 else s.lane
    x, y = lane_xy(gid, rg.width, rg.height, rg.pixel_xy)
    ro, rd = _lane_rays(rg.cam, rg.width, rg.height, key, iteration + it_ofs + 1, gid, x, y)
    rm = regen[..., None]
    return _Pool(
        o=torch.where(rm, ro, s.o),
        d=torch.where(rm, rd, s.d),
        color=torch.where(rm, 1.0, s.color),
        contrib=contrib,
        prev_pdf=torch.where(regen, -1.0, s.prev_pdf),
        alive=s.alive | regen,
        env_miss=env_miss,
        lane=s.lane,
        meta=torch.where(regen, (it_ofs + 1) << 8, s.meta),
    )


class Schedule(NamedTuple):
    sort_rays: bool     # the per-bounce sort
    shadow_sort: bool   # the shadow rays' sort (with the per-bounce sort only)
    sort_every: int     # sort at lap 0 and at every sort_every-th lap after
    shrink: tuple       # the ladder: ((pool size, divisor), ...); a level
    # starts once alive * divisor <= the pool it leaves


def schedule(static: SceneStatic, opts: RenderOptions, n: int) -> Schedule:
    """The JAX package's scheduling rule (`pathtracer_tpu/integrator/
    wavefront.py:236-272`) for a pool of n lanes.  The sort pays where the
    walk is dear (512 triangles or more) or the shading taps textures per
    lane; an analytic scene shrinks without sorting.  Ladder sizes are whole
    tiles of `packet_rows` x 128 lanes, as the JAX package cuts them."""
    sort_rays = bool(opts.compaction) and (static.num_tris >= 512 or any(static.tex_slots))
    shrink_ok = bool(opts.pool_shrink) and (sort_rays or static.num_tris == 0)
    tile = max(int(opts.packet_rows), 1) * 128
    divs = [4] * max(int(opts.shrink_levels), 0)
    if opts.shrink_half and sort_rays:
        divs = [2] + divs
    sizes, cur = [], n
    for div in divs if shrink_ok else ():
        nxt = -(-max(cur // div, 1) // tile) * tile
        if not 0 < nxt < cur:
            break
        sizes.append((nxt, div))
        cur = nxt
    return Schedule(sort_rays, bool(opts.shadow_sort) and sort_rays,
                    max(int(opts.sort_every), 1), tuple(sizes))


class LapSpec(NamedTuple):
    """What every step of one iteration reads besides the pool and the
    counters: the scene, the options' decisions, the film and, under
    regeneration, the refill.  Fixed for an iteration, and for the life of a
    CUDA graph that holds the steps (integrator/graphs.py)."""
    flat: FlatScene
    static: SceneStatic
    mode: SampleMode
    key: tuple
    env_nee: bool
    show_normal: bool
    sched: Schedule
    walk: dict            # use_kernels, use_bvh: the triangle walk (ops/traverse.py)
    pixel_xy: tuple | None
    pixel0: int
    rg: Regen | None      # the refill, under regeneration


def lap_spec(flat: FlatScene, static: SceneStatic, opts: RenderOptions, cam: CameraArrays,
             key, n: int, pixel_xy=None, nk=None, pixel0: int = 0) -> LapSpec:
    """The LapSpec of an iteration over a pool of n lanes; `nk` (an int or a
    0-d tensor) turns regeneration on."""
    if static.trace_depth > rng.MAX_DEPTH:
        raise ValueError(
            f"trace depth {static.trace_depth} does not fit the RNG counter's "
            f"8 depth bits (max {rng.MAX_DEPTH})"
        )
    rg = None if nk is None else Regen(cam, static.width, static.height, pixel_xy, nk, pixel0)
    return LapSpec(
        flat, static, opts.sample_mode, key,
        env_nee=bool(opts.env_importance) and static.env_map_id >= 0,
        show_normal=bool(opts.show_normal), sched=schedule(static, opts, n),
        walk=dict(use_kernels=bool(opts.pallas_traversal), use_bvh=bool(opts.use_bvh)),
        pixel_xy=pixel_xy, pixel0=pixel0, rg=rg,
    )


# The steps of an iteration.  Each runs on the device alone: it reads its
# scalars (`iteration`, `depth`: ints, or 0-d tensors) and its pool, and no
# value comes back to the host, so a CUDA graph can hold it.


def start_pool(spec: LapSpec, cam: CameraArrays, iteration, n: int) -> _Pool:
    """The iteration's first pool: n fresh camera rays from the spec's first
    pixel on."""
    o, d = camera_rays(cam, spec.static.width, spec.static.height, spec.key, iteration,
                       pixel_xy=spec.pixel_xy, pixel0=spec.pixel0, local_n=n)
    return new_pool(o, d, regen=spec.rg is not None)


def lap_step(spec: LapSpec, s: _Pool, iteration, depth, sort: bool,
             mark=None) -> tuple[_Pool, torch.Tensor]:
    """One lap at lap index `depth`: the per-bounce sort when `sort`, one
    bounce, and the refill under regeneration.  Returns (pool, rays
    emitted).  `mark` as `bounce` takes it, called at the sort's start too
    (SORT)."""
    if sort:
        if mark is not None:
            mark(profiling.SORT)
        s = sort_pool(spec.flat, spec.static, s)
    s, rays = bounce(spec.flat, spec.static, spec.mode, spec.key, iteration, depth, s,
                     env_nee=spec.env_nee, show_normal=spec.show_normal,
                     shadow_sort=spec.sched.shadow_sort, pixel0=spec.pixel0, **spec.walk,
                     mark=mark)
    if spec.rg is not None:
        s = refill(spec.flat, spec.static, spec.mode, spec.key, iteration, s, spec.rg,
                   spec.env_nee)
    return s, rays


def level_down(flat: FlatScene, static: SceneStatic, s: _Pool,
               size: int, mark=None) -> tuple[_Pool, _Pool]:
    """A step down the shrink ladder: the pool sorted, live lanes first, and
    its first `size` lanes, over which the laps go on.  `mark`, if given,
    is called with utils/profiling.py's stamp column at the sort's edges
    (SORT, STAGES_END)."""
    if mark is not None:
        mark(profiling.SORT)
    full = sort_pool(flat, static, s)
    if mark is not None:
        mark(profiling.STAGES_END)
    return full, _map_pool(full, lambda c: c[:size])


def merge_back(small: _Pool, full: _Pool) -> _Pool:
    """The pool after a ladder level: the level's lanes, then those cut."""
    size = small.lane.shape[0]
    return _Pool(*(None if a is None else torch.cat([a, b[size:]])
                   for a, b in zip(small, full)))


def finish(spec: LapSpec, s: _Pool) -> torch.Tensor:
    """The iteration's contributions in lane order, with the env radiance of
    its env-missed lanes added."""
    if spec.sched.sort_rays or spec.sched.shrink:
        # the env resolve's columns too: on the CPU, atan2 rounds by position
        env_cols = (("d", "color", "prev_pdf", "env_miss") if spec.static.env_map_id >= 0
                    else ())
        s = in_lane_order(s, ("contrib",) + env_cols)
    return resolve_env(spec.flat, spec.static, spec.mode, s, spec.env_nee)


def lap_budget(static: SceneStatic, nk=None) -> int:
    """The most laps an iteration runs: trace_depth + 1, times the batch's
    samples under regeneration."""
    return (static.trace_depth + 1) * (1 if nk is None else int(nk))


def lap_plan(sched: Schedule, n: int, budget: int):
    """The host's side of an iteration as a plan that can be resumed: every
    decision, from one read of the live count a lap.  A generator that
    yields ("lap", level, depth, sort) (one lap on the pool of ladder level
    `level`, 0: all n lanes; it is then sent the lap's live count),
    ("down", level) (from level to level + 1, `level_down`) and ("up",
    level) (back, `merge_back`).  Laps run while lanes live and the budget
    lasts; a level starts once alive * divisor <= the pool it leaves, and
    the laps then end inside it, so the steps back up all come last.  The
    sort runs at lap 0, then every `sort_every`-th lap while more than a
    quarter of the pool lives.  Returns (as StopIteration's value) the
    pool's length at each lap run.  Several plans advanced in turns keep
    several devices' laps in flight at once (integrator/graphs.py
    run_lockstep)."""
    laps = []
    level, pool_n, alive_n = 0, n, n
    while alive_n > 0 and len(laps) < budget:
        if level < len(sched.shrink) and alive_n * sched.shrink[level][1] <= pool_n:
            yield ("down", level)
            pool_n = sched.shrink[level][0]
            level += 1
            continue
        depth = len(laps)
        sort = sched.sort_rays and (depth == 0 or (depth % sched.sort_every == 0
                                                   and alive_n * 4 > pool_n))
        alive_n = yield ("lap", level, depth, sort)
        laps.append(pool_n)
    for back in reversed(range(level)):
        yield ("up", back)
    return laps


def drive_laps(sched: Schedule, n: int, budget: int, lap, down, up) -> list:
    """`lap_plan` run to its end by callbacks: `lap(level, depth, sort)` runs
    one lap and returns its live count, `down(level)` and `up(level)` step
    the ladder.  Returns the pool's length at each lap run."""
    plan = lap_plan(sched, n, budget)
    reply = None
    while True:
        try:
            step = plan.send(reply)
        except StopIteration as done:
            return done.value
        kind, *args = step
        reply = lap(*args) if kind == "lap" else (down if kind == "down" else up)(*args)


def render_iteration(flat: FlatScene, static: SceneStatic, opts: RenderOptions,
                     cam: CameraArrays, key, iteration: int, pixel_xy=None, nk=None,
                     pixel0: int = 0, local_rows: int | None = None):
    """One sample per pixel, or with `nk` the samples iteration ..
    iteration + nk - 1 in one regeneration pool.  Returns (contrib
    (W*H, 3) in lane order, rays emitted (int64 tensor), the pool's length
    at each lap run).  One host read a lap: the live count, which serves
    the loop, the sort's rule and the ladder (`drive_laps`).  The eager
    loop over the steps above; integrator/graphs.py replays the same steps
    as CUDA graphs.

    `local_rows` rows from pixel `pixel0` on make the pool instead of the
    whole film (the sharding hook of the JAX package's
    make_render_iteration): contrib is then (local_rows * W, 3), and rows
    past the film's last (a mesh's padding) are rendered like any other."""
    n = static.width * (static.height if local_rows is None else local_rows)
    spec = lap_spec(flat, static, opts, cam, key, n, pixel_xy=pixel_xy,
                    nk=None if nk is None else int(nk), pixel0=pixel0)
    rays = torch.zeros((), dtype=torch.int64, device=flat.device)
    pools = [start_pool(spec, cam, iteration, n)]  # one per ladder level entered

    def lap(level: int, depth: int, sort: bool) -> int:
        nonlocal rays
        pools[-1], r = lap_step(spec, pools[-1], iteration, depth, sort)
        rays = rays + r
        return int(pools[-1].alive.sum())

    def down(level: int) -> None:
        pools[-1], small = level_down(flat, static, pools[-1], spec.sched.shrink[level][0])
        pools.append(small)

    def up(level: int) -> None:
        small = pools.pop()
        pools[-1] = merge_back(small, pools[-1])

    laps = drive_laps(spec.sched, n, lap_budget(static, nk), lap, down, up)
    return finish(spec, pools[0]), rays, laps


def check_film(static: SceneStatic, width: int, height: int) -> None:
    """A step is made for the film its tables were built for."""
    if (static.width, static.height) != (width, height):
        raise ValueError(f"the tables were built for a {static.width}x{static.height} film, "
                         f"not {width}x{height}")


def make_render_iteration(static: SceneStatic, opts: RenderOptions, width: int, height: int,
                          local_rows: int | None = None, pixel_xy=None, regen_k: int = 1):
    """The JAX package's step factory (`pathtracer_tpu/integrator/
    wavefront.py make_render_iteration`) over `render_iteration`.

    Returns f(flat, cam, img, iteration, key, pixel0=0) -> (img + contrib,
    rays, depth): `img` is the running HDR sum in lane order, (local_rows *
    width, 3); rays the int64 count of the rays emitted; depth the bounce
    laps run, all levels of the shrink ladder counted (the JAX package's
    traced depth).  `local_rows` rows from pixel `pixel0` on make the pool
    (the sharding hook; default: the whole film).  With `regen_k` > 1 it
    returns the regeneration variant f(flat, cam, img, it0, key, nk,
    pixel0=0), samples it0 .. it0 + nk - 1 in one pool.  `iteration`, `it0`,
    `nk` and `pixel0` may be ints or 0-d tensors: the lap loop runs on the
    host, so a CUDA tensor costs one host read each.  The image add is the
    Renderer's, so a step is bit for bit a Renderer iteration on the same
    lanes.

    Where the JAX package jits the step, on a CUDA `flat` the step runs
    through `integrator/graphs.py StaticIteration`: one per device and first
    pixel, kept in the factory and made anew when the tables, the key words
    or the route flags change (its graphs captured at its first run, then
    replayed); it returns new tensors, so a result a caller holds is never
    overwritten.  On the CPU, and for a triangle scene off the kernels
    (`graphs.graph_route`), the step runs the eager loop,
    `render_iteration`.  The JAX package's staged entries (start_state,
    bounce_step, finish_state) are not ported: the port's iteration is a
    host loop of laps already."""
    check_film(static, width, height)
    regen = int(regen_k) > 1
    if regen and (opts.sample_mode == SampleMode.DIRECT_LI or bool(opts.show_normal)):
        raise ValueError(
            "ray regeneration applies to the multi-bounce BSDF/MIS integrators (DIRECT_LI / "
            "show_normal pools die after one bounce by construction)")

    held = {}  # (device, pixel0) -> the StaticIteration last run there

    def run(flat, cam, img, iteration, key, nk, pixel0):
        from pathtracer_tpu_torch.integrator import graphs  # it imports this module

        pixel0 = int(pixel0)
        if not graphs.graph_route(static, opts, flat.device):
            contrib, rays, laps = render_iteration(
                flat, static, opts, cam, key, int(iteration), pixel_xy=pixel_xy, nk=nk,
                pixel0=pixel0, local_rows=local_rows)
            return img + contrib, rays, len(laps)
        it = graphs.held_iteration(held, (flat.device, pixel0), flat, static, opts, key,
                                   pixel_xy=pixel_xy, regen=regen, local_rows=local_rows,
                                   pixel0=pixel0)
        contrib, rays, laps = it.run(cam, int(iteration), nk)
        return img + contrib, rays.clone(), len(laps)  # the buffers: the next run overwrites them

    def render_step(flat: FlatScene, cam: CameraArrays, img, iteration, key, pixel0=0):
        return run(flat, cam, img, iteration, key, None, pixel0)

    def render_batch(flat: FlatScene, cam: CameraArrays, img, it0, key, nk, pixel0=0):
        return run(flat, cam, img, it0, key, int(nk), pixel0)

    fn = render_batch if regen else render_step
    fn.trace_depth = static.trace_depth
    return fn
