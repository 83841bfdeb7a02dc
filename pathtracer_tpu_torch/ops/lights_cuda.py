"""The light side of NEE's kernels: L1 (each lane's STAGE_LIGHT draw and its
own light's sample, with the shadow ray toward it) and L2 (each lane's
light pdf at the hit of its BSDF-sampled ray).

The JAX package samples lights in plain jnp (`pathtracer_tpu/ops/lights.py`,
`pathtracer_tpu/utils/rng.py`); here the CUDA kernels live in
`csrc/lights.cu`.  As `ops/shade_cuda.py` does for M1/M2, this module holds,
for each:

- the wrapper (`sample_lights`, `eval_light_pdf`): on a CPU tensor it runs
  the plain PyTorch version; on a CUDA tensor it launches the kernel
  (building it on first use) or raises.  It never falls back.
- the plain PyTorch version (`*_plain`): `utils/rng.py pixel_uniforms` then
  `ops/lights.py light_samples`; `light_pdf`.  The kernels keep every
  operation of them in the same order, so the two agree bit for bit on
  every lane (the plain versions run every light's or sphere's branch over
  every lane and select; the kernels run each lane's own).

With `include_env` the environment is light L of L + 1: L1 writes each
lane's four uniforms and `ops/lights.py env_lights` (plain PyTorch, on both
devices) fills the environment's lanes and their shadow rays after it.

The wrappers launch through `ops/_build.py launch`, which counts L1's and
L2's launches in its table.  The RNG's counter fields, `iteration` and
`depth`, may be Python ints, 0-d int32 tensors or (N,) int32 tensors, as
`ops/_build.py counter` takes them.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops._build import column, draw_args, lanes
from pathtracer_tpu_torch.ops.lights import (
    LightSample,
    env_lights,
    inv_count,
    light_pdf,
    light_samples,
    shadow_rays,
)
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.utils import rng

_WHAT = "the light kernels"


# ---------------------------------------------------------------------------
# plain PyTorch versions


def light_draw_plain(key, iteration, depth, lane, pixel0: int = 0, include_env: bool = False):
    """The (N, 3) uniforms of L1's draw, (N, 4) with `include_env`:
    STAGE_LIGHT at counter lane + pixel0."""
    pixel_idx = lane + pixel0 if pixel0 else lane
    return rng.pixel_uniforms(key, iteration, depth, rng.STAGE_LIGHT, pixel_idx,
                              4 if include_env else 3)


def sample_lights_plain(flat: FlatScene, static: SceneStatic, view_pos, key, iteration, depth,
                        lane, pixel0: int = 0, enabled=None, include_env: bool = False,
                        mark=None) -> LightSample:
    """Plain L1 (any device): each lane's light draw, then `light_samples`."""
    rands = light_draw_plain(key, iteration, depth, lane, pixel0, include_env)
    return light_samples(flat, static, view_pos, rands, enabled, include_env, mark=mark)


def eval_light_pdf_plain(flat: FlatScene, static: SceneStatic, view_pos, light_pos, normal,
                         tri_id, geom_id, include_env: bool = False):
    """Plain L2 (any device): `light_pdf`."""
    return light_pdf(flat, static, view_pos, light_pos, normal, tri_id, geom_id, include_env)


# ---------------------------------------------------------------------------
# wrappers


def _tables(flat: FlatScene, static: SceneStatic, num_sampled: int) -> tuple:
    """The scene's tables of csrc/lights.cu `Lights`, checked, for
    `num_sampled` lights (L, or L + 1 with the environment)."""
    tabs = dict(light_geom=flat.light_geom, light_tri=flat.light_tri,
                geom_type=flat.geom_type, geom_mat=flat.geom_mat, light_geoms=flat.light_geoms,
                mat_f32=flat.mat_f32, geom_transform=flat.geom_transform,
                geom_inv=flat.geom_inv, tri_data=flat.tri_data)
    i32, f32 = torch.int32, torch.float32
    _build.check_cuda_args(tabs, dict(
        light_geom=i32, light_tri=i32, geom_type=i32, geom_mat=i32, light_geoms=torch.bool,
        mat_f32=f32, geom_transform=f32, geom_inv=f32, tri_data=f32))
    g = flat.geom_type.shape[0]
    if (flat.light_geoms.shape != (g,) or flat.geom_inv.shape != (g, 4, 4)
            or flat.geom_transform.shape != (g, 4, 4)
            or flat.light_tri.shape != flat.light_geom.shape):
        raise ValueError("the light and geom tables disagree in length")
    inv_l = inv_count(num_sampled) if num_sampled else 0.0
    return (flat.light_geom, flat.light_tri, flat.light_geom.shape[0], static.num_lights,
            float(num_sampled), inv_l, flat.geom_type, flat.geom_mat, flat.light_geoms, g,
            flat.mat_f32, flat.mat_f32.shape[1], flat.geom_transform, flat.geom_inv,
            flat.tri_data, flat.tri_data.shape[1])


def sample_lights(flat: FlatScene, static: SceneStatic, view_pos, key, iteration, depth, lane,
                  pixel0: int = 0, enabled=None, include_env: bool = False,
                  mark=None) -> LightSample:
    """L1: each lane's light sample before the shadow test, from its draw at
    (`iteration`, `depth`, STAGE_LIGHT) and counter lane + `pixel0`, as
    `sample_lights_plain` gives it.  `enabled` (N,) bool masks the lanes
    whose shadow ray is traced.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, which runs each lane's own light.  `mark`
    stamps `env_lights` (the span `device.env_light`)."""
    if lanes(_WHAT, lane, view_pos) == "cpu":
        return sample_lights_plain(flat, static, view_pos, key, iteration, depth, lane, pixel0,
                                   enabled, include_env, mark=mark)
    dev, f32, n = lane.device, torch.float32, lane.shape[0]
    num_sampled = static.num_lights + (1 if include_env else 0)
    mask = (None, 0) if enabled is None else column(enabled, "enabled", n, 1, torch.bool, dev)
    args = (*column(view_pos, "view_pos", n, 3, f32, dev), *mask,
            *draw_args(key, iteration, depth, lane, pixel0), *_tables(flat, static, num_sampled))
    pos, emit, org, d = (torch.empty((n, 3), dtype=f32, device=dev) for _ in range(4))
    pdf = torch.empty((n,), dtype=f32, device=dev)
    occ_on = torch.empty((n,), dtype=torch.bool, device=dev)
    rands = torch.empty((n, 4), dtype=f32, device=dev) if include_env else None
    _build.launch("pt_sample_lights", dev, *args, pos, emit, pdf, org, d, occ_on, rands, n)
    if include_env:
        pos, emit, pdf = env_lights(flat, static, view_pos, rands, pos, emit, pdf, mark=mark)
        return shadow_rays(view_pos, pos, emit, pdf, enabled)
    return LightSample(pos=pos, emit=emit, pdf=pdf, origin=org, dir=d, occ_on=occ_on)


def eval_light_pdf(flat: FlatScene, static: SceneStatic, view_pos, light_pos, normal, tri_id,
                   geom_id, include_env: bool = False):
    """L2: (N,) the light pdf of each lane's hit (`light_pos`, `normal`,
    `tri_id`, `geom_id`) seen from `view_pos`, as `eval_light_pdf_plain`
    gives it.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if lanes(_WHAT, tri_id, view_pos, light_pos, normal) == "cpu":
        return eval_light_pdf_plain(flat, static, view_pos, light_pos, normal, tri_id, geom_id,
                                    include_env)
    dev, f32, n = tri_id.device, torch.float32, tri_id.shape[0]
    num_sampled = static.num_lights + (1 if include_env else 0)
    args = (*column(view_pos, "view_pos", n, 3, f32, dev),
            *column(light_pos, "light_pos", n, 3, f32, dev),
            *column(normal, "normal", n, 3, f32, dev),
            *column(tri_id, "tri_id", n, 1, torch.int32, dev),
            *column(geom_id, "geom_id", n, 1, torch.int32, dev),
            *_tables(flat, static, num_sampled))
    pdf = torch.empty((n,), dtype=f32, device=dev)
    _build.launch("pt_light_pdf", dev, *args, pdf, n)
    return pdf
