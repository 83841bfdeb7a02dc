"""The material lobes' kernels: M1 (each lane's scatter draw and lobe sample)
and M2 (each lane's bsdf and pdf at a given direction).

The JAX package shades in plain jnp (`pathtracer_tpu/ops/materials.py`,
`pathtracer_tpu/utils/rng.py`); here the CUDA kernels live in
`csrc/shade.cu`, the RNG's device function in `csrc/rng.cuh`.  As
`ops/sweep_cuda.py` does for S1/S2, this module holds, for each:

- the wrapper (`scatter_lobes`, `eval_lobes`): on a CPU tensor it runs the
  plain PyTorch version; on a CUDA tensor it launches the kernel (building it
  on first use) or raises.  It never falls back.
- the plain PyTorch version (`*_plain`): `utils/rng.py pixel_uniforms` then
  `ops/materials.py scatter_sample`; `bsdf_eval` and `pdf_eval`.  The
  kernels keep every operation of them in the same order, so the two agree
  bit for bit on every lane whose material type the call's `present` holds
  (the plain version skips absent lobes; the kernels run each lane's own).

The wrappers launch through `ops/_build.py launch`, which counts M1's and
M2's launches in its table (the draw kernel's, none).

The RNG's counter fields, `iteration` and `depth`, may be Python ints (the
kernel takes them as immediates), 0-d int32 tensors (a CUDA graph's
buffers: the kernel reads the word on the card) or (N,) int32 tensors (per
lane, under regeneration).  The key words and `pixel0` are immediates.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops._build import column, draw_args, lanes
from pathtracer_tpu_torch.ops.materials import (
    MatParams,
    ScatterRecord,
    bsdf_eval,
    pdf_eval,
    scatter_sample,
)
from pathtracer_tpu_torch.scene.parser import DIELECTRIC
from pathtracer_tpu_torch.utils import rng

# ---------------------------------------------------------------------------
# plain PyTorch versions


def scatter_draw_plain(key, iteration, depth, lane, pixel0: int = 0):
    """The (N, 3) uniforms of M1's draw: STAGE_SCATTER at counter lane + pixel0."""
    pixel_idx = lane + pixel0 if pixel0 else lane
    return rng.pixel_uniforms(key, iteration, depth, rng.STAGE_SCATTER, pixel_idx, 3)


def scatter_lobes_plain(p: MatParams, n, wo, key, iteration, depth, lane, pixel0: int = 0,
                        present=None) -> ScatterRecord:
    """Plain M1 (any device): each lane's scatter draw, then `scatter_sample`."""
    return scatter_sample(p, n, wo, scatter_draw_plain(key, iteration, depth, lane, pixel0),
                          present=present)


def eval_lobes_plain(p: MatParams, n, wo, wi, present=None):
    """Plain M2 (any device): (`bsdf_eval`, `pdf_eval`) at wi."""
    return bsdf_eval(p, n, wo, wi, present=present), pdf_eval(p, n, wo, wi, present=present)


# ---------------------------------------------------------------------------
# wrappers


def _material(p: MatParams, n: int, device, full: bool) -> tuple:
    """The material columns the kernels read: type, albedo, roughness,
    metallic, and with `full` (M1) ior and the emission."""
    f32 = torch.float32
    cols = [column(p.type, "type", n, 1, torch.int32, device),
            column(p.albedo, "albedo", n, 3, f32, device),
            column(p.roughness, "roughness", n, 1, f32, device),
            column(p.metallic, "metallic", n, 1, f32, device)]
    if full:
        cols += [column(p.ior, "ior", n, 1, f32, device),
                 column(p.emit, "emit", n, 3, f32, device)]
    return tuple(v for c in cols for v in c)


def scatter_draw(key, iteration, depth, lane, pixel0: int = 0):
    """M1's draw alone, (N, 3) float32, as `scatter_draw_plain` gives it.  CPU
    tensors take the plain version; CUDA tensors launch csrc/shade.cu's
    draw kernel (which runs M1's draw code, and counts as no M1 launch)."""
    if lanes("the material lobes", lane) == "cpu":
        return scatter_draw_plain(key, iteration, depth, lane, pixel0)
    args = draw_args(key, iteration, depth, lane, pixel0)
    out = torch.empty((lane.shape[0], 3), dtype=torch.float32, device=lane.device)
    _build.launch("pt_scatter_draw", lane.device, *args, out, lane.shape[0])
    return out


def scatter_lobes(p: MatParams, n, wo, key, iteration, depth, lane, pixel0: int = 0,
                  present=None) -> ScatterRecord:
    """M1: each lane's scatter sample from its draw at (`iteration`,
    `depth`, STAGE_SCATTER) and counter lane + `pixel0`, as
    `scatter_lobes_plain` gives it; `delta` is a PyTorch compare.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, which runs each
    lane's own lobe and needs no `present`."""
    if lanes("the material lobes", lane, n, wo) == "cpu":
        return scatter_lobes_plain(p, n, wo, key, iteration, depth, lane, pixel0, present)
    dev, f32, count = lane.device, torch.float32, lane.shape[0]
    args = (*_material(p, count, dev, full=True), *column(n, "n", count, 3, f32, dev),
            *column(wo, "wo", count, 3, f32, dev),
            *draw_args(key, iteration, depth, lane, pixel0))
    bsdf = torch.empty((count, 3), dtype=f32, device=dev)
    pdf = torch.empty((count,), dtype=f32, device=dev)
    d = torch.empty((count, 3), dtype=f32, device=dev)
    _build.launch("pt_scatter_lobes", dev, *args, bsdf, pdf, d, count)
    return ScatterRecord(bsdf=bsdf, pdf=pdf, delta=p.type == DIELECTRIC, dir=d)


def eval_lobes(p: MatParams, n, wo, wi, present=None):
    """M2: (bsdf (N, 3), pdf (N,)) of each lane's lobe for the pair (wo =
    ray direction into the surface, wi), as `eval_lobes_plain` gives them.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if lanes("the material lobes", p.type, n, wo, wi) == "cpu":
        return eval_lobes_plain(p, n, wo, wi, present)
    dev, f32, count = p.type.device, torch.float32, p.type.shape[0]
    args = (*_material(p, count, dev, full=False), *column(n, "n", count, 3, f32, dev),
            *column(wo, "wo", count, 3, f32, dev), *column(wi, "wi", count, 3, f32, dev))
    bsdf = torch.empty((count, 3), dtype=f32, device=dev)
    pdf = torch.empty((count,), dtype=f32, device=dev)
    _build.launch("pt_eval_lobes", dev, *args, bsdf, pdf, count)
    return bsdf, pdf
