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
from pathtracer_tpu_torch.ops.materials import (
    MatParams,
    ScatterRecord,
    bsdf_eval,
    pdf_eval,
    scatter_sample,
)
from pathtracer_tpu_torch.scene.parser import DIELECTRIC
from pathtracer_tpu_torch.utils import rng

_M32 = 0xFFFFFFFF


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


def _col(t, name: str, n: int, width: int, dtype, device) -> tuple:
    """(pointer, stride between lanes in elements) of an (n,) or (n, 3)
    input column, checked: its card, dtype and shape, and a row's three
    values adjacent."""
    want = (n,) if width == 1 else (n, width)
    if tuple(t.shape) != want:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if width > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must hold a lane's {width} values adjacent")
    return t.data_ptr(), t.stride(0)


def _counter(x, name: str, n: int, device) -> tuple:
    """(pointer, stride, immediate) of an RNG counter field: an int is an
    immediate (null pointer); a 0-d or one-element int32 tensor is one word
    on the card (stride 0); an (n,) int32 tensor is one word a lane."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & _M32
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.int32")
    if x.dim() <= 1 and x.numel() == 1:
        return x.data_ptr(), 0, 0
    if tuple(x.shape) == (n,):
        return x.data_ptr(), x.stride(0), 0
    raise ValueError(f"{name} must be an int, a one-word tensor or (N,): {tuple(x.shape)}")


def _draw_args(key, iteration, depth, lane, pixel0: int) -> tuple:
    """The draw's arguments of the C entry points, from the lane column on."""
    n, dev = lane.shape[0], lane.device
    if not isinstance(depth, torch.Tensor) and int(depth) > rng.MAX_DEPTH:
        raise ValueError(f"depth {depth} does not fit the counter's 8 depth bits")
    k0, k1 = (int(k) & _M32 for k in key)
    return (*_col(lane, "lane", n, 1, torch.int32, dev), int(pixel0) & _M32, k0, k1,
            *_counter(iteration, "iteration", n, dev), *_counter(depth, "depth", n, dev))


def _material(p: MatParams, n: int, device, full: bool) -> tuple:
    """The material columns the kernels read: type, albedo, roughness,
    metallic, and with `full` (M1) ior and the emission."""
    f32 = torch.float32
    cols = [_col(p.type, "type", n, 1, torch.int32, device),
            _col(p.albedo, "albedo", n, 3, f32, device),
            _col(p.roughness, "roughness", n, 1, f32, device),
            _col(p.metallic, "metallic", n, 1, f32, device)]
    if full:
        cols += [_col(p.ior, "ior", n, 1, f32, device), _col(p.emit, "emit", n, 3, f32, device)]
    return tuple(v for c in cols for v in c)


def _lanes(col, *vecs) -> str:
    """The device type of lanes given by (N,) column `col` and (N, 3)
    direction columns `vecs`, their shapes checked."""
    if col.dim() != 1:
        raise ValueError(f"a lane column must be (N,): {tuple(col.shape)}")
    for v in vecs:
        if v.shape != (col.shape[0], 3):
            raise ValueError(f"directions must be (N, 3) for {col.shape[0]} lanes: "
                             f"{tuple(v.shape)}")
    return _build.device_type(col, "the material lobes")


def scatter_draw(key, iteration, depth, lane, pixel0: int = 0):
    """M1's draw alone, (N, 3) float32, as `scatter_draw_plain` gives it.  CPU
    tensors take the plain version; CUDA tensors launch csrc/shade.cu's
    draw kernel (which runs M1's draw code, and counts as no M1 launch)."""
    if _lanes(lane) == "cpu":
        return scatter_draw_plain(key, iteration, depth, lane, pixel0)
    args = _draw_args(key, iteration, depth, lane, pixel0)
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
    if _lanes(lane, n, wo) == "cpu":
        return scatter_lobes_plain(p, n, wo, key, iteration, depth, lane, pixel0, present)
    dev, f32, count = lane.device, torch.float32, lane.shape[0]
    args = (*_material(p, count, dev, full=True), *_col(n, "n", count, 3, f32, dev),
            *_col(wo, "wo", count, 3, f32, dev), *_draw_args(key, iteration, depth, lane, pixel0))
    bsdf = torch.empty((count, 3), dtype=f32, device=dev)
    pdf = torch.empty((count,), dtype=f32, device=dev)
    d = torch.empty((count, 3), dtype=f32, device=dev)
    _build.launch("pt_scatter_lobes", dev, *args, bsdf, pdf, d, count)
    return ScatterRecord(bsdf=bsdf, pdf=pdf, delta=p.type == DIELECTRIC, dir=d)


def eval_lobes(p: MatParams, n, wo, wi, present=None):
    """M2: (bsdf (N, 3), pdf (N,)) of each lane's lobe for the pair (wo =
    ray direction into the surface, wi), as `eval_lobes_plain` gives them.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if _lanes(p.type, n, wo, wi) == "cpu":
        return eval_lobes_plain(p, n, wo, wi, present)
    dev, f32, count = p.type.device, torch.float32, p.type.shape[0]
    args = (*_material(p, count, dev, full=False), *_col(n, "n", count, 3, f32, dev),
            *_col(wo, "wo", count, 3, f32, dev), *_col(wi, "wi", count, 3, f32, dev))
    bsdf = torch.empty((count, 3), dtype=f32, device=dev)
    pdf = torch.empty((count,), dtype=f32, device=dev)
    _build.launch("pt_eval_lobes", dev, *args, bsdf, pdf, count)
    return bsdf, pdf
