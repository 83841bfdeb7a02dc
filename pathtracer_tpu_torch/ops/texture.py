"""Texture atlas sampling over packed texels.

Port of the packed-texel samplers of `pathtracer_tpu/ops/texture.py`.  Every
texture lives in one flat atlas, one 32-bit word a texel: 8-bit R, G, B in
bits 0-23 and, for HDR textures (RGBE), the shared exponent in bits 24-31.
The atlas is int32 here (PyTorch has few uint32 ops), so a byte is always
masked after its shift: `>>` extends the sign.

Bilinear convention, as the reference's: x = u * (width - 1), taps at
floor(x) and floor(x) + 1 unless that reaches the width (clamp to edge, no
wrap); texel (x, y) at offset + y * width + x.  A texture's offset, width,
height and format are given by the caller, as Python ints or per-lane int32
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

INV_255 = float(np.float32(1.0 / 255.0))


def _unpack_rgb(v):
    r = (v & 255).to(torch.float32)
    g = ((v >> 8) & 255).to(torch.float32)
    b = ((v >> 16) & 255).to(torch.float32)
    return torch.stack([r, g, b], dim=-1)


def _unpack_u32_ldr(v):
    return _unpack_rgb(v) * INV_255


def _rgbe_scale(e):
    """2^(e - 136) for exponent bytes 1..255, 0 for 0, built from its bits, so
    exact on every device: biased exponent e - 9 for e >= 10, the denormal
    2^-149 * 2^(e + 13) below."""
    normal = (e - 9) << 23
    denormal = torch.bitwise_left_shift(torch.ones_like(e), (e + 13).clamp(max=22))
    bits = torch.where(e >= 10, normal, torch.where(e > 0, denormal, 0))
    return bits.to(torch.int32).view(torch.float32)


def _unpack_u32_rgbe(v):
    """RGBE decode, c * 2^(e - 136) and 0 when e == 0, as the .hdr reader's.
    The JAX package takes the scale from XLA's exp2, which on the CPU is off
    by up to 67 ulp and flushes the denormal scales to 0
    (tests/test_torch_texture.py); the port decodes exactly."""
    return _unpack_rgb(v) * _rgbe_scale((v >> 24) & 255)[..., None]


def _unpack_u32(v, is_rgbe):
    return torch.where(is_rgbe[..., None], _unpack_u32_rgbe(v), _unpack_u32_ldr(v))


def _as_i32(x):
    """Texture metadata as int32 lanes, or a Python int (no host copy)."""
    return x.to(torch.int32) if isinstance(x, torch.Tensor) else int(x)


def _as_f32(x):
    return x.to(torch.float32) if isinstance(x, torch.Tensor) else float(x)


def _bilinear_taps_meta(offset, width, height, uv, p_max: int):
    offset, width, height = (_as_i32(a) for a in (offset, width, height))
    u, v = uv[..., 0], uv[..., 1]
    x = u * _as_f32(width - 1)
    y = v * _as_f32(height - 1)
    fl_x, fl_y = torch.floor(x), torch.floor(y)
    lx, ly = fl_x.to(torch.int32), fl_y.to(torch.int32)
    ux = torch.where(x + 1.0 >= _as_f32(width), lx, lx + 1)
    uy = torch.where(y + 1.0 >= _as_f32(height), ly, ly + 1)
    fx, fy = x - fl_x, y - fl_y

    def idx(ix, iy):
        return torch.clamp(offset + iy * width + ix, 0, p_max).long()

    return (idx(lx, ly), idx(ux, ly), idx(lx, uy), idx(ux, uy)), fx, fy


def bilinear_sample_u32_meta(atlas_u32, offset, width, height, rgbe, uv):
    """(N, 3) bilinear samples of the packed atlas at `uv` (N, 2).  `rgbe` is
    a Python bool when every lane's texture has the same format, else an
    (N,) bool tensor."""
    (i00, i10, i01, i11), fx, fy = _bilinear_taps_meta(
        offset, width, height, uv, atlas_u32.shape[0] - 1)
    if isinstance(rgbe, bool):
        unpack = _unpack_u32_rgbe if rgbe else _unpack_u32_ldr
    else:
        unpack = lambda t: _unpack_u32(t, rgbe)  # noqa: E731
    t00, t10, t01, t11 = (unpack(atlas_u32[i]) for i in (i00, i10, i01, i11))
    fxn, fyn = fx[..., None], fy[..., None]
    p1 = t00 * (1.0 - fxn) + t10 * fxn
    p2 = t01 * (1.0 - fxn) + t11 * fxn
    return p1 * (1.0 - fyn) + p2 * fyn


def bilinear_sample_u32_1ch_meta(atlas_u32, offset, width, height, uv):
    """(N,) bilinear samples of channel 0 (R) of an LDR texture: the
    metallic and roughness maps."""
    (i00, i10, i01, i11), fx, fy = _bilinear_taps_meta(
        offset, width, height, uv, atlas_u32.shape[0] - 1)

    def ch(i):
        return (atlas_u32[i] & 255).to(torch.float32) * INV_255

    p1 = ch(i00) * (1.0 - fx) + ch(i10) * fx
    p2 = ch(i01) * (1.0 - fx) + ch(i11) * fx
    return p1 * (1.0 - fy) + p2 * fy
