"""HDR environment-map importance sampling.

Port of `pathtracer_tpu/ops/envmap.py`.  `sample_env` draws a direction with
probability proportional to luminance * sin(theta) through the one flat CDF
over all env texels (`FlatScene.env_flat_cdf`) and returns (dir, radiance,
pdf per solid angle); `env_pdf` is the same pdf for a given direction, the
MIS weight of a BSDF ray that escapes to the sky.  With u -> phi = 2 pi u and
v -> elevation pi (v - 1/2), pdf_w = pdf_uv / (2 pi^2 cos(elevation)).
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import math as m
from pathtracer_tpu_torch.ops.texture import bilinear_sample_u32_meta
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.utils.config import PI, TWO_PI


def sample_env(flat: FlatScene, static: SceneStatic, u1, u2, u3):
    """Importance-sample the env map: u1 picks the texel (binary search of
    the flat CDF, the first entry above u1), u2 and u3 jitter within it.
    Returns (dir (N, 3), Le (N, 3), pdf_w (N,))."""
    cdf = flat.env_flat_cdf
    pdf_tab = flat.env_pdf
    h, w = pdf_tab.shape
    idx = torch.clamp(torch.searchsorted(cdf, u1.contiguous(), right=True) - 1, 0, h * w - 1)
    row = idx // w
    col = idx % w
    u = (col.to(torch.float32) + u2) / w
    v = (row.to(torch.float32) + u3) / h

    phi = TWO_PI * u
    theta_e = PI * (v - 0.5)
    cos_e = torch.cos(theta_e)
    direction = torch.stack(
        [cos_e * torch.cos(phi), torch.sin(theta_e), cos_e * torch.sin(phi)], dim=-1)
    pdf_w = pdf_tab[row, col] / torch.clamp(2.0 * PI * PI * cos_e, min=1e-8)

    eoff, ew, eh, efmt = static.tex_rows[static.env_map_id]
    le = bilinear_sample_u32_meta(flat.atlas_u32, eoff, ew, eh, bool(efmt),
                                  torch.stack([u, v], dim=-1))
    return direction, le, pdf_w


def env_pdf(flat: FlatScene, static: SceneStatic, d):
    """pdf_w of `sample_env` for unit directions `d` (N, 3)."""
    pdf_tab = flat.env_pdf
    h, w = pdf_tab.shape
    uv = m.sphere_to_plane(d)
    col = torch.clamp((uv[:, 0] * w).to(torch.int32), 0, w - 1).long()
    row = torch.clamp((uv[:, 1] * h).to(torch.int32), 0, h - 1).long()
    cos_e = torch.sqrt(torch.clamp(1.0 - d[:, 1] * d[:, 1], min=1e-8))
    return pdf_tab[row, col] / torch.clamp(2.0 * PI * PI * cos_e, min=1e-8)
