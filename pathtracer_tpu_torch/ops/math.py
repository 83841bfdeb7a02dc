"""Vectorized math and sampling library on tensors.

Port of the parts of `pathtracer_tpu/ops/math.py` that the materials, lights
and integrator call, plus ACES and gamma: the same functions, conventions,
clamps and epsilons, on (..., 3) float32 tensors.  A 3-vector dot product is
written as explicit multiply-adds summed left to right, so its rounding is
fixed and does not depend on a reduction kernel's order.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.utils.config import INV_PI, PI, TWO_PI

# ---------------------------------------------------------------------------
# small helpers


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def length2(v):
    return dot(v, v)


def normalize(v, eps=0.0):
    n2 = dot(v, v)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0)
    return v * inv[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def mix(a, b, t):
    return a * (1.0 - t) + b * t


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def sqr(x):
    return x * x


def process_nan(v):
    """Scrub NaN/Inf to 0 before accumulation."""
    return torch.where(torch.isfinite(v), v, 0.0)


def _unit(axis: int, like):
    """The unit vector along `axis`, broadcast to `like`'s shape, dtype and
    device (made on the device: no host copy)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[axis].expand(like.shape)


# ---------------------------------------------------------------------------
# tonemapping


def aces_film(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def gamma_correction(x):
    return torch.pow(torch.clamp(x, min=0.0), 1.0 / 2.2)


# ---------------------------------------------------------------------------
# orthonormal bases


def onb_pixar(n):
    """Branchless Pixar/Frisvad ONB; returns (tangent, bitangent)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sz = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = 1.0 / (sz + z)
    sx = sz * x
    b = x * y * a
    t = torch.stack([sx * x * a - 1.0, sz * b, sx], dim=-1)
    bt = torch.stack([b, y * y * a - sz, y], dim=-1)
    return t, bt


# ---------------------------------------------------------------------------
# mappings and primitive samplers


def _hypot(x1, x2):
    """jnp.hypot's formula: max * sqrt(1 + (min / max)^2), 0 where both are 0."""
    x1, x2 = torch.abs(x1), torch.abs(x2)
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    q = lo / torch.where(hi == 0.0, 1.0, hi)
    r = torch.where(hi == 0.0, hi, hi * torch.sqrt(1.0 + q * q))
    return torch.where(torch.isinf(x1) | torch.isinf(x2), torch.inf, r)


def sphere_to_plane(d):
    """Equirect direction -> uv in [0, 1]^2."""
    u = torch.remainder(torch.atan2(d[..., 2], d[..., 0]) * INV_PI * 0.5 + 1.0, 1.0)
    v = torch.clamp(torch.atan2(d[..., 1], _hypot(d[..., 0], d[..., 2])) * INV_PI + 0.5, min=0.0)
    return torch.stack([u, v], dim=-1)


def sample_triangle_uniform(r):
    """Uniform barycentric (u, v)."""
    t = torch.sqrt(r[..., 0])
    return torch.stack([1.0 - t, t * (1.0 - r[..., 1])], dim=-1)


def sample_uniform_disc(r):
    rad = torch.sqrt(r[..., 0])
    th = TWO_PI * r[..., 1]
    return torch.stack([rad * torch.cos(th), rad * torch.sin(th)], dim=-1)


def sample_hemisphere_cosine(n, r):
    """Cosine-weighted hemisphere around n via the Pixar ONB."""
    t, b = onb_pixar(n)
    r1, r2 = r[..., 0], r[..., 1]
    sin_t = torch.sqrt(r1)
    cos_t = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    phi = TWO_PI * r2
    x = sin_t * torch.cos(phi)
    y = sin_t * torch.sin(phi)
    return x[..., None] * t + y[..., None] * b + cos_t[..., None] * n


def _as_col(alpha, like):
    return torch.as_tensor(alpha, dtype=like.dtype, device=like.device)[..., None]


# ---------------------------------------------------------------------------
# reflection / refraction / Fresnel


def reflect_dir(n, wo):
    """Reflect the incoming dir `wo` (pointing INTO the surface) about the
    wo-facing side of n."""
    nf = torch.where((dot(wo, n) < 0.0)[..., None], n, -n)
    return wo - 2.0 * nf * dot(wo, nf)[..., None]


def reflect(i, n):
    """glm::reflect(I, N) = I - 2*dot(N,I)*N."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract_dir(n, wo, ior1, ior2):
    """Refract from medium ior1 into ior2; the radicand is clamped at 0."""
    nf = torch.where((dot(wo, n) < 0.0)[..., None], n, -n)
    eta = _as_col(ior1 / ior2, wo)
    r_perp = (wo - dot(wo, nf)[..., None] * nf) * eta
    k = torch.clamp(1.0 - length2(r_perp), min=0.0)
    r_para = -torch.sqrt(k)[..., None] * nf
    return r_perp + r_para


def fresnel_schlick(f0, cos_theta):
    """f0 may be a scalar or (..., 3)."""
    w = pow5(1.0 - cos_theta)
    if isinstance(f0, torch.Tensor) and f0.dim() and f0.shape[-1:] == (3,):
        return f0 + (1.0 - f0) * w[..., None]
    return f0 + (1.0 - f0) * w


def fresnel_maxwell(cos_theta1, ior1, ior2):
    """Exact unpolarized Fresnel; 1.0 at total internal reflection."""
    sin1 = torch.sqrt(torch.clamp(1.0 - cos_theta1 * cos_theta1, min=0.0))
    sin2 = sin1 * ior1 / ior2
    cos2 = torch.sqrt(torch.clamp(1.0 - sin2 * sin2, min=0.0))
    r_para = (ior1 * cos2 - ior2 * cos_theta1) / (ior1 * cos2 + ior2 * cos_theta1)
    r_perp = (ior1 * cos_theta1 - ior2 * cos2) / (ior1 * cos_theta1 + ior2 * cos2)
    f = 0.5 * (r_para * r_para + r_perp * r_perp)
    return torch.where(sin2 > 1.0, 1.0, f)


# ---------------------------------------------------------------------------
# GGX microfacet model


def ndf_ggx(cos_theta, a2):
    denom = cos_theta * cos_theta * (a2 - 1.0) + 1.0
    denom = denom * denom * PI
    d = a2 / torch.clamp(denom, min=1e-38)
    return torch.where(cos_theta < 1e-6, 0.0, d)


def smith_g1(a2, nov):
    denom = torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=0.0)) + nov
    return 2.0 * nov / torch.where(denom == 0.0, 1e-38, denom)


def smith_g2(a2, nov, nol):
    """Height-correlated Smith G2; callers pass roughness as `a2` (quirk)."""
    denom = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=0.0)) + nov * torch.sqrt(
        torch.clamp(nol * nol * (1.0 - a2) + a2, min=0.0)
    )
    return 2.0 * nov * nol / torch.where(denom == 0.0, 1e-38, denom)


def sample_normal_ggx(n, wo, alpha, r):
    """Sample a visible GGX half-vector (Heitz 2018 VNDF); `wo` points AWAY
    from the surface."""
    t, b = onb_pixar(n)
    wol = torch.stack([dot(wo, t), dot(wo, b), dot(wo, n)], dim=-1)
    a = _as_col(alpha, wol)
    wh = normalize(torch.cat([wol[..., :2] * a, wol[..., 2:]], dim=-1))
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)

    t1 = torch.where(
        (wh[..., 2] < 0.99999)[..., None],
        normalize(cross(_unit(2, wh), wh)),
        _unit(0, wh),
    )
    t2 = cross(wh, t1)

    p = sample_uniform_disc(r)
    h = torch.sqrt(torch.clamp(1.0 - sqr(p[..., 0]), min=0.0))
    lerp_t = (1.0 + wh[..., 2]) / 2.0
    py = (1.0 - lerp_t) * h + lerp_t * p[..., 1]
    p = torch.stack([p[..., 0], py], dim=-1)
    pz = torch.sqrt(torch.clamp(1.0 - (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]), min=0.0))
    nh = p[..., 0:1] * t1 + p[..., 1:2] * t2 + pz[..., None] * wh

    local = torch.cat([nh[..., :2] * a, torch.clamp(nh[..., 2:], min=1e-6)], dim=-1)
    world = local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    return normalize(world)


# ---------------------------------------------------------------------------
# MIS heuristics


def power_heuristic(f_pdf, g_pdf):
    f2, g2 = f_pdf * f_pdf, g_pdf * g_pdf
    return f2 / torch.where(f2 + g2 == 0.0, 1e-38, f2 + g2)
