"""The plain reference renderer: one path per (pixel, sample), written in
plain PyTorch from the reference path tracer's semantics, over the scene as
`reference/scene.py` reads it and the triangles through `reference/bvh.py`.

No kernel, no CUDA graph, no lane sort, no pool ladder: every live path
advances one bounce a step, with its own random numbers drawn from the
renderer's counter stream (`reference/rng.py`: the path's pixel counter,
its sample index, its bounce and the stage), so that each path is the one
the program traces for the same seed, pixel and sample.  The arithmetic is
written operation for operation in the order of the reference's kernels
(glm float code, each operation rounded once), as restated at commit
ac61a2f8 in `pathtracer_tpu_torch/ops/{math,intersect,materials,lights}.py`
and `integrator/wavefront.py bounce`, whose formulas are copied here; so on
the same device the two agree to the last bit on almost every path, and a
path whose hit or lobe choice a rounding tips differs whole.  The scene
reading and the BVH are the benchmark's own.

Semantics, with the reference's quirks: camera jitter (r - 0.5) and
tan(full FOVY) pixel length; analytic spheres (radius 0.5) and cubes in
object space, the hit pulled back 1e-4 along the object ray and t re-taken
as the world distance; Möller-Trumbore triangles with interpolated vertex
normals; Lambertian, Dielectric (exact Fresnel, delta), Microfacet (GGX,
roughness as alpha^2 in Smith G), MetallicWorkflow (VNDF at roughness^2,
lobe pick 1/(2 - metallic)); one uniformly picked light, sphere lights
cone-sampled as if of radius 0.5; the shadow ray from viewPos + 1e-5 dir,
analytic blockers with the window (t < minT - 1e-5, |t - minT| > 1e-2),
triangles with (t < minT - 1e-5, |t - minT| > 1e-4); MIS with the power
heuristic and prevPdf -1 after a delta lobe; NaN and Inf scrubbed before
each add; a path ends after `depth` bounces.  BSDF mode has no NEE and no
MIS weight.

An environment map (an ENV line) lights the rays that miss everything: the
texel along the ray, bilinear with clamp to edge (x = u * (W - 1)), at
the equirect coordinates u = atan2(z, x) / 2 pi + 1 mod 1, v =
atan2(y, hypot(x, z)) / pi + 1/2.  With `env_importance` (the traffic's
option of that name) MIS samples the sky as one more light, the last of
L + 1: a texel picked with probability lum * sin(theta) through one flat
CDF over all texels (the first entry above u), jittered within it, its pdf
per solid angle the texel's joint pdf / (2 pi^2 cos(elevation)), its light
point 1e7 out along the direction; a ray that escapes is then weighted by
the power heuristic against that pdf / (L + 1).

`dtype` sets the precision of every floating-point value (float32 as the
scene states; bfloat16 is the benchmark's control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bvh as bvh_mod
from benchmark.reference import rng
from benchmark.reference.scene import (
    CUBE, DIELECTRIC, LAMBERTIAN, LIGHT, METALLIC_WORKFLOW, MICROFACET, SPHERE, load,
)

PI = math.pi
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI


# -- vector helpers: (..., 3) tensors, sums left to right ---------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    n2 = dot(v, v)
    inv = torch.where(n2 > 0.0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0)
    return v * inv[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def process_nan(v):
    return torch.where(torch.isfinite(v), v, 0.0)


def power_heuristic(f, g):
    f2, g2 = f * f, g * g
    return f2 / torch.where(f2 + g2 == 0.0, 1e-38, f2 + g2)


def hypot(a, b):
    """max * sqrt(1 + (min / max)^2), 0 where both are 0."""
    a, b = torch.abs(a), torch.abs(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    q = lo / torch.where(hi == 0.0, 1.0, hi)
    r = torch.where(hi == 0.0, hi, hi * torch.sqrt(1.0 + q * q))
    return torch.where(torch.isinf(a) | torch.isinf(b), torch.inf, r)


def sphere_to_plane(d):
    """(u, v) in [0, 1] of directions `d` on the equirect map, up at v = 1."""
    u = torch.remainder(torch.atan2(d[..., 2], d[..., 0]) * INV_PI * 0.5 + 1.0, 1.0)
    v = torch.clamp(torch.atan2(d[..., 1], hypot(d[..., 0], d[..., 2])) * INV_PI + 0.5, min=0.0)
    return u, v


def xform_point(m, p):
    return torch.stack([m[..., i, 0] * p[..., 0] + m[..., i, 1] * p[..., 1] + m[..., i, 2] * p[..., 2]
                        + m[..., i, 3] for i in range(3)], dim=-1)


def onb(n):
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sz = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = 1.0 / (sz + z)
    sx = sz * x
    b = x * y * a
    return (torch.stack([sx * x * a - 1.0, sz * b, sx], dim=-1),
            torch.stack([b, y * y * a - sz, y], dim=-1))


def cosine_hemisphere(n, r):
    t, b = onb(n)
    sin_t = torch.sqrt(r[..., 0])
    cos_t = torch.sqrt(torch.clamp(1.0 - r[..., 0], min=0.0))
    phi = TWO_PI * r[..., 1]
    return (sin_t * torch.cos(phi))[..., None] * t + (sin_t * torch.sin(phi))[..., None] * b \
        + cos_t[..., None] * n


def ggx_visible_normal(n, wo, alpha, r):
    """Heitz's VNDF sample of a half vector; `wo` points away."""
    t, b = onb(n)
    wol = torch.stack([dot(wo, t), dot(wo, b), dot(wo, n)], dim=-1)
    a = alpha[..., None]
    wh = normalize(torch.cat([wol[..., :2] * a, wol[..., 2:]], dim=-1))
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    ez = torch.zeros_like(wh)
    ez[..., 2] = 1.0
    ex = torch.zeros_like(wh)
    ex[..., 0] = 1.0
    t1 = torch.where((wh[..., 2] < 0.99999)[..., None], normalize(cross(ez, wh)), ex)
    t2 = cross(wh, t1)
    rad = torch.sqrt(r[..., 0])
    th = TWO_PI * r[..., 1]
    p0, p1 = rad * torch.cos(th), rad * torch.sin(th)
    h = torch.sqrt(torch.clamp(1.0 - p0 * p0, min=0.0))
    lerp = (1.0 + wh[..., 2]) / 2.0
    p1 = (1.0 - lerp) * h + lerp * p1
    pz = torch.sqrt(torch.clamp(1.0 - (p0 * p0 + p1 * p1), min=0.0))
    nh = p0[..., None] * t1 + p1[..., None] * t2 + pz[..., None] * wh
    loc = torch.cat([nh[..., :2] * a, torch.clamp(nh[..., 2:], min=1e-6)], dim=-1)
    return normalize(loc[..., 0:1] * t + loc[..., 1:2] * b + loc[..., 2:3] * n)


def ndf(cos_t, a2):
    den = cos_t * cos_t * (a2 - 1.0) + 1.0
    den = den * den * PI
    return torch.where(cos_t < 1e-6, 0.0, a2 / torch.clamp(den, min=1e-38))


def smith_g1(a2, nov):
    den = torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=0.0)) + nov
    return 2.0 * nov / torch.where(den == 0.0, 1e-38, den)


def smith_g2(a2, nov, nol):
    den = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=0.0)) \
        + nov * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2) + a2, min=0.0))
    return 2.0 * nov * nol / torch.where(den == 0.0, 1e-38, den)


def schlick(f0, c):
    x = 1.0 - c
    x2 = x * x
    w = x2 * x2 * x
    return f0 + (1.0 - f0) * w[..., None]


def mix(a, b, t):
    return a * (1.0 - t) + b * t


# -- BSDFs: wo is the ray direction, into the surface -------------------------

def microfacet_f(n, wo, wi, albedo, rough):
    cos_o, cos_i = dot(n, wo), dot(n, wi)
    wm = normalize(wo + wi)
    val = schlick(albedo, dot(wo, wm)) * (ndf(dot(wm, n), rough * rough) * smith_g2(rough, cos_o, cos_i)
                                         / torch.clamp(4.0 * cos_o * cos_i, min=1e-8))[..., None]
    return torch.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def microfacet_pdf(n, wo, wi, rough):
    wm = normalize(wo + wi)
    return smith_g1(rough, dot(n, wo)) * ndf(dot(wm, n), rough * rough) \
        / torch.clamp(4.0 * dot(wo, n), min=1e-8)


def metallic_f(n, wo, wi, albedo, rough, metal):
    cos_o, cos_i = dot(n, wo), dot(n, wi)
    wm = normalize(wo + wi)
    d = ndf(dot(wm, n), rough * rough)
    g2 = smith_g2(rough, cos_o, cos_i)
    f0 = mix(torch.full_like(albedo, 0.08), albedo, metal[..., None])
    f = schlick(f0, dot(wo, wm))
    diff = (1.0 - metal)[..., None] * albedo * INV_PI
    spec = (d * g2 / torch.clamp(4.0 * cos_o * cos_i, min=1e-8))[..., None]
    val = mix(diff, spec.expand(diff.shape), f)
    return torch.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def metallic_pdf(n, wo, wi, rough, metal):
    wm = normalize(wo + wi)
    spec = smith_g1(rough, dot(n, wo)) * ndf(dot(wm, n), rough * rough) \
        / torch.clamp(4.0 * dot(wo, n), min=1e-8)
    return mix(dot(wi, n) * INV_PI, spec, 1.0 / (2.0 - metal))


def fresnel(c1, ior1, ior2):
    s1 = torch.sqrt(torch.clamp(1.0 - c1 * c1, min=0.0))
    s2 = s1 * ior1 / ior2
    c2 = torch.sqrt(torch.clamp(1.0 - s2 * s2, min=0.0))
    rpa = (ior1 * c2 - ior2 * c1) / (ior1 * c2 + ior2 * c1)
    rpe = (ior1 * c1 - ior2 * c2) / (ior1 * c1 + ior2 * c2)
    return torch.where(s2 > 1.0, 1.0, 0.5 * (rpa * rpa + rpe * rpe))


def scatter(mtype, albedo, rough, metal, ior, n, d, r):
    """(bsdf, pdf, dir) of each path's sampled lobe; lights keep their
    albedo with pdf 1."""
    bsdf, pdf, out = albedo.clone(), torch.ones_like(rough), torch.zeros_like(n)
    wo = -d

    def put(sel, b, p, w):
        nonlocal bsdf, pdf, out
        bsdf = torch.where(sel[..., None], b, bsdf)
        pdf = torch.where(sel, p, pdf)
        out = torch.where(sel[..., None], w, out)

    present = set(mtype.unique().tolist())
    if LAMBERTIAN in present:
        w = cosine_hemisphere(n, r[:, 0:2])
        put(mtype == LAMBERTIAN, albedo * INV_PI, dot(w, n) * INV_PI, w)
    if DIELECTRIC in present:
        entering = dot(d, n) < 0.0
        one = torch.ones_like(ior)
        i1, i2 = torch.where(entering, one, ior), torch.where(entering, ior, one)
        refl_p = r[:, 2] < fresnel(torch.abs(dot(d, n)), i1, i2)
        nf = torch.where((dot(d, n) < 0.0)[..., None], n, -n)
        refl = d - 2.0 * nf * dot(d, nf)[..., None]
        perp = (d - dot(d, nf)[..., None] * nf) * (i1 / i2)[..., None]
        refr = perp + (-torch.sqrt(torch.clamp(1.0 - dot(perp, perp), min=0.0))[..., None] * nf)
        w = torch.where(refl_p[..., None], refl, refr)
        b = albedo * torch.where(refl_p, 1.0, (i2 * i2) / (i1 * i1))[..., None]
        b = b / torch.clamp(torch.abs(dot(w, n)), min=1e-38)[..., None]
        put(mtype == DIELECTRIC, b, torch.ones_like(rough), w)
    if MICROFACET in present:
        wm = ggx_visible_normal(n, wo, rough, r[:, 0:2])
        w = d - 2.0 * dot(wm, d)[..., None] * wm
        bad = dot(w, n) * dot(wo, n) < 0.0
        b = torch.where(bad[..., None], 0.0, microfacet_f(n, wo, w, albedo, rough))
        p = torch.where(bad, 0.0, microfacet_pdf(n, wo, w, rough))
        put(mtype == MICROFACET, b, p, w)
    if METALLIC_WORKFLOW in present:
        pick = r[:, 2] < 1.0 / (2.0 - metal)
        wm = ggx_visible_normal(n, wo, rough * rough, r[:, 0:2])
        w = torch.where(pick[..., None], d - 2.0 * dot(wm, d)[..., None] * wm,
                        cosine_hemisphere(n, r[:, 0:2]))
        bad = (dot(wo, n) < 0.0) | (dot(w, n) < 0.0)
        b = torch.where(bad[..., None], 0.0, metallic_f(n, wo, w, albedo, rough, metal))
        p = torch.where(bad, 0.0, metallic_pdf(n, wo, w, rough, metal))
        put(mtype == METALLIC_WORKFLOW, b, p, w)
    return bsdf, pdf, out


def bsdf_eval(mtype, albedo, rough, metal, n, d, wi):
    out = torch.zeros_like(albedo)
    out = torch.where((mtype == LAMBERTIAN)[..., None], albedo * INV_PI, out)
    out = torch.where((mtype == MICROFACET)[..., None], microfacet_f(n, -d, wi, albedo, rough), out)
    return torch.where((mtype == METALLIC_WORKFLOW)[..., None],
                       metallic_f(n, -d, wi, albedo, rough, metal), out)


def pdf_eval(mtype, rough, metal, n, d, wi):
    out = torch.zeros_like(rough)
    out = torch.where(mtype == LAMBERTIAN, dot(wi, n) * INV_PI, out)
    out = torch.where(mtype == MICROFACET, microfacet_pdf(n, -d, wi, rough), out)
    return torch.where(mtype == METALLIC_WORKFLOW, metallic_pdf(n, -d, wi, rough, metal), out)


class Reference:
    """The scene on `device` in `dtype`, ready to trace paths;
    `env_importance` samples its environment map as a light under MIS."""

    def __init__(self, scene_path, device, dtype=torch.float32, resolution=None,
                 env_importance: bool = False):
        sc = load(scene_path, resolution)
        self.sc, self.device, self.dtype = sc, torch.device(device), dtype
        f = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
        self.xf, self.inv, self.invt = f(sc.xf), f(sc.inv), f(sc.invt)
        self.geom_mat = torch.as_tensor(sc.geom_mat, device=device)
        self.mat_type = torch.as_tensor(sc.mat_type, device=device)
        self.mat_albedo, self.mat_rough = f(sc.mat_albedo), f(sc.mat_rough)
        self.mat_metal, self.mat_ior = f(sc.mat_metal), f(sc.mat_ior)
        self.tri_v, self.tri_n = f(sc.tri_v), f(sc.tri_n)
        self.tri_geom = torch.as_tensor(sc.tri_geom, device=device)
        self.bvh = bvh_mod.build(sc.tri_v, device) if len(sc.tri_v) else None
        if self.bvh is not None and dtype != torch.float32:
            self.bvh.tri = self.bvh.tri.to(dtype)
            self.bvh.lo, self.bvh.hi = self.bvh.lo.to(dtype), self.bvh.hi.to(dtype)
        self.cam = {k: f(v) for k, v in sc.cam.items()}
        self.analytic = [(gi, g) for gi, g in enumerate(sc.geom_type) if g in (SPHERE, CUBE)]
        self.big = torch.finfo(dtype).max
        self.env = self.env_cdf = self.env_pdf = None
        self.env_nee = bool(env_importance) and sc.env is not None
        self.n_lights = len(sc.lights) + int(self.env_nee)
        if sc.env is not None:
            img = sc.env
            lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
            h = img.shape[0]
            wt = (lum * np.sin((0.5 + np.arange(h)) / h * np.pi)[:, None]).astype(np.float64)
            cdf = np.zeros(wt.size + 1, np.float64)
            np.cumsum(wt.reshape(-1), out=cdf[1:])
            cdf /= cdf[-1] if cdf[-1] > 0 else 1.0
            mean = wt.mean() if wt.mean() > 0 else 1.0
            self.env, self.env_cdf = f(img), f(cdf.astype(np.float32))
            self.env_pdf = f((wt / mean).astype(np.float32))

    # -- film ---------------------------------------------------------------
    def counters(self, swizzle: bool) -> torch.Tensor:
        """(W*H,) the RNG counter of each pixel: its index, or under the 32x32
        swizzle its lane (the lane l renders pixel argsort(key)[l])."""
        w, h = self.sc.width, self.sc.height
        idx = np.arange(w * h)
        if not swizzle:
            return torch.as_tensor(idx, device=self.device)
        x, y, bx = idx % w, idx // w, (w + 31) // 32
        key = ((y // 32) * bx + x // 32) * 1024 + (y % 32) * 32 + x % 32
        lane = np.empty_like(idx)
        lane[np.argsort(key, kind="stable")] = idx
        return torch.as_tensor(lane, device=self.device)

    def camera(self, key, iteration, counter, pixel):
        w, h = self.sc.width, self.sc.height
        r = rng.uniforms(key, iteration, 0, rng.STAGE_CAMERA, counter, 2, self.dtype)
        x, y = (pixel % w).to(self.dtype), (pixel // w).to(self.dtype)
        c = self.cam
        px = x + (r[:, 0] - 0.5) - w * 0.5
        py = y + (r[:, 1] - 0.5) - h * 0.5
        d = normalize(c["view"][None, :] - c["right"][None, :] * (c["pixel_length"][0] * px)[:, None]
                      - c["up"][None, :] * (c["pixel_length"][1] * py)[:, None])
        return c["position"].expand(counter.shape[0], 3).contiguous(), d

    # -- geometry -------------------------------------------------------------
    def _analytic(self, gi, gtype, o, d):
        """(valid, world t, world point, object normal) of object gi."""
        inv, tr = self.inv[gi], self.xf[gi]
        ox, oy, oz, dx, dy, dz = o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]
        rox = inv[0, 0] * ox + inv[0, 1] * oy + inv[0, 2] * oz + inv[0, 3]
        roy = inv[1, 0] * ox + inv[1, 1] * oy + inv[1, 2] * oz + inv[1, 3]
        roz = inv[2, 0] * ox + inv[2, 1] * oy + inv[2, 2] * oz + inv[2, 3]
        vx = inv[0, 0] * dx + inv[0, 1] * dy + inv[0, 2] * dz
        vy = inv[1, 0] * dx + inv[1, 1] * dy + inv[1, 2] * dz
        vz = inv[2, 0] * dx + inv[2, 1] * dy + inv[2, 2] * dz
        n2 = vx * vx + vy * vy + vz * vz
        s = torch.where(n2 > 0.0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0)
        rdx, rdy, rdz = vx * s, vy * s, vz * s
        if gtype == SPHERE:
            vdd = rox * rdx + roy * rdy + roz * rdz
            rad = vdd * vdd - ((rox * rox + roy * roy + roz * roz) - 0.25)
            root = torch.sqrt(torch.clamp(rad, min=0.0))
            t1, t2 = -vdd + root, -vdd - root
            valid = (rad >= 0.0) & ~((t1 < 0.0) & (t2 < 0.0))
            t_obj = torch.where((t1 > 0.0) & (t2 > 0.0), torch.minimum(t1, t2), torch.maximum(t1, t2))
        else:
            i1 = [(-0.5 - a) / b for a, b in ((rox, rdx), (roy, rdy), (roz, rdz))]
            i2 = [(0.5 - a) / b for a, b in ((rox, rdx), (roy, rdy), (roz, rdz))]
            g = [torch.minimum(a, b) for a, b in zip(i1, i2)]
            g = [torch.where(x > 0.0, x, -1e38) for x in g]
            tb = [torch.maximum(a, b) for a, b in zip(i1, i2)]
            tmin = torch.maximum(g[0], torch.maximum(g[1], g[2]))
            tmax = torch.minimum(tb[0], torch.minimum(tb[1], tb[2]))
            valid = (tmax >= tmin) & (tmax > 0.0)
            inside = tmin <= 0.0
            t_obj = torch.where(inside, tmax, tmin)
        px = rox + (t_obj - 1e-4) * rdx
        py = roy + (t_obj - 1e-4) * rdy
        pz = roz + (t_obj - 1e-4) * rdz
        wx = tr[0, 0] * px + tr[0, 1] * py + tr[0, 2] * pz + tr[0, 3]
        wy = tr[1, 0] * px + tr[1, 1] * py + tr[1, 2] * pz + tr[1, 3]
        wz = tr[2, 0] * px + tr[2, 1] * py + tr[2, 2] * pz + tr[2, 3]
        ex, ey, ez = wx - ox, wy - oy, wz - oz
        t = torch.sqrt(torch.clamp(ex * ex + ey * ey + ez * ez, min=0.0))
        if gtype == SPHERE:
            nrm = (px, py, pz)
        else:
            sg = [torch.where(b < a, 1.0, -1.0).to(self.dtype) for a, b in zip(i1, i2)]
            ax = torch.where(inside, tb[0] <= tmax, g[0] >= tmin)
            ay = ~ax & torch.where(inside, tb[1] <= tmax, g[1] >= tmin)
            sign = torch.where(ax, sg[0], torch.where(ay, sg[1], sg[2]))
            zero = torch.zeros_like(sign)
            nrm = (torch.where(ax, sign, zero), torch.where(ay, sign, zero),
                   torch.where(ax | ay, zero, sign))
        return valid, t, (wx, wy, wz), nrm

    def _analytic_closest(self, o, d):
        """(t, geom, point, normal) of each ray's nearest sphere or cube;
        t the largest float and geom -1 on a miss."""
        n = o.shape[0]
        t_min = torch.full((n,), self.big, dtype=self.dtype, device=self.device)
        geom = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        zero = torch.zeros((n,), dtype=self.dtype, device=self.device)
        w = [zero] * 3
        nc = [zero] * 3
        for gi, gtype in self.analytic:
            valid, t, wp, nrm = self._analytic(gi, gtype, o, d)
            better = valid & (t > 0.0) & (t < t_min)
            t_min = torch.where(better, t, t_min)
            geom = torch.where(better, gi, geom)
            w = [torch.where(better, a, b) for a, b in zip(wp, w)]
            nc = [torch.where(better, a, b) for a, b in zip(nrm, nc)]
        m = self.invt[geom.clamp(min=0)]
        vx = m[:, 0, 0] * nc[0] + m[:, 0, 1] * nc[1] + m[:, 0, 2] * nc[2]
        vy = m[:, 1, 0] * nc[0] + m[:, 1, 1] * nc[1] + m[:, 1, 2] * nc[2]
        vz = m[:, 2, 0] * nc[0] + m[:, 2, 1] * nc[1] + m[:, 2, 2] * nc[2]
        found = geom >= 0
        point = torch.stack([torch.where(found, a, 0.0) for a in w], 1)
        normal = torch.where(found[:, None], normalize(torch.stack([vx, vy, vz], 1)), 0.0)
        return t_min, geom, point, normal

    def analytic_closest(self, o, d):
        """The nearest sphere's or cube's t: the cap the triangle walk starts from."""
        return self._analytic_closest(o, d)[0]

    def closest(self, o, d):
        """(t, geom, tri, point, normal) of each ray's nearest hit; geom -1
        on a miss."""
        t_min, geom, point, normal = self._analytic_closest(o, d)
        tri = torch.full(geom.shape, -1, dtype=torch.int64, device=self.device)
        if self.bvh is None:
            return t_min, geom, tri, point, normal
        t_tri, tri, u, v = bvh_mod.closest(self.bvh, o, d, t_min)
        got = tri >= 0
        t_min = torch.where(got, t_tri, t_min)
        tv, tn = self.tri_v[tri.clamp(min=0)], self.tri_n[tri.clamp(min=0)]
        w0, uw, vw = (1.0 - u - v)[:, None], u[:, None], v[:, None]
        point = torch.where(got[:, None], w0 * tv[:, 0] + uw * tv[:, 1] + vw * tv[:, 2], point)
        normal = torch.where(got[:, None], w0 * tn[:, 0] + uw * tn[:, 1] + vw * tn[:, 2], normal)
        geom = torch.where(got, self.tri_geom[tri.clamp(min=0)], geom)
        return t_min, geom, tri, point, normal

    def analytic_occluded(self, ori, d, min_t):
        """Segments of length `min_t` a sphere or cube blocks."""
        occ = torch.zeros(min_t.shape, dtype=torch.bool, device=self.device)
        for gi, gtype in self.analytic:
            valid, t, _, _ = self._analytic(gi, gtype, ori, d)
            occ = occ | (valid & (t > 0.0) & (min_t - 1e-5 > t) & (torch.abs(t - min_t) > 1e-2))
        return occ

    def occluded(self, ori, d, des, enabled):
        """Segments ori -> des that a sphere or cube blocks, or on lanes
        `enabled` a triangle."""
        e = des - ori
        min_t = torch.sqrt(torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2], min=0.0))
        occ = self.analytic_occluded(ori, d, min_t)
        if self.bvh is not None:
            occ = occ | bvh_mod.occluded(self.bvh, ori, d, min_t, enabled & ~occ)
        return occ

    # -- environment ---------------------------------------------------------------
    def env_radiance(self, u, v):
        """(N, 3) bilinear radiance of the map at (u, v)."""
        h, w = self.env.shape[:2]
        x, y = u * float(w - 1), v * float(h - 1)
        fl_x, fl_y = torch.floor(x), torch.floor(y)
        lx, ly = fl_x.to(torch.int32), fl_y.to(torch.int32)
        ux = torch.where(x + 1.0 >= float(w), lx, lx + 1)
        uy = torch.where(y + 1.0 >= float(h), ly, ly + 1)
        fx, fy = (x - fl_x)[..., None], (y - fl_y)[..., None]
        tex = self.env.reshape(-1, 3)

        def at(ix, iy):
            return tex[torch.clamp(iy * w + ix, 0, h * w - 1).long()]

        p1 = at(lx, ly) * (1.0 - fx) + at(ux, ly) * fx
        p2 = at(lx, uy) * (1.0 - fx) + at(ux, uy) * fx
        return p1 * (1.0 - fy) + p2 * fy

    def env_sample(self, u1, u2, u3):
        """(dir, radiance, pdf per solid angle) of the map's importance
        sample: u1 picks the texel, u2 and u3 jitter within it."""
        h, w = self.env_pdf.shape
        idx = torch.clamp(torch.searchsorted(self.env_cdf, u1.contiguous(), right=True) - 1, 0, h * w - 1)
        row, col = idx // w, idx % w
        u = (col.to(self.dtype) + u2) / w
        v = (row.to(self.dtype) + u3) / h
        phi = TWO_PI * u
        elev = PI * (v - 0.5)
        cos_e = torch.cos(elev)
        d = torch.stack([cos_e * torch.cos(phi), torch.sin(elev), cos_e * torch.sin(phi)], dim=-1)
        pdf = self.env_pdf[row, col] / torch.clamp(2.0 * PI * PI * cos_e, min=1e-8)
        return d, self.env_radiance(u, v), pdf

    def env_pdf_of(self, d):
        """The pdf per solid angle of `env_sample` for unit directions `d`."""
        h, w = self.env_pdf.shape
        u, v = sphere_to_plane(d)
        col = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
        row = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
        cos_e = torch.sqrt(torch.clamp(1.0 - d[:, 1] * d[:, 1], min=1e-8))
        return self.env_pdf[row, col] / torch.clamp(2.0 * PI * PI * cos_e, min=1e-8)

    # -- lights ------------------------------------------------------------------
    def cone_sample(self, gi, p, xi):
        """(light point, pdf) of a cone sample toward sphere light gi."""
        vl = xform_point(self.inv[gi], p)
        c2r = normalize(-vl)
        tan, bit = onb(c2r)
        d2 = dot(vl, vl)
        cos_tm = torch.sqrt(torch.clamp(1.0 - 0.25 / torch.clamp(d2, min=1e-12), min=0.0))
        cos_t = (1.0 - xi[:, 0]) + xi[:, 0] * cos_tm
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = xi[:, 1] * TWO_PI
        dc = torch.sqrt(torch.clamp(d2, min=0.0))
        ds = dc * cos_t - torch.sqrt(torch.clamp(0.25 - dc * dc * sin_t * sin_t, min=0.0))
        sin_a = ds * sin_t / 0.5
        cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
        n_obj = (sin_a * torch.cos(phi))[..., None] * tan + (sin_a * torch.sin(phi))[..., None] * bit \
            + cos_a[..., None] * (-c2r)
        return xform_point(self.xf[gi], n_obj * 0.5), 1.0 / (TWO_PI * (1.0 - cos_tm))

    def _cone_pdf(self, gi, p):
        vl = xform_point(self.inv[gi], p)
        cos_tm = torch.sqrt(torch.clamp(1.0 - 0.25 / torch.clamp(dot(vl, vl), min=1e-12), min=0.0))
        return 1.0 / (TWO_PI * (1.0 - cos_tm))

    def light_sample(self, p, r, enabled):
        """(light point, emission, pdf; -1 when blocked) of one light per path;
        `r` holds the pick, the sample's two numbers and with the sky as a
        light its texel jitter's second."""
        lights = self.sc.lights
        n = p.shape[0]
        nl = float(self.n_lights)
        inv_l = float(np.float32(1.0) / np.float32(self.n_lights))
        lid = torch.clamp(r[:, 0] * nl, max=nl - 1.0).to(torch.int64)
        pos = torch.zeros((n, 3), dtype=self.dtype, device=self.device)
        pdf = torch.zeros((n,), dtype=self.dtype, device=self.device)
        emit = torch.zeros((n, 3), dtype=self.dtype, device=self.device)
        for li, (gi, gtype) in enumerate(lights):
            sel = lid == li
            emit = torch.where(sel[:, None], self.mat_albedo[self.geom_mat[gi]], emit)
            if gtype != SPHERE:
                continue  # cube lights have no sampling branch
            lp, lpdf = self.cone_sample(gi, p, r[:, 1:3])
            pos = torch.where(sel[:, None], lp, pos)
            pdf = torch.where(sel, lpdf * inv_l, pdf)
        if self.env_nee:
            sel = lid == len(lights)
            edir, ele, epdf = self.env_sample(r[:, 1], r[:, 2], r[:, 3])
            pos = torch.where(sel[:, None], p + edir * 1e7, pos)
            pdf = torch.where(sel, epdf * inv_l, pdf)
            emit = torch.where(sel[:, None], ele, emit)
        wi = normalize(pos - p)
        occ = self.occluded(p + 1e-5 * wi, wi, pos, (pdf > 0.0) & enabled)
        return pos, torch.where(occ[:, None], 0.0, emit), torch.where(occ, -1.0, pdf)

    def light_pdf(self, o, geom):
        inv_l = float(np.float32(1.0) / np.float32(max(self.n_lights, 1)))
        pdf = torch.full(geom.shape, -1.0, dtype=self.dtype, device=self.device)
        for gi, gtype in self.analytic:
            if gtype == SPHERE:
                pdf = torch.where(geom == gi, self._cone_pdf(gi, o) * inv_l, pdf)
        return pdf

    # -- paths -------------------------------------------------------------------
    def radiance(self, key, mis: bool, counter, pixel, iteration) -> torch.Tensor:
        """(N, 3) radiance of one path each: pixel `pixel` (index y*W + x),
        RNG counter `counter`, sample `iteration` (an int or (N,) int64)."""
        o, d = self.camera(key, iteration, counter, pixel)
        n = o.shape[0]
        color = torch.ones((n, 3), dtype=self.dtype, device=self.device)
        contrib = torch.zeros((n, 3), dtype=self.dtype, device=self.device)
        prev_pdf = torch.full((n,), -1.0, dtype=self.dtype, device=self.device)
        live = torch.arange(n, device=self.device)
        its = iteration if isinstance(iteration, torch.Tensor) else None
        for depth in range(self.sc.depth):
            if live.numel() == 0:
                break
            c = contrib[live]
            t, geom, tri, point, normal = self.closest(o, d)
            hit = geom >= 0
            mid = self.geom_mat[geom.clamp(min=0)]
            mtype = torch.where(hit, self.mat_type[mid], -1)
            albedo, rough = self.mat_albedo[mid], torch.clamp(self.mat_rough[mid], 1e-3, 1.0)
            metal, ior = torch.clamp(self.mat_metal[mid], 0.0, 1.0), self.mat_ior[mid]
            nrm = normalize(normal)
            is_light, is_delta = mtype == LIGHT, mtype == DIELECTRIC
            it = its[live] if its is not None else iteration
            sc_r = rng.uniforms(key, it, depth, rng.STAGE_SCATTER, counter[live], 3, self.dtype)
            bsdf, pdf, wdir = scatter(mtype, albedo, rough, metal, ior, nrm, d, sc_r)
            light_color = color * bsdf / torch.clamp(pdf, min=1e-38)[..., None]
            if mis:
                lp = self.light_pdf(o, geom)
                light_color = light_color * torch.where(prev_pdf > 0.0, power_heuristic(prev_pdf, lp),
                                                        1.0)[..., None]
            c = c + torch.where((hit & (pdf != 0.0) & is_light)[..., None], process_nan(light_color), 0.0)
            if self.env is not None:  # the sky along the rays that missed
                sky = color * self.env_radiance(*sphere_to_plane(d))
                if mis and self.env_nee:
                    ep = self.env_pdf_of(d) / float(self.n_lights)
                    sky = sky * torch.where(prev_pdf > 0.0, power_heuristic(prev_pdf, ep), 1.0)[..., None]
                c = c + torch.where(~hit[..., None], process_nan(sky), 0.0)
            cont = hit & (pdf != 0.0) & ~is_light
            if mis and self.n_lights:
                li_r = rng.uniforms(key, it, depth, rng.STAGE_LIGHT, counter[live], 3 + int(self.env_nee),
                                    self.dtype)
                on = cont & ~is_delta
                lpos, lemit, lpdf = self.light_sample(point, li_r, on)
                wi = normalize(lpos - point)
                w = power_heuristic(lpdf, pdf_eval(mtype, rough, metal, nrm, d, wi))
                nee = w[..., None] * color * lemit * bsdf_eval(mtype, albedo, rough, metal, nrm, d, wi) \
                    * (torch.clamp(dot(wi, nrm), min=0.0) / lpdf)[..., None]
                c = c + torch.where(on[..., None], process_nan(nee), 0.0)
            contrib[live] = c
            off = torch.where((dot(wdir, nrm) > 0.0)[..., None], nrm, -nrm)
            o = point + torch.where(is_delta[..., None], 1e-3 * off, 1e-4 * wdir)
            color = color * (bsdf * (torch.abs(dot(wdir, nrm)) / torch.clamp(pdf, min=1e-38))[..., None])
            prev_pdf = torch.where(is_delta, -1.0, pdf).to(self.dtype)
            d = wdir
            keep = torch.nonzero(cont).squeeze(1)
            live, o, d, color, prev_pdf = live[keep], o[keep], d[keep], color[keep], prev_pdf[keep]
        return contrib
