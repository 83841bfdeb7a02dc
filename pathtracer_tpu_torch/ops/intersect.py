"""Vectorized ray-primitive intersection tests.

Port of `pathtracer_tpu/ops/intersect.py`, with its conventions:

- the object-space direction is normalized before the analytic test, the
  hit is pulled back by 1e-4 along the object ray, and t is re-derived as
  the WORLD distance |hit - origin|;
- the cube slab test has no parallel-ray guard (division by 0 gives +-inf);
- Möller-Trumbore accepts t >= 0 with no epsilon.

Transforms are explicit multiply-adds, as in the JAX package, so both round
the same way.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.math import cross, dot, length, normalize


def xform_point(m, p):
    """(4,4) @ [p, 1] -> (..., 3)."""
    x = m[..., 0, 0] * p[..., 0] + m[..., 0, 1] * p[..., 1] + m[..., 0, 2] * p[..., 2] + m[..., 0, 3]
    y = m[..., 1, 0] * p[..., 0] + m[..., 1, 1] * p[..., 1] + m[..., 1, 2] * p[..., 2] + m[..., 1, 3]
    z = m[..., 2, 0] * p[..., 0] + m[..., 2, 1] * p[..., 1] + m[..., 2, 2] * p[..., 2] + m[..., 2, 3]
    return torch.stack([x, y, z], dim=-1)


def xform_vector(m, v):
    """(4,4) @ [v, 0] -> (..., 3)."""
    x = m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1] + m[..., 0, 2] * v[..., 2]
    y = m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1] + m[..., 1, 2] * v[..., 2]
    z = m[..., 2, 0] * v[..., 0] + m[..., 2, 1] * v[..., 1] + m[..., 2, 2] * v[..., 2]
    return torch.stack([x, y, z], dim=-1)


def xform_point_cols(m, px, py, pz):
    """Column form of xform_point: (N,) components in, 3 out; m is a nested
    3x4 tuple of scalars (see mat_rows) or of (N,) columns."""
    return (m[0][0] * px + m[0][1] * py + m[0][2] * pz + m[0][3],
            m[1][0] * px + m[1][1] * py + m[1][2] * pz + m[1][3],
            m[2][0] * px + m[2][1] * py + m[2][2] * pz + m[2][3])


def xform_vector_cols(m, vx, vy, vz):
    """Column form of xform_vector."""
    return (m[0][0] * vx + m[0][1] * vy + m[0][2] * vz,
            m[1][0] * vx + m[1][1] * vy + m[1][2] * vz,
            m[2][0] * vx + m[2][1] * vy + m[2][2] * vz)


def mat_rows(m):
    """(4,4) tensor -> nested tuple of 0-d tensors for the _cols helpers."""
    return tuple(tuple(m[i, j] for j in range(4)) for i in range(3))


def normalize_cols(vx, vy, vz, eps=0.0):
    """Column form of math.normalize (same formula, same rounding)."""
    n2 = vx * vx + vy * vy + vz * vz
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0)
    return vx * inv, vy * inv, vz * inv


def ray_sphere(transform, inverse_transform, inv_transpose, o, d):
    """Unit sphere (radius 0.5) in object space.
    Returns (valid, t, point, normal, outside); t is the world distance."""
    ro = xform_point(inverse_transform, o)
    rd = normalize(xform_vector(inverse_transform, d))

    vdd = dot(ro, rd)
    radicand = vdd * vdd - (dot(ro, ro) - 0.25)
    has_root = radicand >= 0.0
    root = torch.sqrt(torch.clamp(radicand, min=0.0))
    t1 = -vdd + root
    t2 = -vdd - root

    both_neg = (t1 < 0.0) & (t2 < 0.0)
    both_pos = (t1 > 0.0) & (t2 > 0.0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    outside = both_pos
    valid = has_root & ~both_neg

    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    point = xform_point(transform, p_obj)
    normal = normalize(xform_vector(inv_transpose, p_obj))
    t = length(point - o)
    return valid, t, point, normal, outside


def ray_cube(transform, inverse_transform, inv_transpose, o, d):
    """Axis-aligned unit cube [-0.5, 0.5]^3 in object space.
    Returns (valid, t, point, normal, outside); t is the world distance."""
    ro = xform_point(inverse_transform, o)
    rd = normalize(xform_vector(inverse_transform, d))

    t1 = (-0.5 - ro) / rd
    t2 = (0.5 - ro) / rd
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    n_sign = torch.where(t2 < t1, 1.0, -1.0)

    # tmin = max over axes of ta, counting only axes with ta > 0 (first
    # index wins ties, like jnp.argmax/argmin)
    ta_gated = torch.where(ta > 0.0, ta, -1e38)
    tmin, tmin_axis = _max_first(ta_gated)
    tmax, tmax_axis = _max_first(-tb)
    tmax = -tmax

    hit = (tmax >= tmin) & (tmax > 0.0)
    inside = tmin <= 0.0
    t_obj = torch.where(inside, tmax, tmin)
    axis = torch.where(inside, tmax_axis, tmin_axis)
    outside = hit & ~inside

    sign = torch.gather(n_sign, -1, axis[..., None])
    n_obj = torch.nn.functional.one_hot(axis, 3).to(ro.dtype) * sign

    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    point = xform_point(transform, p_obj)
    normal = normalize(xform_vector(inv_transpose, n_obj))
    t = length(point - o)
    return hit, t, point, normal, outside


def _max_first(x):
    """(max, index of its first occurrence) over the last axis of size 3."""
    best, idx = x[..., 0], torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for k in (1, 2):
        take = x[..., k] > best
        best = torch.where(take, x[..., k], best)
        idx = torch.where(take, k, idx)
    return best, idx


def ray_triangle(v0, v1, v2, o, d):
    """Möller-Trumbore.  Returns (hit, t, u, v) with
    hitpoint = (1-u-v)*v0 + u*v1 + v*v2."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)

    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det

    hit = (det != 0.0) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
    return hit, t, u, v


def ray_aabb(pmin, pmax, o, d):
    """Slab AABB test returning (hit, t_enter): hit iff tEnter <= tExit and
    tExit > 0.  Zero direction components fall back to an origin-containment
    check on that axis."""
    inv = 1.0 / d
    lo = (pmin - o) * inv
    hi = (pmax - o) * inv
    tmin = torch.minimum(lo, hi)
    tmax = torch.maximum(lo, hi)

    zero = d == 0.0
    inside_axis = (o >= pmin) & (o <= pmax)
    inf = float("inf")
    tmin = torch.where(zero, torch.where(inside_axis, -inf, inf), tmin)
    tmax = torch.where(zero, torch.where(inside_axis, inf, -inf), tmax)

    t_enter = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    t_exit = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    hit = (t_enter <= t_exit) & (t_exit > 0.0)
    return hit, t_enter
