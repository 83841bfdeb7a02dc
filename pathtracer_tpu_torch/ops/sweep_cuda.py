"""The analytic sweep's kernels: S1 (closest hit) and S2 (shadow test) over a
scene's spheres and cubes.

The JAX package sweeps its analytic geoms in plain jnp
(`pathtracer_tpu/ops/traverse.py _geoms_closest` and the analytic loop of
`occlusion_test`); here the CUDA kernels live in `csrc/analytic_sweep.cu`.
As `ops/traverse_cuda.py` does for K1/K2, this module holds, for each:

- the wrapper (`geoms_closest`, `geoms_occluded`): on a CPU tensor it runs
  the plain PyTorch version; on a CUDA tensor it launches the kernel
  (building it on first use) or raises.  It never falls back.
- the plain PyTorch version (`*_plain`): the sweep on (N,) component
  columns, one geom after another in scene order, as the JAX package sweeps
  them.  The kernel keeps every operation of it in the same order, so the
  two agree bit for bit.

The wrappers launch through `ops/_build.py launch`, which counts S1's and
S2's launches in its table.  The kernels and their wrappers sit apart from
`ops/traverse.py`, as the walk kernels' do: one module per kernel source;
`ops/traverse.py` composes the queries and calls the wrappers only for a
scene with a sphere or a cube (`analytic_geoms`).
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.intersect import (
    mat_rows,
    normalize_cols,
    xform_point_cols,
    xform_vector_cols,
)
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.scene.parser import CUBE, SPHERE

FLT_MAX = 3.402823466e38  # the t of a miss


def analytic_geoms(static: SceneStatic) -> list:
    """(index, type) of the scene's spheres and cubes, in scene order."""
    return [(gi, gt) for gi, gt in enumerate(static.geom_types) if gt in (SPHERE, CUBE)]


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _geom_t_soa(flat: FlatScene, gi: int, gtype: int, ox, oy, oz, dx, dy, dz):
    """Column-form analytic test for one geom.

    Returns (valid, t_world, (px,py,pz) object hit, (wx,wy,wz) world hit,
    (nx,ny,nz) OBJECT normal) as (N,) columns, with the formulas of
    intersect.ray_sphere / ray_cube (pull-back and world-t quirk included).
    """
    inv = mat_rows(flat.geom_inv[gi])
    tr = mat_rows(flat.geom_transform[gi])
    rox, roy, roz = xform_point_cols(inv, ox, oy, oz)
    rdx, rdy, rdz = normalize_cols(*xform_vector_cols(inv, dx, dy, dz))
    if gtype == SPHERE:
        vdd = rox * rdx + roy * rdy + roz * rdz
        rad = vdd * vdd - ((rox * rox + roy * roy + roz * roz) - 0.25)
        root = torch.sqrt(torch.clamp(rad, min=0.0))
        t1, t2 = -vdd + root, -vdd - root
        valid = (rad >= 0.0) & ~((t1 < 0.0) & (t2 < 0.0))
        t_obj = torch.where((t1 > 0.0) & (t2 > 0.0),
                            torch.minimum(t1, t2), torch.maximum(t1, t2))
    else:
        i1x, i2x = (-0.5 - rox) / rdx, (0.5 - rox) / rdx
        i1y, i2y = (-0.5 - roy) / rdy, (0.5 - roy) / rdy
        i1z, i2z = (-0.5 - roz) / rdz, (0.5 - roz) / rdz
        gx = torch.minimum(i1x, i2x)
        gy = torch.minimum(i1y, i2y)
        gz = torch.minimum(i1z, i2z)
        gx = torch.where(gx > 0.0, gx, -1e38)
        gy = torch.where(gy > 0.0, gy, -1e38)
        gz = torch.where(gz > 0.0, gz, -1e38)
        tmin = torch.maximum(gx, torch.maximum(gy, gz))
        tmax = torch.minimum(torch.maximum(i1x, i2x),
                             torch.minimum(torch.maximum(i1y, i2y),
                                           torch.maximum(i1z, i2z)))
        valid = (tmax >= tmin) & (tmax > 0.0)
        t_obj = torch.where(tmin <= 0.0, tmax, tmin)
    px = rox + (t_obj - 1e-4) * rdx
    py = roy + (t_obj - 1e-4) * rdy
    pz = roz + (t_obj - 1e-4) * rdz
    wx, wy, wz = xform_point_cols(tr, px, py, pz)
    ex, ey, ez = wx - ox, wy - oy, wz - oz
    t = torch.sqrt(torch.clamp(ex * ex + ey * ey + ez * ez, min=0.0))
    if gtype == SPHERE:
        nx, ny, nz = px, py, pz
    else:
        # slab-entry axis basis * sign; argmax/argmin ties go to the FIRST axis
        sx = torch.where(i2x < i1x, 1.0, -1.0)
        sy = torch.where(i2y < i1y, 1.0, -1.0)
        sz = torch.where(i2z < i1z, 1.0, -1.0)
        inside = tmin <= 0.0
        tbx = torch.maximum(i1x, i2x)
        tby = torch.maximum(i1y, i2y)
        amin_x = gx >= tmin
        amin_y = ~amin_x & (gy >= tmin)
        amax_x = tbx <= tmax
        amax_y = ~amax_x & (tby <= tmax)
        ax_x = torch.where(inside, amax_x, amin_x)
        ax_y = torch.where(inside, amax_y, amin_y)
        sign = torch.where(ax_x, sx, torch.where(ax_y, sy, sz))
        nx = torch.where(ax_x, sign, 0.0)
        ny = torch.where(ax_y, sign, 0.0)
        nz = torch.where(ax_x | ax_y, 0.0, sign)
    return valid, t, (px, py, pz), (wx, wy, wz), (nx, ny, nz)


def geoms_closest_plain(flat: FlatScene, static: SceneStatic, o, d):
    """Plain PyTorch S1 (any device): the closest analytic geom per ray,
    (t, geom, world point, world normal); t FLT_MAX, geom -1 and zero rows
    where no sphere or cube is hit."""
    N = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zero = torch.zeros((N,), dtype=torch.float32, device=o.device)
    t_min = torch.full((N,), FLT_MAX, dtype=torch.float32, device=o.device)
    geom = torch.full((N,), -1, dtype=torch.int32, device=o.device)
    wx_w = wy_w = wz_w = zero
    nxc = nyc = nzc = zero

    sweep = analytic_geoms(static)
    for gi, gtype in sweep:
        valid, t, _, (wx, wy, wz), (nx, ny, nz) = _geom_t_soa(
            flat, gi, gtype, ox, oy, oz, dx, dy, dz
        )
        better = valid & (t > 0.0) & (t < t_min)
        t_min = torch.where(better, t, t_min)
        geom = torch.where(better, gi, geom)
        wx_w = torch.where(better, wx, wx_w)
        wy_w = torch.where(better, wy, wy_w)
        wz_w = torch.where(better, wz, wz_w)
        nxc = torch.where(better, nx, nxc)
        nyc = torch.where(better, ny, nyc)
        nzc = torch.where(better, nz, nzc)

    if not sweep:
        z3 = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
        return t_min, geom, z3, z3.clone()

    # the winner's world normal: ONE normalize(invt @ n_obj), with the
    # winner's invt entries gathered per ray (the values equal the winner's
    # matrix exactly, so this matches transforming per geom)
    invt = flat.geom_invt[geom.clamp(min=0).long()]  # (N, 4, 4)
    m3 = tuple(tuple(invt[:, i, j] for j in range(3)) for i in range(3))
    nwx, nwy, nwz = normalize_cols(*xform_vector_cols(m3, nxc, nyc, nzc))
    found = geom >= 0
    point = torch.stack(
        [torch.where(found, wx_w, 0.0), torch.where(found, wy_w, 0.0),
         torch.where(found, wz_w, 0.0)], dim=1,
    )
    normal = torch.stack(
        [torch.where(found, nwx, 0.0), torch.where(found, nwy, 0.0),
         torch.where(found, nwz, 0.0)], dim=1,
    )
    return t_min, geom, point, normal


def geoms_occluded_plain(flat: FlatScene, static: SceneStatic, ori, dir, min_t):
    """Plain PyTorch S2 (any device): (N,) bool, the lanes whose segment an
    analytic geom blocks in the window (t < minT-1e-5 && |t-minT| > 1e-2)."""
    occluded = torch.zeros((ori.shape[0],), dtype=torch.bool, device=ori.device)
    ox, oy, oz = ori[:, 0], ori[:, 1], ori[:, 2]
    dx, dy, dz = dir[:, 0], dir[:, 1], dir[:, 2]
    for gi, gtype in analytic_geoms(static):
        valid, t, _, _, _ = _geom_t_soa(flat, gi, gtype, ox, oy, oz, dx, dy, dz)
        blocked = valid & (t > 0.0) & (min_t - 1e-5 > t) & (torch.abs(t - min_t) > 1e-2)
        occluded = occluded | blocked
    return occluded


# ---------------------------------------------------------------------------
# wrappers


def _tables(flat: FlatScene) -> dict:
    """The geom tables the kernels read, checked: (G,) int32 types and three
    (G, 4, 4) float32 matrices, 16-byte aligned (a row is one load)."""
    tables = dict(geom_type=flat.geom_type, geom_inv=flat.geom_inv,
                  geom_transform=flat.geom_transform, geom_invt=flat.geom_invt)
    g = flat.geom_type.shape[0]
    for name, t in tables.items():
        want = (g,) if name == "geom_type" else (g, 4, 4)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    _build.check_aligned(**{k: v for k, v in tables.items() if k != "geom_type"})
    return tables


def geoms_closest(flat: FlatScene, static: SceneStatic, o, d):
    """S1: the closest analytic geom of N rays, (t, geom, point, normal) as
    `geoms_closest_plain` returns them.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _build.check_rays(o, d)
    if _build.device_type(o, "geoms_closest") == "cpu":
        return geoms_closest_plain(flat, static, o, d)
    f32, i32 = torch.float32, torch.int32
    tables = _tables(flat)
    _build.check_cuda_args(dict(**tables, o=o, d=d),
                           dict(geom_type=i32, geom_inv=f32, geom_transform=f32,
                                geom_invt=f32, o=f32, d=f32))
    n = o.shape[0]
    t = torch.empty((n,), dtype=f32, device=o.device)
    geom = torch.empty((n,), dtype=i32, device=o.device)
    point = torch.empty((n, 3), dtype=f32, device=o.device)
    normal = torch.empty((n, 3), dtype=f32, device=o.device)
    _build.launch("pt_sweep_closest", o.device, flat.geom_type, flat.geom_inv,
                  flat.geom_transform, flat.geom_invt, flat.geom_type.shape[0], o, d, t, geom,
                  point, normal, n)
    return t, geom, point, normal


def geoms_occluded(flat: FlatScene, static: SceneStatic, ori, dir, min_t):
    """S2: (N,) bool, the shadow rays an analytic geom blocks, as
    `geoms_occluded_plain` gives them.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _build.check_rays(ori, dir)
    if min_t.shape != ori.shape[:1]:
        raise ValueError(f"min_t must be (N,): {tuple(min_t.shape)} for {ori.shape[0]} rays")
    if _build.device_type(ori, "geoms_occluded") == "cpu":
        return geoms_occluded_plain(flat, static, ori, dir, min_t)
    f32 = torch.float32
    tables = _tables(flat)
    _build.check_cuda_args(dict(**tables, ori=ori, dir=dir, min_t=min_t),
                           dict(geom_type=torch.int32, geom_inv=f32, geom_transform=f32,
                                geom_invt=f32, ori=f32, dir=f32, min_t=f32))
    occ = torch.empty((ori.shape[0],), dtype=torch.bool, device=ori.device)
    _build.launch("pt_sweep_occluded", ori.device, flat.geom_type, flat.geom_inv,
                  flat.geom_transform, flat.geom_type.shape[0], ori, dir, min_t, occ,
                  ori.shape[0])
    return occ
