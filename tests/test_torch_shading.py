"""Materials and lights: the port against the JAX package on identical inputs.

Tolerance rtol=1e-5, atol=1e-6.  The GGX samplers get the same disc points
on both sides (see tests/test_torch_math.py): sqrt(1 - |p|^2) near the disc
rim magnifies a last-bit sin/cos difference past the tolerance.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import lights as jl
from pathtracer_tpu.ops import materials as jmat
from pathtracer_tpu.ops import math as jm
from pathtracer_tpu.ops.traverse import closest_hit as jax_closest_hit
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import (
    DIELECTRIC, LAMBERTIAN, LIGHT, METALLIC_WORKFLOW, MICROFACET, load_scene,
)
from pathtracer_tpu_torch.ops import lights as tl
from pathtracer_tpu_torch.ops import materials as tmat
from pathtracer_tpu_torch.ops import math as tm
from pathtracer_tpu_torch.ops.traverse import closest_hit as tclosest_hit
from pathtracer_tpu_torch.scene.flatscene import flat_from_arrays
from tests.test_torch_render import small_torus_scene
from tests.test_torch_traverse import port_static

N = 4000
RTOL, ATOL = 1e-5, 1e-6
TYPES = (LAMBERTIAN, METALLIC_WORKFLOW, DIELECTRIC, MICROFACET, LIGHT)


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a, np.float32)
    p = dict(
        type=np.asarray(TYPES, np.int32)[np.arange(N) % len(TYPES)],
        albedo=f32(g.uniform(0.05, 1.0, (N, 3))),
        roughness=f32(g.uniform(1e-3, 1.0, N)),
        metallic=f32(g.uniform(0.0, 1.0, N)),
        ior=f32(g.uniform(1.2, 1.8, N)),
    )
    n = _unit(g, N)
    wo = _unit(g, N)
    wi = _unit(g, N)
    rands = f32(g.uniform(0.0, 1.0, (N, 3)))
    return p, n, wo, wi, rands


def _params(p):
    jp = jmat.MatParams(
        type=jnp.asarray(p["type"]), albedo=jnp.asarray(p["albedo"]),
        roughness=jnp.asarray(p["roughness"]), metallic=jnp.asarray(p["metallic"]),
        ior=jnp.asarray(p["ior"]), emit=jnp.asarray(p["albedo"]),
        normal_map=jnp.zeros((N, 3)), has_normal_map=jnp.zeros((N,), bool),
    )
    tp = tmat.MatParams(
        type=torch.from_numpy(p["type"]), albedo=torch.from_numpy(p["albedo"]),
        roughness=torch.from_numpy(p["roughness"]), metallic=torch.from_numpy(p["metallic"]),
        ior=torch.from_numpy(p["ior"]), emit=torch.from_numpy(p["albedo"]),
        normal_map=torch.zeros((N, 3)),
    )
    return jp, tp


def _close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, **kw)


@pytest.fixture()
def same_disc(inputs, monkeypatch):
    r = inputs[4][:, 0:2].astype(np.float64)
    disc = np.stack([np.sqrt(r[:, 0]) * np.cos(2 * np.pi * r[:, 1]),
                     np.sqrt(r[:, 0]) * np.sin(2 * np.pi * r[:, 1])], -1).astype(np.float32)
    monkeypatch.setattr(jm, "sample_uniform_disc", lambda _: jnp.asarray(disc))
    monkeypatch.setattr(tm, "sample_uniform_disc", lambda _: torch.from_numpy(disc))


@pytest.mark.parametrize("present", [None, TYPES])
def test_scatter_sample(inputs, same_disc, present):
    p, n, wo, _, rands = inputs
    jp, tp = _params(p)
    want = jmat.scatter_sample(jp, jnp.asarray(n), jnp.asarray(wo), jnp.asarray(rands), present=present)
    got = tmat.scatter_sample(tp, torch.from_numpy(n), torch.from_numpy(wo), torch.from_numpy(rands),
                              present=present)
    for mt in TYPES:
        sel = p["type"] == mt
        _close(got.dir[sel], np.asarray(want.dir)[sel], err_msg=f"dir, type {mt}")
        _close(got.pdf[sel], np.asarray(want.pdf)[sel], err_msg=f"pdf, type {mt}")
        _close(got.bsdf[sel], np.asarray(want.bsdf)[sel], err_msg=f"bsdf, type {mt}")
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))


def test_bsdf_and_pdf_eval(inputs):
    p, n, wo, wi, _ = inputs
    jp, tp = _params(p)
    args_j = (jnp.asarray(n), jnp.asarray(wo), jnp.asarray(wi))
    args_t = (torch.from_numpy(n), torch.from_numpy(wo), torch.from_numpy(wi))
    _close(tmat.bsdf_eval(tp, *args_t), jmat.bsdf_eval(jp, *args_j))
    _close(tmat.pdf_eval(tp, *args_t), jmat.pdf_eval(jp, *args_j))


@pytest.fixture(scope="module")
def lit_box(tmp_path_factory):
    """The small torus box with the torus made a LIGHT: 576 triangle lights
    plus the sphere lamp."""
    path = small_torus_scene(tmp_path_factory.mktemp("lit"))
    text = path.read_text().replace("material glass", "material light")
    path.write_text(text)
    flat, static = build_flat_scene(load_scene(path))
    port = flat_from_arrays({k: np.asarray(v) for k, v in flat._asdict().items()}, "cpu",
                            static)
    return flat, static, port


def test_material_by_geom(lit_box):
    flat, static, port = lit_box
    geom = np.arange(-1, static.num_geoms, dtype=np.int32).repeat(3)
    want = jmat.material_by_geom(flat, static, jnp.asarray(geom), jnp.zeros((geom.size, 2)))
    got = tmat.material_by_geom(port, static, torch.from_numpy(geom), torch.zeros((geom.size, 2)))
    for name in tmat.MatParams._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)


def test_light_sample(lit_box):
    flat, static, port = lit_box
    assert static.num_lights > len(static.analytic_lights) > 0
    g = np.random.default_rng(11)
    pos = g.uniform([-4.5, 0.5, -4.5], [4.5, 9.0, 4.5], size=(N, 3)).astype(np.float32)
    rands = g.uniform(0, 1, size=(N, 3)).astype(np.float32)
    enabled = np.arange(N) % 6 != 0
    want = jl.light_sample(flat, static, jnp.asarray(pos), jnp.asarray(rands),
                           enabled=jnp.asarray(enabled))
    got = tl.light_sample(port, port_static(static), torch.from_numpy(pos),
                          torch.from_numpy(rands), enabled=torch.from_numpy(enabled))
    _close(got.pos, want.pos)
    np.testing.assert_array_equal(got.pdf.numpy() < 0, np.asarray(want.pdf) < 0)  # occlusion
    _close(got.pdf, want.pdf)
    _close(got.emit, want.emit)
    assert (got.pdf.numpy() < 0).any() and (got.pdf.numpy() > 0).any()


def test_light_pdf(lit_box):
    flat, static, port = lit_box
    g = np.random.default_rng(12)
    o = g.uniform([-4.5, 0.5, -4.5], [4.5, 9.0, 4.5], size=(N, 3)).astype(np.float32)
    d = _unit(g, N)
    hit = jax_closest_hit(flat, static, jnp.asarray(o), jnp.asarray(d))
    args = [o, np.array(hit.point), np.array(hit.normal), np.array(hit.tri), np.array(hit.geom)]
    want = jl.light_pdf(flat, static, *map(jnp.asarray, args))
    got = tl.light_pdf(port, static, *map(torch.from_numpy, args))
    _close(got, want)
    assert (np.asarray(hit.tri) >= 0).any()


def test_sphere_silhouettes_match_jax_op_by_op():
    """The first stage at which the Cornell render (tests/test_torch_cornell.py)
    leaves the JAX package's, with XLA's defaults: hits near a sphere's
    silhouette.  There vdd^2 - (|o|^2 - r^2) cancels, and its root moves t by
    up to 3e-4 for one ulp of the radicand.  The port rounds each operation
    of the source once; the JAX package does too when its ops run one by one
    (no jit), and the two agree at the shading tolerance.  Jitted, XLA fuses
    a*b - c into one multiply-add and rewrites 1/sqrt into rsqrt, and its t
    leaves the port's by far more than the tolerance on these rays (printed)."""
    scene = Path(__file__).resolve().parent.parent / "scenes" / "cornell_spheres.txt"
    flat, static = build_flat_scene(load_scene(scene))
    port = flat_from_arrays({k: np.asarray(v) for k, v in flat._asdict().items()}, "cpu",
                            static)
    g = np.random.default_rng(13)
    eye = np.array([0.0, 4.2, 9.5])
    spheres = [gi for gi, gt in enumerate(static.geom_types) if gt == 0]
    o, d = [], []
    for gi in spheres:
        xf = np.asarray(flat.geom_transform[gi], np.float64)
        c, r = xf[:3, 3], 0.5 * np.linalg.norm(xf[:3, 0])
        axis = (c - eye) / np.linalg.norm(c - eye)
        side = np.cross(axis, g.normal(size=(N // len(spheres), 3)))
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        # aimed within a few thousandths of the radius inside the rim
        tgt = c + side * r * g.uniform(0.995, 1.0, (len(side), 1))
        dd = tgt - eye
        o.append(np.tile(eye, (len(side), 1)))
        d.append(dd / np.linalg.norm(dd, axis=1, keepdims=True))
    o, d = (np.concatenate(x).astype(np.float32) for x in (o, d))
    with jax.disable_jit():
        want = jax_closest_hit(flat, static, jnp.asarray(o), jnp.asarray(d))
    got = tclosest_hit(port, static, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got.geom.numpy(), np.asarray(want.geom))
    assert np.isin(np.asarray(want.geom), spheres).mean() > 0.9
    for name in ("t", "point", "normal"):
        _close(getattr(got, name), getattr(want, name), err_msg=name)
    fused = jax.jit(lambda a, b: jax_closest_hit(flat, static, a, b))(jnp.asarray(o), jnp.asarray(d))
    print(f"jitted JAX against the port, max |dt| {float(np.abs(got.t.numpy() - np.asarray(fused.t)).max()):.3g}; "
          f"op by op {float(np.abs(got.t.numpy() - np.asarray(want.t)).max()):.3g}")
