"""Texture sampling, textured materials and normal mapping: the port against
the JAX package on identical inputs, made from seeds with numpy.

The JAX functions run op by op (no jit), so XLA rounds each operation once,
as the port does.  Tolerances:
- the LDR and 1-channel samplers: bitwise;
- the RGBE sampler: bitwise against the JAX sampler with its exp2 scale
  replaced by the exact 2^(e-136) (the .hdr reader's decode, which the port
  keeps); against the JAX sampler as it is, rtol 5e-6: XLA's CPU exp2 is not
  exact for integral inputs (the worst ulp distance is printed);
- material_by_geom: bitwise;
- _apply_normal_map: atol 2.4e-7 (2 ulp of a unit vector's largest
  component): `jnp.cross` is one jitted computation, in which XLA contracts
  a*b - c*d into a multiply-add, and the JAX normalize's 1/sqrt lands 1 ulp
  off the port's on some lanes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator import wavefront as jwf
from pathtracer_tpu.ops import materials as jmat
from pathtracer_tpu.ops import texture as jtex
from pathtracer_tpu.ops.traverse import Hit as JaxHit
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import load_scene
from pathtracer_tpu_torch.integrator import wavefront as twf
from pathtracer_tpu_torch.ops import materials as tmat
from pathtracer_tpu_torch.ops import texture as ttex
from pathtracer_tpu_torch.ops.traverse import Hit
from pathtracer_tpu_torch.scene.flatscene import flat_from_arrays
from tools.make_texture_assets import ensure_texture_assets

ROOT = Path(__file__).resolve().parent.parent
# (offset, width, height) of three textures in one atlas; width 1 and height
# 1 take the edge rule on every tap
TEXTURES = ((0, 7, 5), (35, 16, 9), (179, 1, 4), (183, 6, 1))
P = 189
EXACT_SCALE = np.concatenate([[0.0], np.ldexp(1.0, np.arange(1, 256) - 136)]).astype(np.float32)
XLA_RGBE = jtex._unpack_u32_rgbe


def _atlas(kind: str, seed: int) -> np.ndarray:
    """(P,) uint32 texels: 8-bit RGB, and for "rgbe" an exponent byte in
    100..150 (0 on every 9th texel)."""
    g = np.random.default_rng(seed)
    words = g.integers(0, 1 << 24, size=P, dtype=np.uint64).astype(np.uint32)
    if kind == "rgbe":
        e = g.integers(100, 151, size=P).astype(np.uint32)
        e[::9] = 0
        words |= e << 24
    return words


def _uvs(seed: int, n: int = 3000) -> np.ndarray:
    """Random uv, plus 0, 1 and every texel centre of the widest texture on
    each axis, and their float32 neighbours in [0, 1] (0's neighbour
    2^-24: XLA's CPU flushes denormals to 0, the port keeps them)."""
    g = np.random.default_rng(seed)
    uv = g.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    edges = np.concatenate([np.arange(16) / 15.0, np.arange(9) / 8.0]).astype(np.float32)
    edges = np.concatenate([edges, np.nextafter(edges[edges > 0], np.float32(-1)),
                            np.nextafter(edges[(edges > 0) & (edges < 1)], np.float32(2)),
                            [2.0**-24]])
    grid = np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2)
    return np.concatenate([uv, grid]).astype(np.float32)


def _per_lane_meta(n: int, seed: int):
    """Per-lane (offset, width, height) arrays: each lane one of TEXTURES."""
    pick = np.random.default_rng(seed).integers(0, len(TEXTURES), size=n)
    meta = np.asarray(TEXTURES, np.int32)[pick]
    return meta[:, 0], meta[:, 1], meta[:, 2]


def _port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture
def exact_rgbe(monkeypatch):
    """The JAX RGBE decode with the exact scale in place of exp2, patched in
    (and returned)."""

    def decode(v):
        e = ((v >> jnp.uint32(24)) & jnp.uint32(255)).astype(jnp.int32)
        return jtex._unpack_rgb(v) * jnp.asarray(EXACT_SCALE)[e][..., None]

    monkeypatch.setattr(jtex, "_unpack_u32_rgbe", decode)
    return decode


def test_rgbe_scale_is_exact():
    e = torch.arange(256, dtype=torch.int32)
    np.testing.assert_array_equal(ttex._rgbe_scale(e).numpy(), EXACT_SCALE)
    xla = np.asarray(jnp.where(jnp.arange(256) == 0, 0.0,
                               jnp.exp2((jnp.arange(256) - 136).astype(jnp.float32))))
    ulps = np.abs(xla.view(np.int32).astype(np.int64) - EXACT_SCALE.view(np.int32))
    print(f"XLA exp2 against 2^(e-136): {int((ulps > 0).sum())} of 256 exponents differ, "
          f"at most {int(ulps[11:].max())} ulp for e >= 11; e <= 10 "
          f"{'flushed to 0' if not xla[1:11].any() else 'kept'}")


@pytest.mark.parametrize("per_lane", [False, True])
def test_ldr_sampler_bitwise(per_lane):
    atlas, uv = _atlas("ldr", 1), _uvs(2)
    for k, (off, w, h) in enumerate(TEXTURES):
        if per_lane:
            off, w, h = _per_lane_meta(len(uv), 3 + k)
        want = jtex.bilinear_sample_u32_meta(jnp.asarray(atlas), jnp.asarray(off) if per_lane else off,
                                             jnp.asarray(w) if per_lane else w,
                                             jnp.asarray(h) if per_lane else h, False, jnp.asarray(uv))
        got = ttex.bilinear_sample_u32_meta(
            _port(atlas), *(torch.from_numpy(np.asarray(a)) if per_lane else a for a in (off, w, h)),
            False, torch.from_numpy(uv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if not per_lane:
            assert np.asarray(want).max() > 0.9


@pytest.mark.parametrize("per_lane", [False, True])
def test_rgbe_sampler(exact_rgbe, monkeypatch, per_lane):
    atlas, uv = _atlas("rgbe", 4), _uvs(5)
    n = len(uv)
    top = 0.0
    for k, (off, w, h) in enumerate(TEXTURES):
        monkeypatch.setattr(jtex, "_unpack_u32_rgbe", exact_rgbe)
        if per_lane:
            off, w, h = _per_lane_meta(n, 6 + k)
            rgbe = np.random.default_rng(9 + k).uniform(size=n) < 0.7  # mixed formats
        args_j = ((jnp.asarray(off), jnp.asarray(w), jnp.asarray(h), jnp.asarray(rgbe))
                  if per_lane else (off, w, h, True))
        args_t = ((torch.from_numpy(off), torch.from_numpy(w), torch.from_numpy(h),
                   torch.from_numpy(rgbe)) if per_lane else (off, w, h, True))
        got = ttex.bilinear_sample_u32_meta(_port(atlas), *args_t, torch.from_numpy(uv)).numpy()
        want = np.asarray(jtex.bilinear_sample_u32_meta(jnp.asarray(atlas), *args_j, jnp.asarray(uv)))
        np.testing.assert_array_equal(got, want)
        top = max(top, float(got.max()))
        monkeypatch.setattr(jtex, "_unpack_u32_rgbe", XLA_RGBE)  # the JAX decode as it is
        as_is = np.asarray(jtex.bilinear_sample_u32_meta(jnp.asarray(atlas), *args_j, jnp.asarray(uv)))
        np.testing.assert_allclose(got, as_is, rtol=5e-6, atol=0.0)
    assert top > 1.0


def test_one_channel_sampler_bitwise():
    atlas, uv = _atlas("ldr", 10), _uvs(11)
    for k, (off, w, h) in enumerate(TEXTURES):
        want = jtex.bilinear_sample_u32_1ch_meta(jnp.asarray(atlas), off, w, h, jnp.asarray(uv))
        got = ttex.bilinear_sample_u32_1ch_meta(_port(atlas), off, w, h, torch.from_numpy(uv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off, w, h = _per_lane_meta(len(uv), 12)
    want = jtex.bilinear_sample_u32_1ch_meta(jnp.asarray(atlas), jnp.asarray(off), jnp.asarray(w),
                                             jnp.asarray(h), jnp.asarray(uv))
    got = ttex.bilinear_sample_u32_1ch_meta(_port(atlas), torch.from_numpy(off), torch.from_numpy(w),
                                            torch.from_numpy(h), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_words_bitwise(exact_rgbe):
    words = np.concatenate([_atlas("ldr", 13), _atlas("rgbe", 14),
                            # e = 10: the least exponent whose texels are normal floats
                            # (XLA's CPU flushes denormal results to 0)
                            np.array([0, 0xFFFFFFFF, 0x80FFFFFF, 0x0A010101], np.uint32)])
    for jf, tf in ((jtex._unpack_u32_ldr, ttex._unpack_u32_ldr),
                   (jtex._unpack_u32_rgbe, ttex._unpack_u32_rgbe),
                   (jtex._unpack_rgb, ttex._unpack_rgb)):
        np.testing.assert_array_equal(tf(_port(words)).numpy(), np.asarray(jf(jnp.asarray(words))))


@pytest.fixture(scope="module")
def texcube():
    """scenes/texcube.txt's tables from the JAX package, and the port's copy."""
    ensure_texture_assets()
    flat, static = build_flat_scene(load_scene(ROOT / "scenes" / "texcube.txt"))
    port = flat_from_arrays({k: np.asarray(v) for k, v in flat._asdict().items()}, "cpu",
                            static)
    return flat, static, port


def test_material_by_geom_with_uv(texcube):
    """Every geom (and misses) at seeded uv and at the corners: the albedo
    checker, the metallic and roughness maps and the constant materials."""
    flat, static, port = texcube
    assert static.tex_slots == (True, True, True, False)
    g = np.random.default_rng(15)
    geom = np.arange(-1, static.num_geoms, dtype=np.int32).repeat(600)
    uv = g.uniform(0.0, 1.0, (geom.size, 2)).astype(np.float32)
    uv[::50] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0], [0.5, 0.5]] * (geom.size // 250)
    want = jmat.material_by_geom(flat, static, jnp.asarray(geom), jnp.asarray(uv))
    got = tmat.material_by_geom(port, static, torch.from_numpy(geom), torch.from_numpy(uv))
    for name in tmat.MatParams._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    rough = got.roughness.numpy()
    assert len(np.unique(rough)) > 100  # the map, not a constant


def test_apply_normal_map():
    """Seeded hit normals, tangents and normal-map texels, with lanes whose
    tangent is zero (no texture coordinates) or whose texel is (0, 0, 1)."""
    g = np.random.default_rng(16)
    n = 5000
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    normal = f32(g.normal(size=(n, 3)))
    tangent = f32(g.normal(size=(n, 3)))
    tangent[::7] = 0.0
    nmap = f32(g.uniform(0.0, 1.0, (n, 3)))
    nmap[::5] = (0.5, 0.5, 1.0)
    zeros = np.zeros((n, 3), np.float32)
    jhit = JaxHit(
        *(jnp.asarray(a) for a in (np.zeros(n, np.float32), np.zeros(n, np.int32), np.zeros(n, np.int32),
                                    zeros, normal, np.zeros((n, 2), np.float32), tangent, zeros)))
    thit = Hit(*(torch.from_numpy(np.asarray(a)) for a in (
        np.zeros(n, np.float32), np.zeros(n, np.int32), np.zeros(n, np.int32), zeros, normal,
        np.zeros((n, 2), np.float32), tangent, zeros)))
    jp = jmat.MatParams(*([None] * 6), normal_map=jnp.asarray(nmap), has_normal_map=None)
    tp = tmat.MatParams(*([None] * 6), normal_map=torch.from_numpy(nmap))
    want = np.asarray(jwf._apply_normal_map(jhit, jp))
    got = twf._apply_normal_map(thit, tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=2.4e-7)
    mapped = ~np.isclose(got, normal / np.linalg.norm(normal, axis=1, keepdims=True), atol=1e-6).all(1)
    assert mapped[1::35].all() and not mapped[::5].any() and not mapped[::7].any()
