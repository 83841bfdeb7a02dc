"""Environment maps: sphere_to_plane, env importance sampling, the env as a
light in NEE and MIS, and the fourth light uniform, the port against the JAX
package on identical inputs made from seeds with numpy; then a furnace on
the port alone.

The JAX functions run op by op (no jit).  Tolerances, where not bitwise:
- uv, directions, pdfs: rtol 2e-6, atol 2.4e-7 (XLA's atan2, cos and sin
  may land 1 ulp off PyTorch's, and the pdf divides by a cosine);
- radiance: rtol 5e-6 (the RGBE scale: XLA's exp2 is not exact for
  integral inputs, tests/test_torch_texture.py; the port decodes exactly);
- a sphere lamp's cone pdf: its inverse 2 pi (1 - cos theta_max) within
  2 pi * 4 * 2^-24 (4 ulp of a cosine near 1, which the subtraction
  cancels).
"""

import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import envmap as jenv
from pathtracer_tpu.ops import lights as jl
from pathtracer_tpu.ops import math as jm
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import load_scene
from pathtracer_tpu.utils import rng as jrng
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.ops import envmap as tenv
from pathtracer_tpu_torch.ops import lights as tl
from pathtracer_tpu_torch.ops import math as tm
from pathtracer_tpu_torch.scene.flatscene import flat_from_arrays
from pathtracer_tpu_torch.utils import rng as trng
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from pathtracer_tpu_torch.utils.image_io import write_hdr
from tests.test_torch_traverse import port_static
from tools.make_texture_assets import ensure_texture_assets

ROOT = Path(__file__).resolve().parent.parent
N = 6000
RTOL, ATOL, LE_RTOL = 2e-6, 2.4e-7, 5e-6
TWO_PI_ULP4 = 2 * np.pi * 4 * 2.0**-24


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _tables(path):
    flat, static = build_flat_scene(load_scene(path))
    port = flat_from_arrays({k: np.asarray(v) for k, v in flat._asdict().items()}, "cpu",
                            static)
    return flat, static, port


@pytest.fixture(scope="module")
def envtorus():
    """scenes/envtorus.txt's tables: the 2048 x 1024 sky, no other light."""
    ensure_texture_assets()
    return _tables(ROOT / "scenes" / "envtorus.txt")


@pytest.fixture(scope="module")
def lit_envtorus(tmp_path_factory, envtorus):
    """envtorus with a sphere lamp: lights 0 (the lamp) and 1 (the sky)."""
    text = (ROOT / "scenes" / "envtorus.txt").read_text()
    text = text.replace("assets/", str(ROOT / "scenes" / "assets") + "/")
    text = text.replace("MATERIAL gold", textwrap.dedent("""\
        MATERIAL light
        TYPE\tLight
        ALBEDO      5 5 5
        METALLIC    0
        ROUGHNESS   0
        IOR         0

        MATERIAL gold"""))
    text += textwrap.dedent("""
        OBJECT lamp
        sphere
        material light
        TRANS       1.5 4 2
        ROTAT       0 0 0
        SCALE       1 1 1
        """)
    path = tmp_path_factory.mktemp("litenv") / "litenv.txt"
    path.write_text(text)
    return _tables(path)


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, **kw)


def test_sphere_to_plane():
    g = np.random.default_rng(20)
    d = np.concatenate([_unit(g, N), np.eye(3, dtype=np.float32), -np.eye(3, dtype=np.float32),
                        np.array([[1, 0, -1e-30], [0, 0, 0]], np.float32)])
    want = np.asarray(jm.sphere_to_plane(jnp.asarray(d)))
    got = tm.sphere_to_plane(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    print(f"sphere_to_plane: {int((got == want).all(1).sum())} of {len(d)} bitwise equal")


def test_sample_env(envtorus):
    """Seeded uniforms, and u1 equal to CDF entries: at the first sky
    texel, on the plateau of the zero rows below the horizon (u1 = 0) and
    of float32-equal neighbours, at the sun's jumps, and at 1 - 2^-24."""
    flat, static, port = envtorus
    cdf = np.asarray(flat.env_flat_cdf)
    g = np.random.default_rng(21)
    flat_runs = np.nonzero(cdf[1:] == cdf[:-1])[0]
    jumps = np.argsort(np.diff(cdf))[-50:]
    picks = np.concatenate([g.integers(0, cdf.size - 1, 500), flat_runs[:: max(len(flat_runs) // 300, 1)],
                            jumps, np.searchsorted(cdf, 0.0, side="right") + np.arange(-2, 3)])
    u1 = np.concatenate([g.uniform(0, 1, N), cdf[picks], [0.0, np.float32(1 - 2**-24)]]).astype(np.float32)
    u1 = np.clip(u1, 0.0, np.float32(1 - 2**-24))
    u2, u3 = (g.uniform(0, 1, u1.size).astype(np.float32) for _ in range(2))
    assert flat_runs.size > 0 and (cdf == 0.0).sum() > flat.env_pdf.shape[1]  # plateaus
    want = jenv.sample_env(flat, static, *(jnp.asarray(a) for a in (u1, u2, u3)))
    got = tenv.sample_env(port, static, *(torch.from_numpy(a) for a in (u1, u2, u3)))
    _close(got[0], want[0], err_msg="direction")
    _close(got[1], want[1], rtol=LE_RTOL, atol=0.0, err_msg="radiance")
    _close(got[2], want[2], err_msg="pdf")
    assert (got[2].numpy() > 0).all() and (got[0][:, 1].numpy() >= 0).all()  # never below the horizon


def test_env_pdf(envtorus):
    flat, static, port = envtorus
    g = np.random.default_rng(22)
    d = np.concatenate([_unit(g, N), np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0]], np.float32)])
    want = np.asarray(jenv.env_pdf(flat, static, jnp.asarray(d)))
    got = tenv.env_pdf(port, static, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[d[:, 1] < 0] == 0).all() and (got[d[:, 1] > 0.01] > 0).all()


@pytest.mark.parametrize("which", ["envtorus", "lit_envtorus"])
def test_light_sample_with_env(which, request):
    """NEE with the env as light L of L + 1: the sky alone, and the sky
    beside a sphere lamp; the shadow rays run through the plain K2 walk."""
    flat, static, port = request.getfixturevalue(which)
    g = np.random.default_rng(23)
    pos = g.uniform([-2.0, 0.01, -2.0], [2.0, 3.0, 2.0], size=(N, 3)).astype(np.float32)
    rands = g.uniform(0, 1, size=(N, 4)).astype(np.float32)
    enabled = np.arange(N) % 5 != 0
    want = jl.light_sample(flat, static, jnp.asarray(pos), jnp.asarray(rands),
                           include_env=True, enabled=jnp.asarray(enabled))
    got = tl.light_sample(port, port_static(static), torch.from_numpy(pos),
                          torch.from_numpy(rands), enabled=torch.from_numpy(enabled),
                          include_env=True)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=RTOL, atol=5.0)  # 1e7 out
    np.testing.assert_array_equal(got.pdf.numpy() < 0, np.asarray(want.pdf) < 0)  # occlusion
    _close(got.emit, want.emit, rtol=LE_RTOL, atol=0.0)
    occluded = got.pdf.numpy() < 0
    assert occluded.any() and (~occluded).any()
    lamp = np.linalg.norm(got.pos.numpy(), axis=1) < 1e3
    _close(got.pdf[~lamp], np.asarray(want.pdf)[~lamp])
    if static.num_lights:
        assert lamp.any() and (~lamp).any()
        # the lamp's cone pdf is 1 / (2 pi (1 - cos theta_max)): 1 - cos
        # cancels, so it is held as 2 pi (1 - cos theta_max), to 4 ulp of a
        # cosine near 1
        lit = lamp & ~occluded
        np.testing.assert_allclose(1.0 / got.pdf.numpy()[lit], 1.0 / np.asarray(want.pdf)[lit],
                                   rtol=0.0, atol=TWO_PI_ULP4)


@pytest.mark.parametrize("which", ["envtorus", "lit_envtorus"])
def test_light_pdf_with_env(which, request):
    flat, static, port = request.getfixturevalue(which)
    g = np.random.default_rng(24)
    n = 2000
    args = [g.uniform(-2, 2, (n, 3)), g.uniform(-2, 2, (n, 3)), _unit(g, n),
            np.where(np.arange(n) % 3 == 0, 5, -1), np.arange(n) % (static.num_geoms + 1) - 1]
    args = [np.asarray(a, np.float32 if i < 3 else np.int32) for i, a in enumerate(args)]
    want = np.asarray(jl.light_pdf(flat, static, *map(jnp.asarray, args), include_env=True))
    got = tl.light_pdf(port, static, *map(torch.from_numpy, args), include_env=True).numpy()
    sph = (args[4] == static.analytic_lights[0][1]) if static.num_lights else np.zeros(n, bool)
    _close(torch.from_numpy(got[~sph]), want[~sph])
    if static.num_lights:
        # as in test_light_sample_with_env, the cone pdf's inverse, here
        # (L + 1) 2 pi (1 - cos theta_max)
        np.testing.assert_array_equal(got[sph] > 0, want[sph] > 0)
        on = sph & (want > 0)
        assert on.any()
        np.testing.assert_allclose(1.0 / got[on], 1.0 / want[on], rtol=0.0,
                                   atol=(static.num_lights + 1) * TWO_PI_ULP4)
        # 1 / (L + 1) on the sphere, not 1 / L
        alone = tl.light_pdf(port, static, *map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got[sph] * 2, alone[sph], rtol=1e-6)


def test_light_uniforms_four_columns():
    """The light stage draws 4 columns with env importance: bitwise the JAX
    package's, and its first 3 columns are the 3-column draw, in both."""
    pix = np.random.default_rng(25).integers(0, 2**20, size=5000).astype(np.int32)
    a3, a4 = (np.asarray(jrng.pixel_uniforms(jrng.base_key(9), 3, 2, jrng.STAGE_LIGHT, jnp.asarray(pix), c))
              for c in (3, 4))
    b3, b4 = (trng.pixel_uniforms(trng.base_key(9), 3, 2, trng.STAGE_LIGHT, torch.from_numpy(pix), c).numpy()
              for c in (3, 4))
    np.testing.assert_array_equal(b4.view(np.uint32), a4.view(np.uint32))
    np.testing.assert_array_equal(b4[:, :3], b3)
    np.testing.assert_array_equal(a4[:, :3], a3)


@pytest.mark.parametrize("env_importance", [False, True])
def test_furnace(tmp_path, env_importance):
    """A white sky (radiance 1) around a white Lambertian sphere: every path
    ends in the sky with throughput 1, so the image is 1 wherever the
    estimator is unbiased; with env importance the sky is also a light,
    MIS-weighted against the BSDF.  The port's twin of
    tests/test_envmap.py::test_furnace_with_env_importance."""
    write_hdr(tmp_path / "white.hdr", np.ones((16, 32, 3), np.float32))
    scene = tmp_path / "furnace.txt"
    scene.write_text(textwrap.dedent(f"""
        MATERIAL white
        TYPE\tLambertian
        ALBEDO      1 1 1
        METALLIC    0
        ROUGHNESS   0
        IOR         0

        ENV {tmp_path / 'white.hdr'}

        CAMERA
        RES         32 32
        FOVY        45
        ITERATIONS  10
        DEPTH       32
        FILE        f
        EYE         0 0 5
        LOOKAT      0 0 0
        UP          0 1 0

        OBJECT ball
        sphere
        material white
        TRANS       0 0 0
        ROTAT       0 0 0
        SCALE       2 2 2
        """))
    r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS, tonemapping=False,
                                           env_importance=env_importance), device="cpu")
    r.step(40)
    img = r.hdr_sum() / r.iteration
    print(f"furnace, env_importance={env_importance}: mean {img.mean():.4f}")
    np.testing.assert_allclose(img.mean(), 1.0, atol=0.04)
