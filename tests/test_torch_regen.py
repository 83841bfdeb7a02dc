"""Ray regeneration in the port (`RenderOptions.ray_regen`,
`pathtracer_tpu_torch/integrator/wavefront.py refill`): a batch of nk samples
per pixel in one persistent pool, a lane refilled with its pixel's next
sample when its path ends.

The meta column keys each lane's RNG on its own sample and depth, so a batch
integrates the classic renderer's sample set and traces its rays; only the
order of the float additions changes (a pixel's samples sum on its lane
before the one image add).  Held on the CPU, at 64x64, MIS unless said:

- port alone: a 1-sample batch bitwise equal to the classic iteration (on
  the lit 600-triangle soup of tests/test_regen.py, sorted and laddered, and
  on scenes/cornell_spheres.txt); `step(9)` with ray_regen=4 (a warm-up and
  two batches of 4), and tail batches (`step(2)` then `step(5)`), within the
  slice tolerance of the classic render (rtol 1e-4, atol 1e-5, 99.9% of
  pixels: tests/test_torch_render.py) with the rays counted exactly equal;
  the deferred env radiance cashed at refill, with and without env
  importance sampling, the same way; DIRECT_LI and show_normal ignore the
  option; the arithmetic swizzle inverse against `swizzle_map`;
- against the JAX package: scenes/cornell_spheres.txt (32x32) through the
  JAX Renderer's regeneration path, in a process of its own with XLA rounding
  each operation once (as tests/test_torch_cornell.py); the lit soup through
  `make_render_iteration(..., regen_k=3)` with the XLA walk and
  `packet_rows=1`, as tests/test_regen.py drives it, against the port's
  `render_iteration(..., nk=3)` on the same swizzled lanes.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.wavefront import CameraArrays as JaxCameraArrays
from pathtracer_tpu.integrator.wavefront import make_render_iteration
from pathtracer_tpu.scene.camera import derive_camera
from pathtracer_tpu.scene.flatscene import build_flat_scene as jax_build_flat_scene
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.utils import config as jax_config
from pathtracer_tpu.utils import rng as jax_rng
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.integrator.render import Renderer, swizzle_map
from pathtracer_tpu_torch.integrator.wavefront import render_iteration, swizzle_xy_from_lane
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_regen import lit_soup_scene
from tests.test_torch_cornell import XLA_ONE_ROUNDING
from tests.test_torch_render import ATOL, MIN_FRAC, RTOL
from tests.test_torch_schedule import env_ball_scene

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several files at once, and
    PyTorch's pool of one thread per core, once per worker, spends the
    cores waiting on each other (the port's ops are many and small)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)
CORNELL = ROOT / "scenes" / "cornell_spheres.txt"
RES = 64


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("regen")
    return {"lit_soup": lit_soup_scene(tmp, n=600, seed=11), "cornell_spheres": CORNELL,
            "env_ball": env_ball_scene(tmp)}


def renderer(scene, depth=4, mode=SampleMode.MIS, res=RES, **options) -> Renderer:
    r = Renderer(scene, opts=RenderOptions(sample_mode=mode, packet_rows=1, **options),
                 resolution=(res, res), trace_depth=depth, device="cpu")
    r.set_seed(0)
    return r


def assert_close(what, got, want):
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{what}: {int((~ok).sum())} of {ok.size} pixels outside tolerance, "
          f"{int((got == want).all(-1).sum())} bitwise equal")
    assert ok.mean() >= MIN_FRAC
    assert want.sum() > 1.0  # the scene is lit


@pytest.mark.parametrize("w,h", [(64, 64), (96, 32), (128, 96)])
def test_swizzle_inverse_matches_map(w, h):
    order = swizzle_map(w, h)  # lane -> pixel
    x, y = swizzle_xy_from_lane(torch.arange(w * h, dtype=torch.int32), w)
    np.testing.assert_array_equal(x.numpy(), (order % w).astype(np.float32))
    np.testing.assert_array_equal(y.numpy(), (order // w).astype(np.float32))


@pytest.mark.parametrize("scene", ["lit_soup", "cornell_spheres"])
def test_one_sample_batch_is_bitwise_classic(scenes, scene):
    a, b = renderer(scenes[scene], ray_regen=4), renderer(scenes[scene])
    assert a.regen_k == 4
    sa, sb = a.step(2), b.step(2)  # the warm-up and a batch of 1
    np.testing.assert_array_equal(a.hdr_sum(), b.hdr_sum())
    assert sa.rays_traced == sb.rays_traced


@pytest.mark.parametrize("scene", ["lit_soup", "cornell_spheres"])
def test_batches_match_classic(scenes, scene):
    a, b = renderer(scenes[scene], ray_regen=4), renderer(scenes[scene])
    sa, sb = a.step(9), b.step(9)  # a warm-up and two batches of 4
    assert a.iteration == b.iteration == 9
    assert_close(f"{scene} ray_regen=4", a.hdr_sum(), b.hdr_sum())
    assert sa.rays_traced == sb.rays_traced
    assert a.traced_depth > a.static.trace_depth  # the batch ran more laps than one sample


def test_partial_tail_batches(scenes):
    a, b = renderer(scenes["lit_soup"], ray_regen=4), renderer(scenes["lit_soup"])
    a.step(2)  # the warm-up and a batch of 1
    a.step(5)  # a batch of 4 and one of 1
    b.step(7)
    assert a.iteration == b.iteration == 7
    assert_close("lit_soup tail batches", a.hdr_sum(), b.hdr_sum())
    assert a.stats.rays_traced == b.stats.rays_traced


@pytest.mark.parametrize("env_importance", [False, True])
def test_env_inline_resolve(scenes, env_importance):
    """An env-missed lane cashes its deferred env radiance when it is
    refilled; the sums match the classic resolve after the last bounce."""
    a = renderer(scenes["env_ball"], ray_regen=3, env_importance=env_importance)
    b = renderer(scenes["env_ball"], env_importance=env_importance)
    a.step(7)
    b.step(7)
    assert_close(f"env_ball ray_regen=3 env_importance={env_importance}", a.hdr_sum(), b.hdr_sum())
    assert a.stats.rays_traced == b.stats.rays_traced


@pytest.mark.parametrize("mode,options", [(SampleMode.DIRECT_LI, {}), (SampleMode.MIS, {"show_normal": True})])
def test_single_bounce_paths_ignore_regen(scenes, mode, options):
    a = renderer(CORNELL, mode=mode, ray_regen=4, **options)
    b = renderer(CORNELL, mode=mode, **options)
    assert a.regen_k == 0
    a.step(3)
    b.step(3)
    np.testing.assert_array_equal(a.hdr_sum(), b.hdr_sum())


def test_cli_regen(tmp_path):
    out = tmp_path / "r.png"
    assert cli.main(["render", str(CORNELL), "--device", "cpu", "--res", "16x16", "--spp", "5",
                     "--depth", "3", "--mode", "mis", "--regen", "4", "-o", str(out)]) == 0
    assert out.stat().st_size > 0


_JAX_CORNELL = """
import sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from pathtracer_tpu.integrator.render import Renderer
from pathtracer_tpu.utils.config import RenderOptions, SampleMode
r = Renderer(sys.argv[2], opts=RenderOptions(sample_mode=SampleMode.MIS, ray_regen=4),
             resolution=(32, 32), trace_depth=4)
assert r._regen == 4
r.set_seed(0)
stats = r.step(5)
np.savez(sys.argv[3], img=r._unswizzle(np.asarray(r.img)).reshape(32, 32, 3),
         rays=int(stats.rays_traced))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_cornell(tmp_path_factory):
    """The JAX Renderer's render for test_cornell_matches_jax_regen, started
    in its own process with the module's first test, so that its compile
    runs beside the port's renders; yields a function that waits for it and
    returns (image, rays)."""
    out = tmp_path_factory.mktemp("regen_ref") / "ref.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_ROUNDING}".strip()}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CORNELL, str(ROOT), str(CORNELL), str(out)],
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(out) as f:
            return f["img"], int(f["rays"])

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_cornell_matches_jax_regen(jax_cornell):
    """The JAX Renderer's regeneration path (a warm-up and a batch of 4, at
    32x32, where XLA compiles it in half the time) against the port's."""
    port = renderer(CORNELL, ray_regen=4, res=32)
    stats = port.step(5)
    want, want_rays = jax_cornell()
    assert_close("cornell_spheres ray_regen=4 against JAX", port.hdr_sum(), want)
    assert stats.rays_traced == want_rays


def test_lit_soup_matches_jax_regen(scenes):
    """make_render_iteration(..., regen_k=3) (XLA walk, sort and ladder in
    tiles of 128 lanes) against the port's render_iteration(..., nk=3), both
    on the swizzled lanes of a 64x64 film (the arithmetic inverse)."""
    scene = scenes["lit_soup"]
    jscene = jax_load_scene(scene)
    jscene.camera.resolution = (RES, RES)
    jscene.trace_depth = 4
    jopts = jax_config.RenderOptions(sample_mode=jax_config.SampleMode.MIS,
                                     pallas_traversal=False, packet_rows=1)
    jflat, jstatic = jax_build_flat_scene(jscene, opts=jopts)
    cam = JaxCameraArrays(*[jnp.asarray(x) for x in derive_camera(jscene.camera).as_arrays()])
    order = swizzle_map(RES, RES)
    pixel_xy = tuple(jnp.asarray(a.astype(np.float32)) for a in (order % RES, order // RES))
    batch = jax.jit(make_render_iteration(jstatic, jopts, RES, RES, pixel_xy=pixel_xy, regen_k=3))
    want, want_rays, _ = batch(jflat, cam, jnp.zeros((RES * RES, 3), jnp.float32), jnp.int32(1),
                               jax_rng.base_key(0), jnp.int32(3))

    r = renderer(scene)
    got, rays, laps = render_iteration(r.flat, r.static, r.opts, r._cam_arrays(), r.key, 1,
                                       pixel_xy=r.pixel_xy, nk=3)
    assert min(laps) < RES * RES  # the ladder ran
    assert_close("lit_soup nk=3 against JAX", got.numpy(), np.asarray(want))
    assert abs(int(rays) - int(want_rays)) <= 1e-3 * int(want_rays)
