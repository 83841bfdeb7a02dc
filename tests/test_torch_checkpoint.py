"""Checkpoint/resume of the port's Renderer, and its checkpoints against the
JAX package's: the same `.npz` format (keys img, iteration, theta, phi,
meta), the same five guards with the same messages, so that a checkpoint
written by either package resumes in the other.

The scene is the 576-triangle torus box of tests/test_torch_render.py (the
32x32 swizzle is on for it), at 32x32, depth 4, MIS.  A resumed render is
bitwise equal to an uninterrupted one in the same package; a JAX
checkpoint resumed by the port is held to JAX's uninterrupted render with
the slice tolerance (rtol 1e-4, atol 1e-5, 99.9% of the pixels).
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.render import Renderer as JaxRenderer
from pathtracer_tpu.utils import config as jax_config
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_render import ATOL, MIN_FRAC, RTOL, small_torus_scene

RES, DEPTH = (32, 32), 4


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads (see tests/test_torch_schedule.py)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return small_torus_scene(tmp_path_factory.mktemp("ckpt"))


def port(scene, mode=SampleMode.MIS, res=RES, devices=None, **options):
    return Renderer(scene, opts=RenderOptions(sample_mode=mode, **options), resolution=res,
                    trace_depth=DEPTH, devices=devices, device="cpu")


def jax_renderer(scene):
    return JaxRenderer(scene, opts=jax_config.RenderOptions(
        sample_mode=jax_config.SampleMode.MIS, iters_per_dispatch=1),
        resolution=RES, trace_depth=DEPTH)


@pytest.mark.parametrize("swizzle", [True, False])
def test_round_trip_bitwise(scene, tmp_path, swizzle):
    """Save after 2 spp, render 2 more; a new renderer loads the file and
    renders 2: the HDR sums are bitwise equal, the rays and camera too."""
    a = port(scene, swizzle=swizzle)
    assert (a.pixel_order is not None) == swizzle
    a.set_seed(3)
    a.step(2)
    a.save_checkpoint(tmp_path / "ck.npz")
    rays0 = a.stats.rays_traced
    a.step(2)
    b = port(scene, swizzle=swizzle)
    b.set_seed(3)
    b.load_checkpoint(tmp_path / "ck.npz")
    assert b.iteration == 2
    b.step(2)
    assert b.iteration == a.iteration == 4
    np.testing.assert_array_equal(b.hdr_sum(), a.hdr_sum())
    assert b.stats.rays_traced == a.stats.rays_traced - rays0
    assert (b.camera.theta, b.camera.phi) == (a.camera.theta, a.camera.phi)
    data = np.load(tmp_path / "ck.npz")
    assert sorted(data.files) == ["img", "iteration", "meta", "phi", "theta"]
    assert data["img"].dtype == np.float32 and data["img"].shape == (RES[0] * RES[1], 3)


GUARDS = {
    "resolution": (dict(res=(16, 32)), "checkpoint resolution mismatch"),
    "pixel order": (dict(swizzle=False), r"checkpoint pixel-order mismatch \(saved with a "
                                         r"different swizzle setting\)"),
    "sample mode": (dict(mode=SampleMode.BSDF), r"checkpoint sample-mode mismatch \(saved mode "
                                                r"2, current 0\)"),
    "seed": (dict(seed=5), r"checkpoint RNG-seed mismatch \(saved seed 0, current 5\)"),
    # a sharded renderer has no swizzle: the one-device file is saved without it
    "devices": (dict(devices=2, swizzle=False), r"checkpoint device-count mismatch \(saved 1, "
                                                r"current 2\) — the lane padding differs"),
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_guards_raise_the_jax_message(scene, tmp_path, guard):
    """Each guard raises the JAX package's ValueError, from the port's load
    and from the JAX package's on the same file."""
    kw, message = GUARDS[guard]
    saved = port(scene, swizzle=guard != "devices")
    saved.step(1)
    saved.save_checkpoint(tmp_path / "ck.npz")
    kw = dict(kw)
    seed = kw.pop("seed", 0)
    r = port(scene, **kw)
    r.set_seed(seed)
    with pytest.raises(ValueError, match=message):
        r.load_checkpoint(tmp_path / "ck.npz")
    if guard in ("seed", "sample mode"):
        j = JaxRenderer(scene, opts=jax_config.RenderOptions(
            sample_mode=jax_config.SampleMode(int(r.opts.sample_mode))), resolution=RES,
            trace_depth=DEPTH)
        j.set_seed(seed)
        with pytest.raises(ValueError, match=message):
            j.load_checkpoint(tmp_path / "ck.npz")


def _close(got, want):
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{int((~ok).sum())} of {ok.size} pixels outside tolerance, "
          f"{int((got == want).all(-1).sum())} bitwise equal")
    assert ok.mean() >= MIN_FRAC
    assert want.mean() > 0


def test_jax_checkpoint_resumes_in_the_port(scene, tmp_path):
    """The JAX package renders 2 spp and saves; the port loads the file and
    renders 1 more: within the slice tolerance of JAX's uninterrupted 3."""
    j = jax_renderer(scene)
    j.step(2)
    j.save_checkpoint(tmp_path / "jax.npz")
    j.step(1)
    want = j._unswizzle(np.asarray(j.img)).reshape(RES[1], RES[0], 3)

    r = port(scene)
    r.load_checkpoint(tmp_path / "jax.npz")
    assert r.iteration == 2
    r.step(1)
    assert r.iteration == 3
    _close(r.hdr_sum(), want)


def test_port_checkpoint_loads_in_jax(scene, tmp_path):
    """The port's checkpoint loads in the JAX package: the same accumulator
    bit for bit, the same iteration and orbit; a step on each from there
    agrees within the slice tolerance."""
    r = port(scene)
    r.step(2)
    r.set_orbit(10.0, -20.0)  # a new orbit restarts accumulation
    r.step(2)
    r.save_checkpoint(tmp_path / "port.npz")
    j = jax_renderer(scene)
    j.load_checkpoint(tmp_path / "port.npz")
    assert j.iteration == 2
    np.testing.assert_array_equal(np.asarray(j.img), r.img.numpy())
    assert (j.camera.theta, j.camera.phi) == (10.0, -20.0)
    j.step(1)
    r.step(1)
    _close(r.hdr_sum(), j._unswizzle(np.asarray(j.img)).reshape(RES[1], RES[0], 3))


def test_cli_resume_is_bitwise_a_straight_run(scene, tmp_path):
    """`render --checkpoint` for 2 spp, then `--resume` to 4 with a
    progressive save every spp: the final checkpoint's accumulator equals a
    straight 4-spp run's bit for bit."""
    common = [str(scene), "--device", "cpu", "--res", "32x32", "--depth", str(DEPTH),
              "--mode", "mis"]
    half, resumed, straight = (tmp_path / f"{n}.npz" for n in ("half", "resumed", "straight"))
    assert cli.main(["render", *common, "--spp", "2", "-o", str(tmp_path / "a.png"),
                     "--checkpoint", str(half)]) == 0
    half.replace(resumed)
    assert cli.main(["render", *common, "--spp", "4", "-o", str(tmp_path / "b.png"),
                     "--resume", str(resumed), "--save-every", "1",
                     "--checkpoint", str(resumed)]) == 0
    assert cli.main(["render", *common, "--spp", "4", "-o", str(tmp_path / "c.png"),
                     "--checkpoint", str(straight)]) == 0
    a, b = np.load(resumed), np.load(straight)
    assert int(a["iteration"]) == int(b["iteration"]) == 4
    np.testing.assert_array_equal(a["img"], b["img"])
    # a missing resume file is ignored, as in the JAX package
    assert cli.main(["render", *common, "--spp", "1", "-o", str(tmp_path / "d.png"),
                     "--resume", str(tmp_path / "absent.npz")]) == 0
