"""Pixel-space and sample-space sharding of the port (parallel/sharding.py)
on meshes of CPU shards.

A pixel-sharded render draws lane l of shard d from RNG counter pixel0 + l,
its global pixel index, so it is bitwise the single-device render with the
swizzle off (the JAX package's sharding rule), padding rows aside; the
sample-parallel step renders iterations 2(it-1)+1 and 2(it-1)+2 on the two
devices and is held to the sequential iterations.

The steps run each shard's `integrator/graphs.py StaticIteration` (its
steps eager on the CPU) in lockstep: with 2 and 3 shards, padding rows
included, the pixel-sharded step is bitwise `render_iteration` over the
padded film, and each sample-sharded accumulator bitwise its own
iterations in turn.  Against the JAX package: the port's pixel-sharded step
on 8 CPU shards against the JAX package's `make_sharded_iteration` (one
shard_map dispatch) on the 8 virtual CPU devices of tests/conftest.py, on
cornell_spheres at 64x60 (padded to 64 rows), two iterations, within rtol
1e-4 / atol 1e-5 on every pixel, rays and depth exact; the JAX side in a
process of its own with XLA rounding each operation once
(tests/test_torch_entry.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import entry
from pathtracer_tpu_torch.integrator.graphs import StaticIteration
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.integrator.wavefront import render_iteration
from pathtracer_tpu_torch.parallel import sharding as sh
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_torch_cornell import XLA_ONE_ROUNDING
from tests.test_torch_render import ATOL, RTOL, ROOT, small_torus_scene

DEPTH = 4


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads (see tests/test_torch_schedule.py)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    return small_torus_scene(tmp_path_factory.mktemp("shard"))


SCENES = {"cornell_spheres": lambda torus: ROOT / "scenes" / "cornell_spheres.txt",
          "torus box": lambda torus: torus}


def single(scene, res, spp=2, **options):
    """The one-device render with the swizzle off: (HDR sum, rays of the
    booked iterations, renderer)."""
    r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS, swizzle=False, **options),
                 resolution=res, trace_depth=DEPTH, device="cpu")
    r.step(spp)
    return r.hdr_sum(), r


def sharded(r, n_shards, spp=2):
    """`spp` iterations of make_sharded_iteration over n CPU shards, on the
    tables and camera of renderer `r`: (image, rays per iteration, depth)."""
    mesh = sh.make_mesh(n_shards, ["cpu"] * n_shards)
    step, devs, ph = sh.make_sharded_iteration(r.static, r.opts, r.width, r.height, mesh)
    assert devs == mesh and ph == sh.padded_height(r.height, n_shards) and ph % n_shards == 0
    img = sh.zeros_image(r.width, r.height, mesh)
    assert sum(part.shape[0] for part in img) == ph * r.width
    rays, depth = [], 0
    for it in range(1, spp + 1):
        img, n, depth = step(r.flat, r._cam_arrays(), img, it, r.key)
        rays.append(int(n))
    return sh.fetch_image(img, r.width, r.height), rays, depth


@pytest.mark.parametrize("name", list(SCENES))
def test_two_shards_bitwise_single_device(torus, name):
    want, r = single(SCENES[name](torus), (32, 32))
    got, rays, depth = sharded(r, 2)
    np.testing.assert_array_equal(got, want)
    # the warm-up iteration is not booked: the second iteration's rays
    assert rays[1] == r.stats.rays_traced
    assert 1 <= depth <= DEPTH + 1


@pytest.mark.parametrize("n_shards", [2, 3])
def test_padding_rows(torus, n_shards):
    """31 rows over 2 or 3 shards: padded to 32 or 33 rows, rendered and
    dropped on fetch; the image is still the single-device one, and the
    padding's rays are counted, as in the JAX package."""
    want, r = single(torus, (24, 31))
    got, rays, _ = sharded(r, n_shards)
    assert got.shape == (31, 24, 3)
    np.testing.assert_array_equal(got, want)
    assert rays[1] > r.stats.rays_traced


def test_renderer_devices_two(torus, tmp_path):
    """Renderer(devices=2) on two CPU shards: no swizzle, regeneration
    ignored, the image the single-device one bit for bit, and a checkpoint
    round trip with the padded accumulator."""
    want, _ = single(torus, (32, 31), spp=3)
    r = Renderer(torus, opts=RenderOptions(sample_mode=SampleMode.MIS, ray_regen=4),
                 resolution=(32, 31), trace_depth=DEPTH, devices=2, device="cpu")
    assert r.pixel_order is None and r.regen_k == 0 and r.mesh == [torch.device("cpu")] * 2
    r.step(2)
    r.save_checkpoint(tmp_path / "ck.npz")
    data = np.load(tmp_path / "ck.npz")
    assert data["img"].shape == (32 * 32, 3)  # 31 rows padded to 32
    r.step(1)
    np.testing.assert_array_equal(r.hdr_sum(), want)
    resumed = Renderer(torus, opts=RenderOptions(sample_mode=SampleMode.MIS),
                       resolution=(32, 31), trace_depth=DEPTH, devices=2, device="cpu")
    resumed.load_checkpoint(tmp_path / "ck.npz")
    assert resumed.iteration == 2
    resumed.step(1)
    np.testing.assert_array_equal(resumed.hdr_sum(), want)


def test_sample_parallel_matches_sequential(torus):
    """One round of two devices against iterations 1 and 2 in sequence, and
    two rounds against iterations 1-4."""
    _, r = single(torus, (32, 32), spp=1)
    mesh = sh.make_mesh(2, ["cpu", "cpu"])
    step, combine = sh.sample_parallel_step(r.static, r.opts, 32, 32, mesh)
    img = [torch.zeros((32 * 32, 3)) for _ in mesh]
    cam = r._cam_arrays()
    seq = torch.zeros((32 * 32, 3))
    for rnd in (1, 2):
        img, rays = step(r.flat, cam, img, rnd, r.key)
        assert int(rays) > 0
        for it in (2 * rnd - 1, 2 * rnd):
            contrib, _, _ = render_iteration(r.flat, r.static, r.opts, cam, r.key, it)
            seq = seq + contrib
        got = combine(img).numpy()
        ok = np.isclose(got, seq.numpy(), rtol=RTOL, atol=ATOL).all(-1)
        assert ok.all()
        if rnd == 1:  # 0 + a + b in either grouping
            np.testing.assert_array_equal(got, seq.numpy())


def test_make_mesh():
    assert sh.make_mesh(2, ["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="requested a 3-device mesh but only 2 devices"):
        sh.make_mesh(3, ["cpu", "cpu"])


def test_renderer_devices_needs_the_cards(torus):
    """Renderer(devices=2) on "cuda" (the default) raises without two CUDA
    devices, as the JAX package's make_mesh does; nothing runs on the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has two CUDA devices")
    with pytest.raises(ValueError, match="requested a 2-device mesh but only .* CUDA devices"):
        Renderer(torus, devices=2)
    with pytest.raises(ValueError, match="2-device mesh"):
        sh.make_mesh(2)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_lockstep_step_is_render_iteration(torus, n_shards):
    """One step of 2 or 3 lockstep shards on 31 rows (padded to 32 or 33):
    the shards' accumulators, concatenated, are render_iteration's
    contributions over the padded film bit for bit, the rays its rays, the
    depth the most laps of the shards' own render_iteration; the shards ran
    as StaticIterations with the steps eager, each on its own rows."""
    _, r = single(torus, (24, 31), spp=1)
    mesh = sh.make_mesh(n_shards, ["cpu"] * n_shards)
    step, _, ph = sh.make_sharded_iteration(r.static, r.opts, r.width, r.height, mesh)
    local = ph // n_shards
    base = [torch.rand((local * r.width, 3), generator=torch.Generator().manual_seed(d))
            for d in range(n_shards)]
    cam = r._cam_arrays()
    img, rays, depth = step(r.flat, cam, base, 2, r.key)
    want, want_rays, _ = render_iteration(r.flat, r.static, r.opts, cam, r.key, 2,
                                          local_rows=ph)
    assert torch.equal(torch.cat(img), torch.cat(base) + want)
    assert int(rays) == int(want_rays) and rays.dtype == torch.int64
    laps = [render_iteration(r.flat, r.static, r.opts, cam, r.key, 2, pixel0=d * local * r.width,
                             local_rows=local)[2] for d in range(n_shards)]
    assert depth == max(len(x) for x in laps)
    its = step.shards.iterations
    assert [type(it) for it in its] == [StaticIteration] * n_shards
    assert not any(it.graphs for it in its)
    assert [it.n for it in its] == [local * r.width] * n_shards
    assert [it.spec.pixel0 for it in its] == [d * local * r.width for d in range(n_shards)]
    # a second step replays the same shards' iterations
    step(r.flat, cam, img, 3, r.key)
    assert step.shards.iterations == its


def test_sample_shards_are_their_own_iterations(torus):
    """Three sample shards over two rounds: shard d's accumulator is its own
    iterations 3(it-1)+d+1, rendered one after the other, bit for bit."""
    _, r = single(torus, (24, 24), spp=1)
    mesh = sh.make_mesh(3, ["cpu"] * 3)
    step, _ = sh.sample_parallel_step(r.static, r.opts, 24, 24, mesh)
    cam = r._cam_arrays()
    img = [torch.zeros((24 * 24, 3)) for _ in mesh]
    want = [torch.zeros((24 * 24, 3)) for _ in mesh]
    want_rays = 0
    for rnd in (1, 2):
        img, rays = step(r.flat, cam, img, rnd, r.key)
        for d in range(3):
            contrib, n, _ = render_iteration(r.flat, r.static, r.opts, cam, r.key,
                                             3 * (rnd - 1) + d + 1)
            want[d] = want[d] + contrib
            want_rays += int(n)
        assert all(torch.equal(a, b) for a, b in zip(img, want))
    assert int(rays) > 0


_JAX_SHARDED = """
import sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from pathtracer_tpu.integrator.wavefront import CameraArrays
from pathtracer_tpu.parallel import sharding as sh
from pathtracer_tpu.scene.camera import derive_camera
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import load_scene
from pathtracer_tpu.utils import rng
from pathtracer_tpu.utils.config import RenderOptions, SampleMode
width, height, n = int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
scene = load_scene(sys.argv[2])
scene.camera.resolution = (width, height)
scene.trace_depth = 4
flat, static = build_flat_scene(scene)
opts = RenderOptions(sample_mode=SampleMode.MIS)
cam = CameraArrays(*[jnp.asarray(x) for x in derive_camera(scene.camera).as_arrays()])
mesh = sh.make_mesh(n)
step, _, ph = sh.make_sharded_iteration(static, opts, width, height, mesh)
img, out = sh.zeros_image(width, height, mesh), {"ph": ph}
for it in (1, 2):
    img, rays, depth = step(flat, cam, img, jnp.int32(it), rng.base_key(0))
    out[f"img{it}"], out[f"rays{it}"], out[f"depth{it}"] = np.asarray(img), int(rays), int(depth)
np.savez(sys.argv[3], **out)
"""


def test_sharded_step_matches_jax(tmp_path):
    """The port's pixel-sharded step on 8 CPU shards against the JAX
    package's on the 8 virtual CPU devices: cornell_spheres MIS 64x60,
    depth 4, seed 0, iterations 1 and 2 accumulated."""
    width, height, n = 64, 60, 8
    out = tmp_path / "jax_sharded.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_ROUNDING}".strip()}
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, str(ROOT), str(entry.SCENE), str(out), str(width),
         str(height), str(n)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = dict(np.load(out))
    flat, static, opts, cam, key = entry._build(width, height, device="cpu")
    mesh = sh.make_mesh(n, ["cpu"] * n)
    step, _, ph = sh.make_sharded_iteration(static, opts, width, height, mesh)
    assert ph == int(ref["ph"]) == 64
    img = sh.zeros_image(width, height, mesh)
    for it in (1, 2):
        img, rays, depth = step(flat, cam, img, it, key)
        got = torch.cat(img).numpy()
        want = ref[f"img{it}"]
        assert got.shape == want.shape == (ph * width, 3)
        ok = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
        print(f"iteration {it}: {int((~ok).sum())} of {ok.size} pixels outside tolerance, "
              f"{int((got == want).all(-1).sum())} bitwise equal")
        assert ok.all()
        assert int(rays) == int(ref[f"rays{it}"]) and depth == int(ref[f"depth{it}"])


def test_renderer_devices_follows_seed_options_orbit(torus):
    """A sharded Renderer's shards are made anew for a new seed (their key)
    and a new step for new options, and an orbit change needs neither: each
    image bitwise a fresh two-shard Renderer's with the same settings."""
    def fresh(seed=0, orbit=None, **options):
        r = Renderer(torus, opts=RenderOptions(sample_mode=SampleMode.MIS, **options),
                     resolution=(24, 24), trace_depth=DEPTH, devices=2, device="cpu")
        r.set_seed(seed)
        if orbit:
            r.set_orbit(*orbit)
        r.step(1)
        return r.hdr_sum()

    r = Renderer(torus, opts=RenderOptions(sample_mode=SampleMode.MIS), resolution=(24, 24),
                 trace_depth=DEPTH, devices=2, device="cpu")
    r.step(1)
    step, its = r.shard_step, r.shard_step.shards.iterations
    r.set_seed(5)
    r.reset()
    r.step(1)
    assert r.shard_step is step and not set(map(id, r.shard_step.shards.iterations)) & set(
        map(id, its))
    np.testing.assert_array_equal(r.hdr_sum(), fresh(seed=5))
    its = r.shard_step.shards.iterations
    r.set_orbit(0.3, -0.2)
    r.step(1)
    assert r.shard_step.shards.iterations == its
    np.testing.assert_array_equal(r.hdr_sum(), fresh(seed=5, orbit=(0.3, -0.2)))
    r.opts = RenderOptions(sample_mode=SampleMode.MIS, compaction=False)
    r.reset()
    r.step(1)
    assert r.shard_step is not step and r.shard_step.shards.opts == r.opts
    np.testing.assert_array_equal(r.hdr_sum(), fresh(seed=5, orbit=(0.3, -0.2),
                                                     compaction=False))
