"""Pixel-space and sample-space sharding of the port (parallel/sharding.py)
on a mesh of two CPU shards.

A pixel-sharded render draws lane l of shard d from RNG counter pixel0 + l,
its global pixel index, so it is bitwise the single-device render with the
swizzle off (the JAX package's sharding rule), padding rows aside; the
sample-parallel step renders iterations 2(it-1)+1 and 2(it-1)+2 on the two
devices and is held to the sequential iterations.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.integrator.wavefront import render_iteration
from pathtracer_tpu_torch.parallel import sharding as sh
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
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
