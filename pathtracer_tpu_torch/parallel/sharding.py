"""Pixel-space and sample-space sharding over several devices.

Port of `pathtracer_tpu/parallel/sharding.py`.  A mesh is a list of
torch.devices, one per shard; a device may appear more than once (one card
running two shards, or the CPU standing in for a mesh), and the scene tables
are copied once per distinct device.

- Pixel space (`make_sharded_iteration`): shard d renders `local_rows` rows
  of the film from pixel d * local_rows * W on, on its own device, into its
  own part of the accumulator.  The film's rows are padded to a multiple of
  the shard count; the padding rows are rendered and dropped on fetch, so
  the ray count includes them.  Lane l of a shard draws its random numbers
  from counter pixel0 + l, its global pixel index, so the image is bit for
  bit the single-device render's with swizzle=False.
- Sample space (`sample_parallel_step`): every device renders the whole
  film, device d the iteration (it - 1) * n + d + 1, and `combine` sums the
  accumulators.

Each shard runs the step of `integrator/wavefront.py make_render_iteration`
(with `local_rows` in pixel space), as the JAX package's shard_map bodies do.
The shards run one after another from the calling thread, each with the
single-device loop's one host read a lap.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from pathtracer_tpu_torch.integrator.render import resolve_device
from pathtracer_tpu_torch.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.utils.config import RenderOptions


def _device(d) -> torch.device:
    """`d` as a torch.device with its CUDA index made explicit, so that
    equal devices compare equal."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The first `n_devices` of `devices`, or of the visible CUDA devices
    when no list is given; fewer than asked for raises."""
    visible = devices is None
    if visible:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devices)} "
                f"{'CUDA devices are visible' if visible else 'devices were given'} (an "
                "explicit device list may repeat a device, e.g. ['cuda:0', 'cuda:0'])"
            )
        devices = devices[:n_devices]
    return devices


def padded_height(height: int, n_dev: int) -> int:
    """Image rows are padded so the pool splits evenly across the mesh."""
    return ((height + n_dev - 1) // n_dev) * n_dev


class _Tables:
    """The scene tables and camera on each device of a mesh, copied from
    the caller's once per distinct device (and again if the caller hands
    another FlatScene)."""

    def __init__(self):
        self.copies = {}

    def flat(self, flat: FlatScene, dev: torch.device) -> FlatScene:
        if flat.device == dev:
            return flat
        src, copy = self.copies.get(dev, (None, None))
        if src is not flat:
            copy = FlatScene(**{f.name: getattr(flat, f.name).to(dev) for f in fields(FlatScene)})
            self.copies[dev] = (flat, copy)
        return copy

    @staticmethod
    def cam(cam: CameraArrays, dev: torch.device) -> CameraArrays:
        return CameraArrays(*(t.to(dev) for t in cam))


def make_sharded_iteration(
    static: SceneStatic,
    opts: RenderOptions,
    width: int,
    height: int,
    mesh: list,
):
    """Pixel-space sharded render step.

    Returns (step, shard_devices, padded_height): step(flat, cam, img,
    iteration, key) -> (img, rays_traced, depth), where img is the list of
    the shards' accumulators ((local_rows * W, 3) each, on its shard's
    device), rays_traced the count over all shards (an int64 tensor on the
    first device) and depth the most bounce laps a shard ran.
    """
    n_dev = len(mesh)
    ph = padded_height(height, n_dev)
    local_h = ph // n_dev
    local_iter = make_render_iteration(static, opts, width, height, local_rows=local_h)
    tables = _Tables()

    def step(flat, cam, img, iteration, key):
        out, rays, depth = [], [], 0
        for d, dev in enumerate(mesh):
            part, r, laps = local_iter(tables.flat(flat, dev), tables.cam(cam, dev), img[d],
                                       iteration, key, d * local_h * width)
            out.append(part)
            rays.append(r)
            depth = max(depth, laps)
        return out, sum(r.to(mesh[0]) for r in rays), depth

    return step, list(mesh), ph


def zeros_image(width: int, height: int, mesh: list) -> list:
    """The zero accumulator of a padded film, one part per shard."""
    local = padded_height(height, len(mesh)) // len(mesh) * width
    return [torch.zeros((local, 3), dtype=torch.float32, device=dev) for dev in mesh]


def fetch_image(img: list, width: int, height: int) -> np.ndarray:
    """The shards gathered to the host as (height, W, 3), padding dropped."""
    return np.concatenate([part.cpu().numpy() for part in img]).reshape(-1, width, 3)[:height]


def sample_parallel_step(
    static: SceneStatic,
    opts: RenderOptions,
    width: int,
    height: int,
    mesh: list,
):
    """Sample-space parallelism: each device renders the whole frame with a
    different iteration stripe.  Returns (step, combine): step(flat, cam,
    img, iteration, key) -> (img, rays_traced), img a list of one (W*H, 3)
    accumulator per device; combine(img) sums them on the first device."""
    n_dev = len(mesh)
    full_iter = make_render_iteration(static, opts, width, height)
    tables = _Tables()

    def step(flat, cam, img, iteration, key):
        out, rays = [], []
        for d, dev in enumerate(mesh):
            # device d renders iteration n_dev * (iteration - 1) + d + 1
            it = (int(iteration) - 1) * n_dev + d + 1
            part, r, _ = full_iter(tables.flat(flat, dev), tables.cam(cam, dev), img[d], it, key)
            out.append(part)
            rays.append(r)
        return out, sum(r.to(mesh[0]) for r in rays)

    def combine(img):
        total = img[0]
        for part in img[1:]:
            total = total + part.to(mesh[0])
        return total

    return step, combine
