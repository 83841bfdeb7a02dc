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

Where the JAX package runs one jitted shard_map dispatch, each shard here
runs its iteration through its own `integrator/graphs.py StaticIteration`
on its shard's device: CUDA graphs captured at the first step, as the JAX
package compiles at its first call, and replayed after.  `run_lockstep`
drives the shards from one host thread, each round issuing every shard's
next lap before it reads any shard's live count, so distinct cards run
their laps at the same time.  The ray count is summed on the first device
(the JAX package's psum), the depth is the most laps a shard ran (its
pmax), and each shard adds its contributions on its own device.  Where the
JAX package runs staged (a triangle scene with `pallas_traversal=False` or
`use_bvh=False`: the MTBVH walk and the sweep read the host inside a lap),
and on the CPU, the shards' steps run eagerly (`graphs.graph_route`), in the
same lockstep.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from pathtracer_tpu_torch.integrator import graphs
from pathtracer_tpu_torch.integrator.wavefront import check_film
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic, resolve_device
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
    """The scene tables on each device of a mesh, copied from the caller's
    once per distinct device (and again if the caller hands another
    FlatScene)."""

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


class ShardIterations:
    """The shards' iterations: one StaticIteration per shard of `mesh`, on
    its device and over the tables copied there, the pool `local_rows` rows
    from pixel `pixel0s[d]` (None: the whole film).  Each is made at its
    first run, and made anew where the key or the tables change
    (`graphs.held_iteration`)."""

    def __init__(self, static: SceneStatic, opts: RenderOptions, mesh: list,
                 local_rows: int | None = None, pixel0s=None):
        self.static, self.opts, self.mesh = static, opts, list(mesh)
        self.local_rows = local_rows
        self.pixel0s = list(pixel0s) if pixel0s is not None else [0] * len(mesh)
        self.tables = _Tables()
        self.held = {}  # shard -> its StaticIteration

    @property
    def iterations(self) -> list:
        """The shards' StaticIterations made so far, in shard order."""
        return [self.held[d] for d in sorted(self.held)]

    def run(self, flat: FlatScene, cam, key, iterations: list) -> list:
        """Shard d's iteration `iterations[d]` on each shard, in lockstep:
        (contrib, rays, laps) per shard, the contributions and rays in the
        shard's buffers (overwritten by the next run)."""
        runs = []
        for d, dev in enumerate(self.mesh):
            it = graphs.held_iteration(self.held, d, self.tables.flat(flat, dev), self.static,
                                       self.opts, key, local_rows=self.local_rows,
                                       pixel0=self.pixel0s[d])
            runs.append((it, cam, iterations[d], None))
        return graphs.run_lockstep(runs)

    def total_rays(self, outs: list) -> torch.Tensor:
        """The shards' rays summed on the first device (the JAX package's
        psum), a new tensor."""
        return torch.stack([rays.to(self.mesh[0]) for _, rays, _ in outs]).sum()


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
    device; new tensors), rays_traced the count over all shards (an int64
    tensor on the first device) and depth the most bounce laps a shard ran.
    `cam` is CameraArrays, or `RenderCamera.as_arrays()`'s numpy arrays.
    `step.shards` is the step's ShardIterations.
    """
    check_film(static, width, height)
    n_dev = len(mesh)
    ph = padded_height(height, n_dev)
    local_h = ph // n_dev
    shards = ShardIterations(static, opts, mesh, local_h,
                             [d * local_h * width for d in range(n_dev)])

    def step(flat, cam, img, iteration, key):
        outs = shards.run(flat, cam, key, [int(iteration)] * n_dev)
        return ([part + contrib for part, (contrib, _, _) in zip(img, outs)],
                shards.total_rays(outs), max(len(laps) for _, _, laps in outs))

    step.shards = shards
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
    accumulator per device (new tensors); combine(img) sums them on the
    first device.  `step.shards` is the step's ShardIterations."""
    check_film(static, width, height)
    n_dev = len(mesh)
    shards = ShardIterations(static, opts, mesh)

    def step(flat, cam, img, iteration, key):
        # device d renders iteration n_dev * (iteration - 1) + d + 1
        outs = shards.run(flat, cam, key,
                          [(int(iteration) - 1) * n_dev + d + 1 for d in range(n_dev)])
        return ([part + contrib for part, (contrib, _, _) in zip(img, outs)],
                shards.total_rays(outs))

    def combine(img):
        total = img[0]
        for part in img[1:]:
            total = total + part.to(mesh[0])
        return total

    step.shards = shards
    return step, combine
