"""Progressive renderer: accumulation loop, tonemapped save, checkpointing.

Port of `pathtracer_tpu/integrator/render.py`.  The image accumulates
radiance sums across iterations; display and save divide by the iteration
count, then apply ACES + gamma 1/2.2 and the save-time X mirror.  The
accumulator, the iteration count and the camera's orbit save to the JAX
package's `.npz` checkpoint format and load from it, so a render resumes
exactly (the RNG keys on the iteration), in either package.

Each iteration runs the steps of `integrator/wavefront.py` with the
options' schedule (the per-bounce sort, the shrink ladder, the shadow sort)
and adds its contributions, in lane order, to the image: one add per
iteration, so the image does not depend on the schedule.  Where the JAX
Renderer runs its jitted iteration (`_iter_fn`, `_batch_fn`), a Renderer
on CUDA replays the steps as CUDA graphs, captured in the warm-up
iteration (`integrator/graphs.py`: one host read a lap, images bit for bit
the eager loop's), a sharded one each shard's on its own card; where the
JAX Renderer runs staged (a triangle scene off the kernels: the MTBVH walk
and the sweep, whose `torch.nonzero` a graph cannot hold), and on the CPU,
it runs the eager loop, `render_iteration` (sharded: the shards' steps
eagerly).
With `ray_regen` K > 1, `step` renders batches of up to K samples per
pixel in one persistent pool (the first, warm-up iteration alone);
DIRECT_LI and `show_normal` paths end after one bounce, so there the option
is ignored, as in the JAX package, and so it is for a triangle scene with
`pallas_traversal=False`.

`pallas_traversal=False` walks the triangles with the threaded MTBVH walk
instead of the kernels, and `use_bvh=False` sweeps every triangle
(ops/traverse.py; cross-checks, not fast paths).  A mesh that fits neither
kernel table turns `pallas_traversal` off when the tables are built, as the
JAX Renderer does.  `devices=N` renders pixel rows sharded over N devices
(parallel/sharding.py: the first N CUDA devices, or N shards on the CPU
with device="cpu", their laps in lockstep); as in the JAX package a sharded
renderer turns the 32x32 swizzle off and ignores `ray_regen`.  These only
change how the TPU runs, not the image, so they are accepted and ignored:
`packet_p`, `packet_q`, `packet_dense`, `packet_auto` and `interpret`
(`packet_rows` sets the ladder's tile, as in the JAX package).
`iters_per_dispatch` is accepted and ignored too: the JAX package batches k
iterations into one dispatch to hide a TPU dispatch latency, and the port's
read of the live count a lap rules out a graph of several iterations until
CUDA's conditional graph nodes carry the loop.

`Renderer.setup` holds the set-up's spans (utils/profiling.py), recorded
whether tracing is on or not: `renderer.init` (its children `cuda.context`,
`scene.load`, `bvh.build`, `tables.upload`) and `renderer.warmup` (the warm-up
iteration, `compile_seconds`; its children `kernels.load` where the kernels
were loaded in it, with `RenderStats.kernel_builds` the libraries nvcc
built, and each card's `graph.capture` of each step).
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from pathtracer_tpu_torch.scene.camera import RenderCamera, derive_camera
from pathtracer_tpu_torch.scene.parser import SceneData, load_scene
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from pathtracer_tpu_torch.utils.image_io import write_hdr, write_png
from pathtracer_tpu_torch.integrator import graphs
from pathtracer_tpu_torch.integrator.graphs import StaticIteration, graph_key
from pathtracer_tpu_torch.integrator.wavefront import CameraArrays, render_iteration
from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops import math as m
from pathtracer_tpu_torch.ops.traverse import packet_mode
from pathtracer_tpu_torch.scene.flatscene import build_flat_scene, resolve_device
from pathtracer_tpu_torch.utils import profiling, rng

SETUP_SPANS = 1024  # a Renderer's set-up spans: its own and each capture's


# copied from pathtracer_tpu/integrator/render.py:37 swizzle_map
def swizzle_map(width: int, height: int, block: int = 32) -> np.ndarray:
    """Lane -> pixel permutation grouping pixels into `block`^2 tiles."""
    idx = np.arange(width * height, dtype=np.int64)
    x = idx % width
    y = idx // width
    blocks_x = (width + block - 1) // block
    key = ((y // block) * blocks_x + (x // block)) * (block * block) + (
        y % block
    ) * block + (x % block)
    return np.argsort(key, kind="stable")


@dataclass
class RenderStats:
    iterations_done: int = 0
    rays_traced: int = 0
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0  # first iteration: kernel build + warm-up, not booked
    per_iter_seconds: list = field(default_factory=list)
    laps: int = 0  # bounce laps run in the booked iterations
    kernel_builds: int = 0  # kernel libraries nvcc built in the warm-up (0: loaded from the cache)

    @property
    def mrays_per_sec(self) -> float:
        t = self.wall_seconds
        return (self.rays_traced / t / 1e6) if t > 0 else 0.0


class Renderer:
    """Scene tables, camera and accumulation state for one scene on one
    device, or pixel-sharded over `devices` of them."""

    def __init__(
        self,
        scene: SceneData | str | Path,
        opts: RenderOptions | None = None,
        resolution: tuple[int, int] | None = None,
        trace_depth: int | None = None,
        devices: int | None = None,
        device="cuda",
    ):
        self.setup = profiling.Tracer(SETUP_SPANS)
        init = self.setup.open("renderer.init")
        self.opts = opts or RenderOptions()
        self.devices = int(devices) if devices else 1
        if self.devices > 1:
            from pathtracer_tpu_torch.parallel import sharding as sh

            # N shards on the CPU stand in for a mesh there; on CUDA the
            # first N cards, and fewer raise
            on_cpu = torch.device(device).type == "cpu"
            self.mesh = sh.make_mesh(self.devices, [device] * self.devices if on_cpu else None)
            self.device = self.mesh[0]
        else:
            self.device = resolve_device(device)
        if self.device.type == "cuda":
            t = time.perf_counter_ns()
            torch.cuda.synchronize(self.device)  # the card's context, made here and not in the upload
            self.setup.add("cuda.context", t, time.perf_counter_ns())
        if not isinstance(scene, SceneData):
            t = time.perf_counter_ns()
            scene = load_scene(scene)
            self.setup.add("scene.load", t, time.perf_counter_ns())
        self.scene = scene
        if resolution is not None:
            scene.camera.resolution = resolution
        if trace_depth is not None:
            scene.trace_depth = trace_depth
        self.flat, self.static = build_flat_scene(scene, opts=self.opts, device=self.device,
                                                  spans=self.setup)
        if self.static.num_tris > 0 and packet_mode(self.static) is None:
            # no kernel table fits the mesh: the MTBVH walk, as the JAX
            # Renderer turns pallas_traversal off for its XLA walk
            self.opts = dataclasses.replace(self.opts, pallas_traversal=False)
        self.width, self.height = scene.camera.resolution
        self.camera: RenderCamera = derive_camera(scene.camera)
        self.cam_position = None  # interactive pan/zoom override (None = scene)
        # spatial swizzle (triangle scenes): lane l renders pixel
        # pixel_order[l] but draws its random numbers from counter l, so it
        # must match the JAX package for the same pixels to get the same
        # samples; the image is unswizzled at readout
        self.pixel_order = None
        self.pixel_xy = None
        if self.devices == 1 and self.opts.swizzle and self.static.num_tris > 0:
            self.pixel_order = swizzle_map(self.width, self.height)
            self.pixel_xy = tuple(
                torch.from_numpy(a.astype(np.float32)).to(self.device)
                for a in (self.pixel_order % self.width, self.pixel_order // self.width)
            )
        self.shard_step = None  # the sharded step (devices > 1), made for self.opts
        self.seed = 0
        self.key = rng.base_key(0)
        self.traced_depth = 0  # laps of the last iteration
        self.lap_pools = []    # its pool's length at each lap
        self.graphs = None     # the CUDA graphs of the iteration (graph_route)
        self.stats = RenderStats()
        self.reset()
        self.setup.close(init)

    @property
    def regen_k(self) -> int:
        """Samples per pixel per regeneration batch (0: one per iteration).
        A DIRECT_LI or show_normal path ends after one bounce, so there is
        nothing to refill; a sharded renderer, and a triangle scene off the
        kernels (`pallas_traversal=False`, which the JAX package renders
        staged), ignore regeneration, as the JAX package's do."""
        k = int(self.opts.ray_regen)
        multi_bounce = self.opts.sample_mode != SampleMode.DIRECT_LI and not self.opts.show_normal
        kernels = bool(self.opts.pallas_traversal) or self.static.num_tris == 0
        return k if k > 1 and multi_bounce and kernels and self.devices == 1 else 0

    @property
    def graph_route(self) -> bool:
        """Does an iteration replay CUDA graphs?  On CUDA, where the JAX
        Renderer runs its jitted iteration, sharded or not: not for a
        triangle scene off the kernels (`pallas_traversal=False` or
        `use_bvh=False`), which the JAX package renders staged
        (`graphs.graph_route`)."""
        return graphs.graph_route(self.static, self.opts, self.device)

    def _compiled(self) -> StaticIteration:
        """The graphs for the current options, seed, route flags and film;
        captured anew when any of them changed since the last capture."""
        key = graph_key(self.static, self.opts, self.key, self.pixel_xy, bool(self.regen_k))
        if self.graphs is None or self.graphs.key != key:
            self.graphs = None  # the old graphs and their memory go first
            self.graphs = StaticIteration(self.flat, self.static, self.opts, self.key,
                                          pixel_xy=self.pixel_xy, regen=bool(self.regen_k))
        return self.graphs

    def compiled_iterations(self) -> list:
        """The StaticIterations made so far: the Renderer's own, or each
        shard's."""
        if self.devices > 1:
            return self.shard_step.shards.iterations if self.shard_step is not None else []
        return [self.graphs] if self.graphs is not None else []

    def _sharded(self):
        """The sharded step for the current options, made anew when they
        changed; its shards' graphs follow the seed themselves."""
        if self.shard_step is None or self.shard_step.shards.opts != self.opts:
            from pathtracer_tpu_torch.parallel import sharding as sh

            self.shard_step = None  # the old shards' graphs and their memory go first
            self.shard_step = sh.make_sharded_iteration(
                self.static, self.opts, self.width, self.height, self.mesh)[0]
        return self.shard_step

    def set_seed(self, seed: int):
        self.seed = int(seed)
        self.key = rng.base_key(self.seed)

    def reset(self):
        """Restart accumulation."""
        if self.devices > 1:
            from pathtracer_tpu_torch.parallel.sharding import zeros_image

            self.img = zeros_image(self.width, self.height, self.mesh)
        else:
            self.img = torch.zeros((self.width * self.height, 3), device=self.device)
        self.iteration = 0

    def set_orbit(self, theta: float, phi: float):
        """Interactive orbit: rotates the view basis, position unchanged."""
        self.camera = derive_camera(
            self.scene.camera, theta=theta, phi=phi, position=self.cam_position
        )
        self.reset()

    def pan(self, dx_px: float, dy_px: float):
        """Middle-drag translate along the ground-projected right/forward
        axes, 0.01 world units per pixel."""
        fwd = np.array(self.camera.view, np.float64)
        fwd[1] = 0.0
        fwd /= max(np.linalg.norm(fwd), 1e-12)
        right = np.array(self.camera.right, np.float64)
        right[1] = 0.0
        right /= max(np.linalg.norm(right), 1e-12)
        pos = np.array(self.camera.position, np.float64)
        pos -= dx_px * right * 0.01
        pos += dy_px * fwd * 0.01
        self.cam_position = tuple(float(x) for x in pos)
        self.camera = derive_camera(
            self.scene.camera, theta=self.camera.theta, phi=self.camera.phi,
            position=self.cam_position,
        )
        self.reset()

    def zoom(self, dy_frac: float):
        """Right-drag dolly along the view direction.

        The reference tracks `zoom += dy/height` but the code that applies
        it to the camera position is commented out, so right drag only
        resets accumulation there; the JAX package, and this port, dolly by
        the same magnitude.
        """
        pos = np.array(self.camera.position, np.float64)
        pos -= np.array(self.camera.view, np.float64) * dy_frac
        self.cam_position = tuple(float(x) for x in pos)
        self.camera = derive_camera(
            self.scene.camera, theta=self.camera.theta, phi=self.camera.phi,
            position=self.cam_position,
        )
        self.reset()

    def _cam_arrays(self) -> CameraArrays:
        return CameraArrays(*(torch.from_numpy(a).to(self.device) for a in self.camera.as_arrays()))

    def _sync(self):
        """Wait for every device of the render (each card of a mesh)."""
        for dev in dict.fromkeys(self.mesh if self.devices > 1 else [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _run_iteration(self, cam, nk: int = 1):
        """`nk` samples per pixel: one classic iteration, or a regeneration
        batch when regeneration is on; one iteration over the shards when
        sharded."""
        if self.devices > 1:
            self.img, rays, self.traced_depth = self._sharded()(
                self.flat, self.camera.as_arrays(), self.img, self.iteration + 1, self.key)
            self.lap_pools = []
            self.iteration += 1
            return rays
        if self.graph_route:
            contrib, rays, self.lap_pools = self._compiled().run(
                self.camera.as_arrays(), self.iteration + 1, nk if self.regen_k else None)
            rays = rays.clone()  # the graphs' buffer: the next iteration overwrites it
        else:
            contrib, rays, self.lap_pools = render_iteration(
                self.flat, self.static, self.opts, cam, self.key, self.iteration + 1,
                pixel_xy=self.pixel_xy, nk=nk if self.regen_k else None,
            )
        self.img = self.img + contrib
        self.iteration += nk
        self.traced_depth = len(self.lap_pools)
        return rays

    def step(self, num_iterations: int = 1) -> RenderStats:
        """Render `num_iterations` samples per pixel, in batches of up to
        `regen_k` under regeneration.  As in the JAX package, the very first
        iteration is a warm-up (here: kernel build, CUDA start-up and, on
        the graph route, the capture of every step's graph): its time goes
        to compile_seconds and its rays are not booked."""
        # the graphs and the shards copy their own
        cam = None if self.graph_route or self.devices > 1 else self._cam_arrays()
        if self.iteration == 0 and self.stats.compile_seconds == 0.0 and num_iterations > 0:
            t0 = time.perf_counter()
            warm = self.setup.open("renderer.warmup")
            builds = _build.builds
            self._run_iteration(cam)
            self._sync()
            self.stats.iterations_done += 1
            self.stats.compile_seconds = time.perf_counter() - t0
            self.setup.close(warm)
            self._warmup_spans(warm, builds)
            num_iterations -= 1

        t0 = time.perf_counter()
        rays = torch.zeros((), dtype=torch.int64, device=self.device)
        left, laps = num_iterations, 0
        while left > 0:
            nk = min(left, max(self.regen_k, 1))
            rays = rays + self._run_iteration(cam, nk)
            laps += self.traced_depth
            left -= nk
        rays_traced = int(rays)  # waits for the device
        self._sync()
        dt = time.perf_counter() - t0
        booked = max(num_iterations, 0)
        self.stats.iterations_done += booked
        self.stats.rays_traced += rays_traced
        self.stats.wall_seconds += dt
        self.stats.laps += laps
        if booked > 0:
            self.stats.per_iter_seconds.append(dt / booked)
        return self.stats

    def _warmup_spans(self, warm: int, builds: int) -> None:
        """The warm-up's children: the kernels' load where it fell in the
        warm-up (and how many libraries nvcc built for it), each card's
        captures."""
        self.stats.kernel_builds = _build.builds - builds
        span = self.setup.spans()[-1]  # the warm-up's own
        if _build.load_ns is not None and span.start <= _build.load_ns[0] <= span.end:
            self.setup.add("kernels.load", *_build.load_ns, parent=warm)
        for it in self.compiled_iterations():
            self.setup.adopt(it.setup.drain(), warm)

    # -- output -------------------------------------------------------------
    def _lane_image(self) -> torch.Tensor:
        """The accumulator as one (lanes, 3) tensor: the shards, padding rows
        included, on the first device when sharded."""
        if self.devices > 1:
            return torch.cat([part.to(self.device) for part in self.img])
        return self.img

    def _unswizzle(self, img_lane: np.ndarray) -> np.ndarray:
        if self.devices > 1:
            # row-sharded pool: lanes are already pixel-ordered; drop the
            # mesh's padding rows
            return img_lane[: self.width * self.height]
        if self.pixel_order is None:
            return img_lane
        out = np.empty_like(img_lane)
        out[self.pixel_order] = img_lane
        return out

    def hdr_sum(self) -> np.ndarray:
        """The accumulated radiance SUM as (H, W, 3), in pixel order."""
        return self._unswizzle(self._lane_image().cpu().numpy()).reshape(
            self.height, self.width, 3)

    def ldr_image(self) -> np.ndarray:
        """Tonemapped (H, W, 3) float in [0,1], without the save-time mirror."""
        avg = self._lane_image() / max(self.iteration, 1)
        if self.opts.tonemapping:
            ldr = m.gamma_correction(m.aces_film(avg))
        else:
            ldr = torch.clamp(avg, 0.0, 1.0)
        return self._unswizzle(ldr.cpu().numpy()).reshape(self.height, self.width, 3)

    def save_png(self, path: str | Path, mirror_x: bool = True):
        img = self.ldr_image()
        if mirror_x:
            img = img[:, ::-1]
        write_png(path, img)

    def save_hdr(self, path: str | Path, mirror_x: bool = True):
        avg = self.hdr_sum() / max(self.iteration, 1)
        if mirror_x:
            avg = avg[:, ::-1]
        write_hdr(path, avg)

    # -- checkpoint/resume ---------------------------------------------------
    def save_checkpoint(self, path: str | Path):
        """The JAX package's checkpoint: the lane-ordered accumulator (with a
        sharded render's padding rows), the iteration, the orbit, and the
        settings a resume must share."""
        np.savez_compressed(
            Path(path),
            img=self._lane_image().cpu().numpy(),
            iteration=self.iteration,
            theta=self.camera.theta,
            phi=self.camera.phi,
            meta=json.dumps(
                {
                    "scene": str(self.scene.path),
                    "width": self.width,
                    "height": self.height,
                    "mode": int(self.opts.sample_mode),
                    "seed": self.seed,
                    # the accumulator is LANE-ordered; loading under a
                    # different pixel mapping would scramble the image
                    "swizzled": self.pixel_order is not None,
                    # sharded accumulators carry mesh-padding rows
                    "devices": self.devices,
                }
            ),
        )

    def load_checkpoint(self, path: str | Path):
        """Resume from `save_checkpoint`'s file (either package's).  The
        camera comes back from the orbit alone, as in the JAX package."""
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        if (meta["width"], meta["height"]) != (self.width, self.height):
            raise ValueError("checkpoint resolution mismatch")
        if meta.get("swizzled", False) != (self.pixel_order is not None):
            raise ValueError(
                "checkpoint pixel-order mismatch (saved with a different "
                "swizzle setting)"
            )
        # resuming with a different estimator or RNG stream would silently
        # blend two different sequences into one accumulator
        if "mode" in meta and meta["mode"] != int(self.opts.sample_mode):
            raise ValueError(
                f"checkpoint sample-mode mismatch (saved mode {meta['mode']}, "
                f"current {int(self.opts.sample_mode)})"
            )
        if "seed" in meta and int(meta["seed"]) != self.seed:
            raise ValueError(
                f"checkpoint RNG-seed mismatch (saved seed {meta['seed']}, "
                f"current {self.seed})"
            )
        if int(meta.get("devices", 1)) != self.devices:
            raise ValueError(
                f"checkpoint device-count mismatch (saved {meta.get('devices', 1)}, "
                f"current {self.devices}) — the lane padding differs"
            )
        img = torch.from_numpy(np.asarray(data["img"], np.float32))
        if self.devices > 1:
            self.img = [part.to(dev) for part, dev in zip(img.chunk(self.devices), self.mesh)]
        else:
            self.img = img.to(self.device)
        self.iteration = int(data["iteration"])
        self.camera = derive_camera(
            self.scene.camera, theta=float(data["theta"]), phi=float(data["phi"])
        )


def render_scene(
    scene_path: str | Path,
    spp: int | None = None,
    mode: SampleMode = SampleMode.BSDF,
    resolution: tuple[int, int] | None = None,
    trace_depth: int | None = None,
    out: str | Path | None = None,
    opts: RenderOptions | None = None,
    device="cuda",
) -> tuple[Renderer, RenderStats]:
    """One-call headless render (the CLI's core)."""
    opts = (opts or RenderOptions()).with_mode(mode)
    r = Renderer(scene_path, opts=opts, resolution=resolution, trace_depth=trace_depth,
                 device=device)
    n = spp if spp is not None else r.static.iterations
    stats = r.step(n)
    if out is not None:
        r.save_png(out)
    return r, stats
