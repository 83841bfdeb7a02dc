"""Driver entry points of the port (the JAX package's `__graft_entry__.py`).

entry()              -> (fn, example_args): the single-device render step of
                        `make_render_iteration` on the analytic Cornell box
                        (MIS, depth 4, 64x64) and its arguments.
dryrun_multichip(n)  -> one pixel-sharded step over an n-device mesh on the
                        Cornell box and, unless `fast`, on the glass-torus
                        box (the triangle path: K1/K2 on CUDA, their plain
                        versions on the CPU), then one sample-sharded step;
                        each held bit for bit to the one-device steps.

Both run on CUDA unless the caller asks for the CPU; asking for CUDA where
there is none raises.  The JAX package runs its dry run in a scrubbed
subprocess, to shed a TPU backend the calling process may have registered;
PyTorch keeps no such process-wide backend, so this one runs in the caller's
process.

    python -m pathtracer_tpu_torch.entry [--device cuda:0] [--shards 8]
    python -m pathtracer_tpu_torch.entry --cards 4

runs the entry step on `--device`, then the dry run over `--shards` shards
of that one device, or with `--cards N` over the first N visible cards.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from pathtracer_tpu_torch.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer_tpu_torch.parallel import sharding as sh
from pathtracer_tpu_torch.scene.camera import derive_camera
from pathtracer_tpu_torch.scene.flatscene import build_flat_scene, resolve_device
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils import rng
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

_SCENES = Path(__file__).resolve().parent.parent / "scenes"
SCENE = _SCENES / "cornell_spheres.txt"
MESH_SCENE = _SCENES / "glasstorus.txt"  # the glass box with a 10,000-triangle torus


def _build(width=64, height=64, scene_path=SCENE, device="cuda"):
    """(flat, static, opts, cam, key) of `scene_path` at width x height,
    depth 4, MIS, seed 0, on `device`.  The swizzle is off: the step
    factory is given no lane -> pixel map."""
    dev = resolve_device(device)
    scene = load_scene(scene_path)
    scene.camera.resolution = (width, height)
    scene.trace_depth = 4
    opts = RenderOptions(sample_mode=SampleMode.MIS, swizzle=False)
    flat, static = build_flat_scene(scene, opts=opts, device=dev)
    cam = CameraArrays(*(torch.from_numpy(a).to(dev)
                         for a in derive_camera(scene.camera).as_arrays()))
    return flat, static, opts, cam, rng.base_key(0)


def entry(device="cuda"):
    """The single-device render step and its example arguments:
    fn(flat, cam, img, iteration, key) -> (img, rays, depth)."""
    width = height = 64
    flat, static, opts, cam, key = _build(width, height, device=device)
    fn = make_render_iteration(static, opts, width, height)
    img = torch.zeros((width * height, 3), dtype=torch.float32, device=flat.device)
    return fn, (flat, cam, img, 1, key)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, fast: bool = False, devices=None) -> None:
    """One pixel-sharded step over an n-device mesh (the first n CUDA
    devices, or `devices`, which may repeat one device) on the Cornell box
    at 64 x 8n and, unless `fast`, on MESH_SCENE; then one sample-sharded
    step at 32x32.  Each is held bit for bit to the one-device factory step
    (pixel passes) or to the n sequential iterations (sample pass), and
    prints a `dryrun_multichip ok` line."""
    mesh = sh.make_mesh(n_devices, devices)
    names = ", ".join(str(d) for d in mesh)
    width, height = 64, 8 * n_devices
    for scene_path in (SCENE,) if fast else (SCENE, MESH_SCENE):
        flat, static, opts, cam, key = _build(width, height, scene_path, mesh[0])
        step, _, ph = sh.make_sharded_iteration(static, opts, width, height, mesh)
        img, rays, depth = step(flat, cam, sh.zeros_image(width, height, mesh), 1, key)
        out = sh.fetch_image(img, width, height)
        zeros = torch.zeros((width * height, 3), dtype=torch.float32, device=flat.device)
        want, want_rays, want_depth = make_render_iteration(static, opts, width, height)(
            flat, cam, zeros, 1, key)
        _require(out.shape == (height, width, 3), f"image shape {out.shape}")
        _require(int(rays) > 0, "no rays traced in the sharded step")
        _require(np.array_equal(out, want.cpu().numpy().reshape(height, width, 3))
                 and int(rays) == int(want_rays) and depth == want_depth,
                 f"the sharded step on {scene_path.name} differs from the one-device step")
        walk = "none" if not static.num_tris else (
            "CUDA kernels" if flat.device.type == "cuda" else "plain versions")
        print(f"dryrun_multichip ok: {n_devices} devices ({names}), {height}x{width}, "
              f"scene {scene_path.stem} (tris={static.num_tris}, traversal={walk}), "
              f"{int(rays)} rays, {depth} laps, image sum {float(out.sum()):.4f}, "
              f"bitwise the one-device step", flush=True)
    # sample space: device d renders the whole frame at iteration d + 1
    flat, static, opts, cam, key = _build(32, 32, SCENE, mesh[0])
    sstep, combine = sh.sample_parallel_step(static, opts, 32, 32, mesh)
    simg, srays = sstep(flat, cam, [torch.zeros((32 * 32, 3), device=d) for d in mesh], 1, key)
    combined = combine(simg).cpu().numpy()
    full = make_render_iteration(static, opts, 32, 32)
    seq, seq_rays = torch.zeros((32 * 32, 3), device=flat.device), 0
    for it in range(1, n_devices + 1):
        seq, r, _ = full(flat, cam, seq, it, key)
        seq_rays += int(r)
    _require(combined.shape == (32 * 32, 3), f"image shape {combined.shape}")
    _require(int(srays) > 0, "no rays traced in the sample-sharded step")
    _require(np.array_equal(combined, seq.cpu().numpy()) and int(srays) == seq_rays,
             "the sample-sharded step differs from the sequential iterations")
    print(f"dryrun_multichip ok: sample-space sharding, {n_devices} devices ({names}) x 32x32 "
          f"full frames, {int(srays)} rays, image sum {float(combined.sum()):.4f}, bitwise "
          f"the sequential iterations", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pathtracer_tpu_torch.entry")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    mesh = ap.add_mutually_exclusive_group()
    mesh.add_argument("--shards", type=int, default=8, help="shards of --device in the dry run")
    mesh.add_argument("--cards", type=int, default=None,
                      help="run the dry run over the first N visible cards instead")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    img, rays, depth = fn(*example_args)
    print(f"entry ok: img {tuple(img.shape)} on {img.device}, rays {int(rays)}, depth {depth}")
    if args.cards is not None:
        dryrun_multichip(args.cards)
    else:
        dryrun_multichip(args.shards, devices=[args.device] * args.shards)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
