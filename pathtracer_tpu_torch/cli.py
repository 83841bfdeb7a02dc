"""Command-line interface of the PyTorch/CUDA port.

    python -m pathtracer_tpu_torch.cli render  <scene.txt> [options]
    python -m pathtracer_tpu_torch.cli info    <scene.txt> [--device D]
    python -m pathtracer_tpu_torch.cli bench   <scene.txt> [options]
    python -m pathtracer_tpu_torch.cli preview <scene.txt> [options]

The flags are the JAX CLI's (`python -m pathtracer_tpu.cli`), plus
`--device` (default `cuda`).  Asking for CUDA where there is none is an
error: the port never moves to the CPU on its own (`--device cpu`, or the
JAX CLI's `--cpu`, asks for the CPU).  `--regen K` renders K samples per
pixel in one persistent pool (ray regeneration; BSDF and MIS).
`--devices N` shards pixel rows over the first N CUDA devices (N shards
on the CPU with `--device cpu`).  `render --checkpoint` writes the JAX
package's `.npz` checkpoint (at every progressive save too) and `--resume`
continues one, written by either package.  `bench` prints one JSON line,
the JAX CLI's; the device goes to stderr, as for `render`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("scene", help="scene .txt file (reference format)")
    p.add_argument("--mode", choices=["bsdf", "direct", "mis"], default="bsdf",
                   help="integrator")
    p.add_argument("--spp", type=int, default=None, help="iterations (default: scene ITERATIONS)")
    p.add_argument("--depth", type=int, default=None, help="max bounces (default: scene DEPTH)")
    p.add_argument("--res", type=str, default=None, help="WxH override, e.g. 800x800")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--no-tonemap", action="store_true", help="skip ACES+gamma on save")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=None,
                   help="shard pixel rows over N devices; the position-keyed RNG keeps the "
                        "image bit-identical to 1 device")
    p.add_argument("--regen", type=int, default=0, metavar="K",
                   help="ray regeneration: render up to K samples per pixel in one persistent "
                        "pool, refilling a lane whose path ended with its pixel's next sample "
                        "(BSDF and MIS; same samples and rays, float sums in another order)")


def _parse_mode(s: str):
    from pathtracer_tpu_torch.utils.config import SampleMode

    return {"bsdf": SampleMode.BSDF, "direct": SampleMode.DIRECT_LI, "mis": SampleMode.MIS}[s]


def _parse_res(s):
    if s is None:
        return None
    try:
        w, h = s.lower().split("x")
        return (int(w), int(h))
    except ValueError:
        raise SystemExit(f"error: --res expects WxH (e.g. 800x800), got {s!r}")


def cmd_render(args) -> int:
    from pathtracer_tpu_torch.utils.config import RenderOptions
    from pathtracer_tpu_torch.integrator.render import Renderer

    opts = RenderOptions(
        sample_mode=_parse_mode(args.mode), tonemapping=not args.no_tonemap,
        ray_regen=max(args.regen, 0),
    )
    r = Renderer(args.scene, opts=opts, resolution=_parse_res(args.res),
                 trace_depth=args.depth, devices=args.devices, device=args.device)
    print(f"device: {r.device} ({_device_name(r.device)})", file=sys.stderr)
    r.set_seed(args.seed)
    if args.resume and Path(args.resume).exists():
        r.load_checkpoint(args.resume)
        print(f"resumed from {args.resume} at iteration {r.iteration}")
    total = args.spp if args.spp is not None else r.static.iterations
    out = Path(args.out) if args.out else Path(f"{r.static.image_name}.png")
    chunk = max(1, min(args.save_every or total, total))
    t0 = time.perf_counter()
    while r.iteration < total:
        stats = r.step(min(chunk, total - r.iteration))
        print(f"[{r.iteration}/{total}] {stats.mrays_per_sec:8.2f} Mrays/s  "
              f"{time.perf_counter() - t0:7.1f}s elapsed", flush=True)
        if args.save_every:
            r.save_png(out)
            if args.checkpoint:
                r.save_checkpoint(args.checkpoint)
    r.save_png(out)
    if args.hdr:
        r.save_hdr(out.with_suffix(".hdr"))
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    print(f"saved {out} ({r.iteration} spp)")
    return 0


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def cmd_bench(args) -> int:
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions

    opts = RenderOptions(sample_mode=_parse_mode(args.mode), ray_regen=max(args.regen, 0))
    r = Renderer(args.scene, opts=opts, resolution=_parse_res(args.res),
                 trace_depth=args.depth, devices=args.devices, device=args.device)
    print(f"device: {r.device} ({_device_name(r.device)})", file=sys.stderr)
    warm = r.step(1)  # kernel build + warm-up
    r.stats.wall_seconds = 0.0
    r.stats.rays_traced = 0
    spp = args.spp or 32
    stats = r.step(spp)
    result = {
        "scene": Path(args.scene).stem,
        "mode": args.mode,
        "resolution": [r.width, r.height],
        "spp": spp,
        "compile_seconds": round(warm.compile_seconds, 3),
        "wall_seconds": round(stats.wall_seconds, 4),
        "rays_traced": stats.rays_traced,
        "mrays_per_sec": round(stats.mrays_per_sec, 3),
    }
    print(json.dumps(result))
    return 0


def cmd_preview(args) -> int:
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.preview.server import run_preview
    from pathtracer_tpu_torch.utils.config import RenderOptions

    opts = RenderOptions(sample_mode=_parse_mode(args.mode))
    # no name here holds the renderer: a mode switch frees its tables
    run_preview(Renderer(args.scene, opts=opts, resolution=_parse_res(args.res),
                         trace_depth=args.depth, device=args.device),
                host=args.host, port=args.port, chunk=args.chunk, max_iterations=args.spp)
    return 0


def cmd_info(args) -> int:
    from pathtracer_tpu_torch.scene.flatscene import build_flat_scene
    from pathtracer_tpu_torch.scene.parser import load_scene

    scene = load_scene(args.scene)
    _, static = build_flat_scene(scene, device=args.device)
    info = {
        "scene": str(scene.path),
        "resolution": list(scene.camera.resolution),
        "iterations": static.iterations,
        "trace_depth": static.trace_depth,
        "geoms": static.num_geoms,
        "triangles": static.num_tris,
        "bvh_nodes": static.num_bvh_nodes,
        "bvh_trees": static.num_bvh_trees,
        "wide_nodes": static.wide_nodes,
        "wide_depth": static.wide_depth,
        # which kernels the mesh's tables serve: "resident" (K1/K2), "stream"
        # (K3/K4), or None where no kernel table fits (the MTBVH walk)
        "traversal": static.traversal if static.num_tris else None,
        "stream_top_nodes": static.stream_top,
        "stream_blocks": static.stream_subs,
        "stream_block_nodes": static.stream_sub_nodes,
        "stream_block_tris": static.stream_sub_tris,
        "materials": static.num_materials,
        "lights": static.num_lights,
        "textures": len(scene.textures),
        "env_map": static.env_map_id >= 0,
        "image_name": static.image_name,
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pathtracer_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_common(pr)
    pr.add_argument("-o", "--out", default=None, help="output PNG path")
    pr.add_argument("--hdr", action="store_true", help="also write Radiance .hdr")
    pr.add_argument("--save-every", type=int, default=None, help="progressive save interval (spp)")
    pr.add_argument("--checkpoint", default=None, help="checkpoint .npz path to write")
    pr.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="print scene statistics as JSON")
    pi.add_argument("scene")
    pi.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="measure Mrays/s")
    _add_common(pb)
    pb.set_defaults(fn=cmd_bench)

    pv = sub.add_parser("preview", help="interactive web preview (orbit camera)")
    _add_common(pv)
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--chunk", type=int, default=4, help="spp per display update")
    pv.set_defaults(fn=cmd_preview)

    args = parser.parse_args(argv)
    if getattr(args, "cpu", False):
        args.device = "cpu"
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError, RuntimeError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
