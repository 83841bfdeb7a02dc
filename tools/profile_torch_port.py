"""Where the time goes on the PyTorch port's main path, on one GPU.

    python tools/profile_torch_port.py scenes/glasstorus160k.txt
    python tools/profile_torch_port.py scenes/envtorus.txt --env-importance

Renders the scene MIS at 800x800, depth 8, through
`Renderer(..., device="cuda")`, runs 3 iterations to warm up, times 2 on the
host's clock without the profiler, then traces 2 with torch.profiler and
prints, per iteration: the wall time without and under the profiler, the
device's busy time (sum of kernel times) and busy share, the number of
kernel launches, and the 12 kernels that take the most device time, with
the traversal kernels (K1-K5) named.  The card's name and power limit come
first.  `--env-importance` renders with RenderOptions(env_importance=True)
(the sky as a light).  Needs CUDA.  The scene's assets must exist: for
glasstorus160k, write its OBJ first with `tools/make_torus_obj.py` (see its
docstring); for the textured scenes, `tools/make_texture_assets.py`.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
RES, DEPTH, WARM, ITERS, TOP = 800, 8, 3, 2, 12
TRAVERSAL = {
    "closest_hit_wbvh_kernel": "K1", "occlusion_wbvh_kernel": "K2",
    "closest_hit_stream_kernel": "K3", "occlusion_stream_kernel": "K4",
    "closest_hit_blockmajor_kernel": "K5",
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene", type=Path)
    p.add_argument("--env-importance", action="store_true")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    if not torch.cuda.is_available():
        print("profile_torch_port: needs CUDA", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    r = Renderer(args.scene, RenderOptions(sample_mode=SampleMode.MIS,
                                           env_importance=args.env_importance),
                 resolution=(RES, RES), trace_depth=DEPTH, device="cuda")
    r.step(WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.step(ITERS)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"{args.scene.name} MIS {RES}x{RES} depth {DEPTH}, {ITERS} traced iterations "
          f"after {WARM}: wall {plain_wall / ITERS * 1e3:.3f} ms/iteration without the profiler "
          f"({ITERS} iterations before the traced ones), {wall / ITERS * 1e3:.3f} under it, device "
          f"busy {busy_us / ITERS / 1e3:.3f} ms/iteration, busy share {busy_us / 1e6 / wall:.4f}, "
          f"{launches / ITERS:.0f} kernel launches/iteration")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    trav = {}
    for e in kernels:
        tag = next((k for name, k in TRAVERSAL.items() if name in e.key), None)
        if tag:
            trav[tag] = trav.get(tag, 0.0) + e.self_device_time_total
    for e in kernels[:TOP]:
        tag = next((k for name, k in TRAVERSAL.items() if name in e.key), "")
        print(f"  {e.self_device_time_total / ITERS / 1e3:9.3f} ms/iteration  {e.count / ITERS:7.1f} "
              f"launches  {tag:2s} {e.key[:90]}")
    for tag in sorted(trav):
        print(f"{tag}: {trav[tag] / ITERS / 1e3:.3f} ms/iteration, {trav[tag] / busy_us:.4f} of device "
              f"busy time, {trav[tag] / 1e6 / wall:.4f} of wall time")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
