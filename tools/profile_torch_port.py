"""Where the time goes on the PyTorch port's main path, on one GPU.

    python tools/profile_torch_port.py scenes/glasstorus160k.txt
    python tools/profile_torch_port.py scenes/envtorus.txt --env-importance
    python tools/profile_torch_port.py scenes/texcube.txt --no-compaction
    python tools/profile_torch_port.py scenes/texcube.txt --regen 8
    python tools/profile_torch_port.py scenes/glasstorus.txt --eager --res 128

Renders the scene MIS at 800x800 (`--res N`: N x N), depth 8, through
`Renderer(..., device="cuda")`, which replays its iteration as CUDA graphs
(`--eager`: the eager loop, `render_iteration`, as the CPU runs it), runs 3
iterations to warm up (the graphs' capture among them), times 2 on the
host's clock without the profiler, then traces 2 with torch.profiler and
prints, per iteration: the wall time without and under the profiler, the
device's busy time (sum of kernel times) and busy share, the device ops
(kernels, copies, fills; each kernel of a replayed graph counts), the
host-issued launches (the CUDA calls that put work on the device: kernel
and graph launches, copies, fills) apart from them, the bounce laps and the
pool's length at each lap of the last iteration, the graphs and their
replays, the most memory reserved, every host CUDA call by name, and the 12
kernels that take the most device time, with the traversal kernels (K1-K5)
named.  The card's name and power limit come
first.  `--env-importance` renders with RenderOptions(env_importance=True)
(the sky as a light); `--no-compaction` with compaction=False (no sort, no
shrink ladder: every lap over the whole pool); `--regen K` with ray_regen=K,
where each window (warm-up, timed, traced) is one batch of K samples per
pixel after the 1-sample warm-up and every figure is per sample.  Needs CUDA.
The scene's assets must exist: for glasstorus160k, write its OBJ first with
`tools/make_torus_obj.py` (see its docstring); for the textured scenes,
`tools/make_texture_assets.py`.
"""

from __future__ import annotations

import argparse
import contextlib
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


# host calls that put work on the device: kernels, graphs, copies and fills
HOST_LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


def profile_step(r, samples: int) -> dict:
    """`r.step(samples)` under torch.profiler: the wall seconds, and from
    the profiler's raw events (reading them raw takes a fraction of a second
    where `key_averages()` takes minutes for a few hundred thousand):

    - on the device (kernels, copies, fills; the kernels of a replayed CUDA
      graph each count), the busy microseconds, the count (`launches`) and,
      per name, (name, microseconds, count) sorted by time;
    - on the host, the CUDA API calls (`cuda*`, `cu*`) that put work on the
      device (`host_launches`: kernel launches, graph launches, copies,
      fills), of which `graph_launches` are graph replays, and every CUDA
      API call by name (`host_calls`) with its host microseconds
      (`host_us`);
    - the traversal kernels' runs on the device by tag (`traversal`, K1-K5:
      each count), which the launch counters must match;
    - per CUDA device index, its busy microseconds (`busy_by_card`) and its
      K1-K5 runs (`traversal_by_card`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(samples)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, host, host_us, by_card, trav_by_card = {}, {}, {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                us, count = by_name.get(name, (0.0, 0))
                by_name[name] = (us + e.duration_ns() / 1e3, count + 1)
                card = e.device_index()
                by_card[card] = by_card.get(card, 0.0) + e.duration_ns() / 1e3
                tag = next((t for kname, t in TRAVERSAL.items() if kname in name), None)
                if tag:
                    runs = trav_by_card.setdefault(card, dict.fromkeys(TRAVERSAL.values(), 0))
                    runs[tag] += 1
        elif name.startswith("cu"):
            host[name] = host.get(name, 0) + 1
            host_us[name] = host_us.get(name, 0.0) + e.duration_ns() / 1e3
    kernels = sorted(((name, us, n) for name, (us, n) in by_name.items()), key=lambda k: -k[1])
    traversal = dict.fromkeys(TRAVERSAL.values(), 0)
    for name, _, n in kernels:
        for kname, tag in TRAVERSAL.items():
            if kname in name:
                traversal[tag] += n
    return {"wall": wall, "kernels": kernels, "busy_us": sum(k[1] for k in kernels),
            "traversal": traversal, "busy_by_card": by_card, "traversal_by_card": trav_by_card,
            "launches": sum(k[2] for k in kernels), "host_calls": host, "host_us": host_us,
            "host_launches": sum(n for name, n in host.items()
                                 if any(w in name for w in HOST_LAUNCH_WORDS)),
            "graph_launches": sum(n for name, n in host.items() if "GraphLaunch" in name)}


@contextlib.contextmanager
def eager_route():
    """Inside the block every iteration runs its steps eagerly, as on the
    CPU: a Renderer its eager loop (`render_iteration`), the step factory
    too, a sharded step its shards' steps (`graphs.graph_route` is false):
    the graph route's yardstick on the card."""
    from pathtracer_tpu_torch.integrator import graphs

    was = graphs.graph_route
    graphs.graph_route = lambda static, opts, device: False
    try:
        yield
    finally:
        graphs.graph_route = was


def pool_runs(pools: list) -> str:
    """A list of pool lengths, one per lap, as runs: "640000 x2, 160768"."""
    runs = []
    for n in pools:
        if runs and runs[-1][0] == n:
            runs[-1][1] += 1
        else:
            runs.append([n, 1])
    return ", ".join(f"{n} x{k}" if k > 1 else str(n) for n, k in runs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene", type=Path)
    p.add_argument("--env-importance", action="store_true")
    p.add_argument("--no-compaction", action="store_true")
    p.add_argument("--regen", type=int, default=0, metavar="K")
    p.add_argument("--eager", action="store_true")
    p.add_argument("--res", type=int, default=RES)
    args = p.parse_args(argv)

    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    if not torch.cuda.is_available():
        print("profile_torch_port: needs CUDA", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    r = Renderer(args.scene, RenderOptions(sample_mode=SampleMode.MIS,
                                           env_importance=args.env_importance,
                                           compaction=not args.no_compaction,
                                           ray_regen=args.regen),
                 resolution=(args.res, args.res), trace_depth=DEPTH, device="cuda")
    # a window is one batch of K samples under regeneration, else ITERS iterations
    warm, iters = (1 + r.regen_k, r.regen_k) if r.regen_k else (WARM, ITERS)
    with eager_route() if args.eager else contextlib.nullcontext():
        route = "eager loop" if args.eager else "CUDA graphs"
        if r.graph_route == args.eager:
            print(f"profile_torch_port: this renderer does not take the {route}", file=sys.stderr)
            return 1
        r.step(warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step(iters)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        laps0, replays0 = r.stats.laps, r.graphs.replays if r.graphs else 0
        prof = profile_step(r, iters)
        laps, replays = r.stats.laps - laps0, (r.graphs.replays if r.graphs else 0) - replays0
    wall, kernels, busy_us, launches = prof["wall"], prof["kernels"], prof["busy_us"], prof["launches"]
    what = ", ".join([route, f"ray_regen={r.regen_k}" if r.regen_k else "classic"]
                     + (["compaction=False"] if args.no_compaction else [])
                     + (["env_importance"] if args.env_importance else []))
    graphs = (f"; {r.graphs.num_graphs} graphs captured in {r.graphs.capture_seconds:.3f} s, "
              f"{replays / iters:.1f} replays/iteration" if r.graphs else "")
    print(f"{args.scene.name} MIS {args.res}x{args.res} depth {DEPTH} ({what}), {iters} traced "
          f"samples/pixel after {warm}: wall {plain_wall / iters * 1e3:.3f} ms/iteration without "
          f"the profiler ({iters} iterations before the traced ones), {wall / iters * 1e3:.3f} "
          f"under it, device busy {busy_us / iters / 1e3:.3f} ms/iteration, busy share "
          f"{busy_us / 1e6 / wall:.4f}, {launches / iters:.0f} device ops (kernels, copies, fills)"
          f"/iteration, {prof['host_launches'] / iters:.0f} host-issued launches/iteration (graph "
          f"launches {prof['graph_launches'] / iters:.0f}), {laps / iters:.3f} laps/sample; pool "
          f"length at each lap of the last {'batch' if r.regen_k else 'iteration'}: "
          f"{pool_runs(r.lap_pools)}{graphs}; memory reserved "
          f"{torch.cuda.max_memory_reserved() / 2**20:.1f} MiB at most")
    print("host CUDA calls/iteration: " + ", ".join(
        f"{name} {n / iters:.1f}" for name, n in sorted(prof["host_calls"].items(),
                                                        key=lambda kv: -kv[1])))
    trav = {}
    for name, us, _ in kernels:
        tag = next((k for kname, k in TRAVERSAL.items() if kname in name), None)
        if tag:
            trav[tag] = trav.get(tag, 0.0) + us
    for name, us, count in kernels[:TOP]:
        tag = next((k for kname, k in TRAVERSAL.items() if kname in name), "")
        print(f"  {us / iters / 1e3:9.3f} ms/iteration  {count / iters:7.1f} launches  {tag:2s} {name[:90]}")
    for tag in sorted(trav):
        print(f"{tag}: {trav[tag] / iters / 1e3:.3f} ms/iteration, {trav[tag] / busy_us:.4f} of device "
              f"busy time, {trav[tag] / 1e6 / wall:.4f} of wall time")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
