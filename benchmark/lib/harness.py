"""One run of one cell: set-up, the measured window, the traced run's
readings, and the comparison that decides `correct`.

The order within a run:

1. set-up (`setup_s`, from the runner's first line: the interpreter's own
   start, some tens of milliseconds, comes before it): the Renderer built from
   the configuration's scene file (the span `scene_tables_s`), the seed
   set (the graphs bake in the RNG key), and one warm-up iteration, which
   captures the cell's CUDA graphs (`capture_s`, the program's own
   `RenderStats.compile_seconds`);
2. the window: `Renderer.step` of the mix's samples a step, back to back,
   until `seconds` have passed; the rate counts every sample of the window
   over all its time, each step ending in the program's synchronize;
3. with a trace: one iteration at a time under torch.profiler (after the
   window, so no wall time is taken after a trace), until two traces agree
   with the program's K1-K5 launch counters; then, on a mesh scene, the
   closest-hit and shadow entries of `ops/traverse.py` on the benchmark's
   own rays, traced, for `walk_roofline_pct`;
4. the peak device memory read; the film copied to the host; the
   program's state freed; the reference run (lib/check.py).

`hooks` lets the tests break the timed path underneath (each a function of
the Renderer, run after its construction).
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np

from benchmark.lib import cells, check
from benchmark.lib import trace as tr_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): float32 outside
# the tensor cores, and device memory.  Frozen from chip_smoke.py at
# commit ac61a2f8, as are the operations of one box test (6 subtractions,
# 6 multiplications, 10 min/max, 2 comparisons, the comparison with the
# ray's cap) and one triangle test (27 multiplications, 19 additions or
# subtractions, 1 division, 1 select, 6 comparisons, the comparison with
# the ray's best t or window).
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
BOX_OPS, TRI_OPS = 25, 55
WALK_CALLS = 3     # calls of each traversal entry in the roofline's trace
TRACES, TRACE_TRIES = 2, 4


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load: JAX and its kin, and the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def _devices(r):
    return list(dict.fromkeys(r.mesh if r.devices > 1 else [r.device]))


def _sync(devs):
    import torch

    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _traced_iterations(r, devs):
    """Summaries of TRACES single-iteration traces whose K1-K5 runs match
    the program's launch counters (a trace that lost device events is
    traced again), and the film before the last traced iteration."""
    from pathtracer_tpu_torch.integrator import graphs

    good = []
    before = r.img
    for _ in range(TRACE_TRIES):
        k0 = sum(graphs.launch_counts())
        before = r.img
        s = tr_mod.summarize(tr_mod.record(lambda: r.step(1), lambda: _sync(devs)))
        s["k_expected"] = sum(graphs.launch_counts()) - k0
        if sum(s["traversal"].values()) == s["k_expected"]:
            good.append(s)
        if len(good) == TRACES:
            break
    return good, before


def _walk_roofline(r, ref, key, devs) -> dict | None:
    """The traversal kernels' least time on the benchmark's two ray sets
    (the film's camera rays; one shadow ray from each camera hit to a point
    on the lamp) against their time in a trace: box and triangle tests
    counted by the benchmark's own walk (reference/bvh.py), bytes of rays,
    outputs and the benchmark's tables each counted once."""
    import torch

    from benchmark.reference import bvh as bvh_mod
    from benchmark.reference import rng as ref_rng
    from benchmark.reference.render import normalize
    from pathtracer_tpu_torch.ops.traverse import closest_hit, occlusion_test

    if ref.bvh is None or not ref.sc.lights:
        return None
    dev = ref.device
    n = ref.sc.width * ref.sc.height
    pix = torch.arange(n, device=dev)
    o, d = ref.camera(key, 1, pix, pix)
    t_an = ref.analytic_closest(o, d)
    c1 = {"box": 0, "tri": 0}
    _, geom, _, point, _ = ref.closest(o, d)
    bvh_mod.walk_closest(ref.bvh, o, d, t_an, counts=c1)
    gi, _ = ref.sc.lights[0]
    xi = ref_rng.uniforms(key, 1, 0, ref_rng.STAGE_LIGHT, pix, 3)[:, 1:3]
    lamp, _ = ref.cone_sample(gi, point, xi)
    wi = normalize(lamp - point)
    so = point + 1e-5 * wi
    on = geom >= 0
    e = lamp - so
    min_t = torch.sqrt(torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2], min=0.0))
    walk_on = on & ~ref.analytic_occluded(so, wi, min_t)
    c2 = {"box": 0, "tri": 0}
    bvh_mod.walk_occluded(ref.bvh, so[walk_on], wi[walk_on], min_t[walk_on], on[walk_on], counts=c2)

    pd = r.flat.device
    args = [a.to(pd) for a in (o, d, so, wi, lamp, on)]

    def calls():
        for _ in range(WALK_CALLS):
            closest_hit(r.flat, r.static, args[0], args[1])
            occlusion_test(r.flat, r.static, args[2], args[3], args[4], enabled=args[5])

    from pathtracer_tpu_torch.integrator import graphs

    for _ in range(TRACE_TRIES):  # again where the trace lost a kernel's events
        k0 = sum(graphs.launch_counts())
        s = tr_mod.summarize(tr_mod.record(calls, lambda: _sync(devs)))
        if sum(s["traversal"].values()) == sum(graphs.launch_counts()) - k0:
            break
    else:
        return None
    closest_tags = [t for t in ("K1", "K3", "K5") if t in s["traversal_s"]]
    shadow_tags = [t for t in ("K2", "K4") if t in s["traversal_s"]]
    if not closest_tags or not shadow_tags:
        return None
    tables = ref.bvh.nbytes
    terms = {}
    for what, c, nb in (("closest", c1, tables + n * (28 + 16)),
                        ("shadow", c2, tables + n * (28 + 1 + 1))):
        ops_s = (c["box"] * BOX_OPS + c["tri"] * TRI_OPS) / PEAK_FLOPS
        bytes_s = nb / PEAK_BYTES
        terms[what] = {"bound_s": max(ops_s, bytes_s), "by": "operations" if ops_s >= bytes_s else "bytes",
                       "box": c["box"], "tri": c["tri"], "bytes": nb}
    kernel_s = {"closest": sum(s["traversal_s"][t] for t in closest_tags) / WALK_CALLS,
                "shadow": sum(s["traversal_s"][t] for t in shadow_tags) / WALK_CALLS}
    return {"bound_s": terms["closest"]["bound_s"] + terms["shadow"]["bound_s"],
            "kernel_s": kernel_s["closest"] + kernel_s["shadow"], "terms": terms,
            "kernels": kernel_s, "tags": closest_tags + shadow_tags}


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        resolution=None, hooks=(), start: float | None = None) -> dict:
    """Measure cell `name` once; returns the measurements and the compared
    numbers.  `start` is the perf_counter reading the set-up counts from
    (the runner's first line; the call by default)."""
    start = time.perf_counter() if start is None else start
    import torch

    from benchmark.reference import rng as ref_rng
    from benchmark.reference.render import Reference
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    c = cells.cell(name)
    cfg, mix = c["config"], c["traffic"]
    res = tuple(resolution or cfg["film"])
    scene = cells.ROOT / cfg["scene"]
    devices = int(cfg.get("devices", 1))
    mode = SampleMode[mix["mode"].upper()]
    opts = RenderOptions(sample_mode=mode, **mix.get("options", {}))
    spp = int(mix.get("samples_per_step", 1))
    m = {"cell": name, "width": res[0], "height": res[1], "chips": c["entry"]["chips"],
         "devices": devices}

    t0 = time.perf_counter()
    r = Renderer(scene, opts, resolution=res, trace_depth=cfg["depth"],
                 devices=devices if devices > 1 else None, device=device)
    m["scene_tables_s"] = time.perf_counter() - t0
    for hook in hooks:
        hook(r)
    devs = _devices(r)
    r.set_seed(seed)
    r.step(1)
    m["capture_s"] = r.stats.compile_seconds
    m["setup_s"] = time.perf_counter() - start

    t0 = time.perf_counter()
    samples, ends = 0, []
    while True:
        before = r.img
        r.step(spp)
        samples += spp
        ends.append(time.perf_counter() - t0)
        elapsed = ends[-1]
        if elapsed >= seconds:
            break
    steps = np.diff([0.0] + ends)
    m["quarters_ms"] = [round(float(np.mean(q)) * 1e3, 3) for q in np.array_split(steps, 4) if len(q)]
    m["steps_ms"] = [round(float(x) * 1e3, 3) for x in steps]
    m.update(window_s=elapsed, window_samples=samples, rays_traced=r.stats.rays_traced,
             samples_booked=r.stats.iterations_done - 1, lap_pools=list(r.lap_pools),
             graph_route=bool(r.graph_route))
    key = ref_rng.base_key(seed)
    m["traces"], last_step, phase = [], spp, {"window": elapsed}
    t0 = time.perf_counter()
    if trace:
        m["traces"], before = _traced_iterations(r, devs)
        last_step = 1
        phase["traces"] = time.perf_counter() - t0
    m["memory_peak_bytes"] = max((torch.cuda.max_memory_allocated(d) for d in devs if d.type == "cuda"),
                                 default=0)
    last = r.iteration
    film = r.hdr_sum().reshape(-1, 3).copy()
    kept, r.img = r.img, before
    film_before = r.hdr_sum().reshape(-1, 3).copy()
    r.img = kept
    swizzle = devices == 1 and bool(opts.swizzle) and r.static.num_tris > 0
    ref_dev = devs[0]
    walk = None
    if trace:
        t0 = time.perf_counter()
        ref = Reference(scene, ref_dev, resolution=res)
        walk = _walk_roofline(r, ref, key, devs)
        del ref
        phase["walk"] = time.perf_counter() - t0
    m["walk"] = walk
    t0 = time.perf_counter()
    del r, kept, before
    gc.collect()
    if ref_dev.type == "cuda":
        torch.cuda.empty_cache()
    phase["free"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref = Reference(scene, ref_dev, resolution=res)
    m["checks"] = check.compare(ref, key, mode == SampleMode.MIS, swizzle, film, film_before,
                                last - last_step + 1, last, check.film_sample(seed, res[0] * res[1]))
    phase["reference"] = time.perf_counter() - t0
    m["phase_s"] = phase
    return m
