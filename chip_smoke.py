"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero without a result
line):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the kernels from pathtracer_tpu_torch/csrc with nvcc (one
   process per source, in parallel) and prints ptxas's registers, stack
   frame and spills for each kernel;
3. resident kernel parity on scenes/glasstorus.txt (10,000 triangles) at
   800x800: K1 (closest hit) and K2 (shadow any-hit) against their plain
   PyTorch versions on the card, on the 640,000 camera rays and one bounce's
   continuation rays, plus dead-lane and t-cap variants; median times;
4. stream kernel parity on scenes/glasstorus160k.txt (160,000 triangles,
   past the resident budget) at 800x800, on the same kinds of rays: K3
   (closest hit) and K4 (shadow any-hit) against their plain versions, and
   against K1/K2 on the same mesh's wide tables (t bitwise equal, occlusion
   equal: a lost or doubled triangle of the split would show); median times;
5. main paths, as a user calls them: Renderer(scene, MIS, device="cuda") at
   800x800, depth 8, 8 spp, for glasstorus (must launch K1 and K2) and for
   glasstorus160k (must launch K3 and K4, and neither K1 nor K2); launch
   counts are zeroed just before each path and read just after;
6. card against CPU: each scene at 64x64, depth 8, 2 spp, MIS, rendered on
   "cuda" and on "cpu", held to the CPU slice test's image tolerance.

The line before the last is a JSON object with one entry per kernel (times,
errors, launches, and the least time the card could take for the same work);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "glasstorus.txt"
SCENE_160K = ROOT / "scenes" / "glasstorus160k.txt"
TORUS_160K = (ROOT / "scenes" / "assets" / "torus160k.obj", 400, 200)
RES, DEPTH, SPP = 800, 8, 8
IMG_RTOL, IMG_ATOL, IMG_MIN_FRAC = 1e-4, 1e-5, 0.999  # tests/test_torch_render.py
KERNEL_RTOL = 1e-5
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): float32 outside the
# tensor cores, and device memory.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Operations of one box test (csrc/traverse_common.cuh slab: 6 subtractions,
# 6 multiplications, 10 min/max, 2 comparisons, and the comparison with the
# ray's cap) and one triangle test (moller_trumbore: 27 multiplications, 19
# additions or subtractions, 1 division, 1 select, 6 comparisons, and the
# comparison with the ray's best t or window).
BOX_OPS, TRI_OPS = 25, 55
SRC_RESIDENT = "pathtracer_tpu_torch/csrc/wbvh_traverse.cu"
SRC_STREAM = "pathtracer_tpu_torch/csrc/stream_traverse.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int = 5) -> float:
    """Median milliseconds of fn() over `runs` runs, timed with CUDA events
    after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_out_bytes: int, counts: dict) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes the call must move over
    the memory rate and the operations its walk does over the float32 rate."""
    ops = counts["box"] * BOX_OPS + counts["tri"] * TRI_OPS
    bytes_ms = in_out_bytes / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        raise SystemExit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(f"nvidia-smi: {smi}")
    return name


def phase_build():
    from pathtracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({len(_build._sources())} sources, one nvcc each, in parallel)")
    for kernel, props in sorted(_build.ptxas_report().items()):
        log(f"ptxas {kernel}: {props.get('registers')} registers, "
            f"{props.get('stack_bytes')} bytes stack frame, "
            f"{props.get('spill_store_bytes')} bytes spill stores, "
            f"{props.get('spill_load_bytes')} bytes spill loads")


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def ray_cases(scene_path):
    """The main path's rays on `scene_path` at RES x RES: camera rays and one
    bounce's continuation rays (with dead-lane and t-cap variants) for the
    closest-hit kernels, NEE shadow rays toward the lamp (plain, and with
    occluded0 every 7th lane and 25% of lanes at -FLT_MAX) for the any-hit
    kernels."""
    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.integrator.wavefront import _Pool, bounce, camera_rays
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    r = Renderer(scene_path, RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(RES, RES), trace_depth=DEPTH, device="cuda")
    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    n = o.shape[0]
    t_geo, *_ = tv._geoms_closest(flat, static, o, d)
    t_cam = tv._root_box_cull(static, o, d, t_geo)
    pool = _Pool(o=o, d=d, color=torch.ones_like(o), contrib=torch.zeros_like(o),
                 prev_pdf=torch.full((n,), -1.0, device=o.device),
                 alive=torch.ones((n,), dtype=torch.bool, device=o.device))
    pool, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, 0, pool)
    o2, d2 = pool.o, pool.d
    t_geo2, *_ = tv._geoms_closest(flat, static, o2, d2)
    t_cont = tv._root_box_cull(static, o2, d2, torch.where(pool.alive, t_geo2, tv.DEAD_T))
    gen = torch.Generator(device="cuda").manual_seed(0)
    dead = torch.rand(n, device="cuda", generator=gen) < 0.25
    closest = {
        "camera": (o, d, t_cam),
        "continuation": (o2, d2, t_cont),
        "camera, 25% dead": (o, d, torch.where(dead, tv.DEAD_T, t_cam)),
        "continuation, t cap 2.0": (o2, d2, torch.clamp(t_cont, max=2.0)),
    }
    hit0 = tv.closest_hit(flat, static, o, d)
    lamp = flat.geom_transform[static.analytic_lights[0][1]][:3, 3]
    to_l = lamp[None, :] - hit0.point
    min_t = torch.sqrt((to_l * to_l).sum(1))
    sd = to_l / min_t[:, None]
    so = hit0.point + 1e-5 * sd
    occ0 = torch.arange(n, device="cuda") % 7 == 0
    shadow = {
        "NEE": (so, sd, min_t, torch.zeros_like(occ0)),
        "NEE, occluded0 every 7th, 25% -FLT_MAX": (so, sd, torch.where(dead, tv.DEAD_T, min_t), occ0),
    }
    torch.cuda.synchronize()
    return r, closest, shadow


def check_closest(label, kname, got, ref, n):
    """Kernel against its plain version: tri identical on every lane, t/u/v
    within KERNEL_RTOL on hits and identical on misses; returns the largest
    absolute t/u/v difference on hits."""
    import torch

    same_tri = torch.equal(got[1], ref[1])
    hit = ref[1] >= 0
    errs = [_max_err(a[hit], b[hit]) for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3]))]
    miss_same = torch.equal(got[0][~hit], ref[0][~hit])
    log(f"{kname} {label}: {n} lanes, {int(hit.sum())} hits, tri identical: {same_tri}, "
        f"t/u/v max abs err {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}, miss t identical: {miss_same}")
    if not (same_tri and miss_same):
        raise AssertionError(f"{kname} disagrees with its plain version ({label})")
    for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(a[hit], b[hit], rtol=KERNEL_RTOL, atol=0.0)
    return max(errs)


def check_shadow(label, kname, got, ref, mt, o0, n):
    import torch

    same = torch.equal(got, ref)
    kept, clear = bool(got[o0].all()), not bool(got[(mt < 0) & ~o0].any())
    log(f"{kname} {label}: {n} lanes, {int(ref.sum())} blocked, identical: {same}, "
        f"occluded0 kept: {kept}, -FLT_MAX lanes clear: {clear}")
    if not (same and kept and clear):
        raise AssertionError(f"{kname} disagrees with its plain version ({label})")
    return float((got != ref).any())  # |a - b| of booleans


def phase_resident_kernels():
    """K1/K2 against their plain versions at the glasstorus main path's shapes."""
    from pathtracer_tpu_torch.ops import traverse_cuda as tc

    r, closest, shadow = ray_cases(SCENE)
    flat, static = r.flat, r.static
    tables = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k1 = lambda ro, rd, t0: tc.closest_hit_wbvh(*tables, ro, rd, t0, wide_depth=static.wide_depth)
    k1_err = 0.0
    for label, (ro, rd, t0) in closest.items():
        k1_err = max(k1_err, check_closest(label, "K1", k1(ro, rd, t0),
                                           tc.closest_hit_wbvh_plain(*tables, ro, rd, t0), ro.shape[0]))
    k2_tables = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk)
    k2 = lambda so, sd, mt, o0: tc.occlusion_wbvh(*k2_tables, so, sd, mt, o0, wide_depth=static.wide_depth)
    k2_err = 0.0
    for label, (so, sd, mt, o0) in shadow.items():
        k2_err = max(k2_err, check_shadow(label, "K2", k2(so, sd, mt, o0),
                                          tc.occlusion_wbvh_plain(*k2_tables, so, sd, mt, o0),
                                          mt, o0, so.shape[0]))
    ro, rd, t0 = closest["continuation"]
    so, sd, mt, o0 = shadow["NEE"]
    n = ro.shape[0]
    k1_ms = cuda_ms(lambda: k1(ro, rd, t0))
    k1_plain_ms = cuda_ms(lambda: tc.closest_hit_wbvh_plain(*tables, ro, rd, t0))
    k2_ms = cuda_ms(lambda: k2(so, sd, mt, o0))
    k2_plain_ms = cuda_ms(lambda: tc.occlusion_wbvh_plain(*k2_tables, so, sd, mt, o0))
    c1, c2 = {"box": 0, "tri": 0}, {"box": 0, "tri": 0}
    tc.closest_hit_wbvh_plain(*tables, ro, rd, t0, counts=c1)
    tc.occlusion_wbvh_plain(*k2_tables, so, sd, mt, o0, counts=c2)
    b1 = bound(nbytes(*tables, ro, rd, t0) + 16 * n, c1)
    b2 = bound(nbytes(*k2_tables, so, sd, mt, o0) + n, c2)
    log(f"K1 time at {n} continuation rays: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms "
        f"(median of 5); walk {c1['box']} box + {c1['tri']} triangle tests, bound {b1[0]:.4f} ms ({b1[1]})")
    log(f"K2 time at {n} NEE shadow rays: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms "
        f"(median of 5); walk {c2['box']} box + {c2['tri']} triangle tests, bound {b2[0]:.4f} ms ({b2[1]})")
    return {
        "K1": ("closest_hit_wbvh", SRC_RESIDENT, "pathtracer_tpu/ops/traverse_pallas.py:418",
               k1_err, k1_ms, k1_plain_ms, b1),
        "K2": ("occlusion_wbvh", SRC_RESIDENT, "pathtracer_tpu/ops/traverse_pallas.py:1529",
               k2_err, k2_ms, k2_plain_ms, b2),
    }


def phase_stream_kernels():
    """K3/K4 against their plain versions, and against K1/K2 on the same
    mesh, at the glasstorus160k main path's shapes."""
    import torch

    from pathtracer_tpu_torch.ops import traverse_cuda as tc
    from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts

    r, closest, shadow = ray_cases(SCENE_160K)
    flat, static = r.flat, r.static
    log(f"glasstorus160k: {static.num_tris} triangles, {static.wide_nodes} wide nodes "
        f"(depth {static.wide_depth}), {static.stream_top} top nodes, {static.stream_subs} blocks of "
        f"{static.stream_sub_nodes} nodes / {static.stream_sub_tris} triangles, walk depths "
        f"top {static.stream_top_depth} block {static.stream_sub_depth}")
    if static.stream_subs == 0:
        raise AssertionError("glasstorus160k did not take the streaming tables")
    sizes = dict(sub_nodes=static.stream_sub_nodes, sub_tris=static.stream_sub_tris)
    depths = dict(top_depth=static.stream_top_depth, sub_depth=static.stream_sub_depth)
    k3_tables = (flat.str_topf, flat.str_topl, flat.str_topp, flat.str_subf, flat.str_subi,
                 flat.str_subp, flat.str_subt, flat.str_base)
    k4_tables = (flat.str_topf, flat.str_topl, flat.str_subf, flat.str_subi, flat.str_subt,
                 flat.str_base)
    k1_tables = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k2_tables = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk)
    k3 = lambda ro, rd, t0: ts.closest_hit_stream(*k3_tables, ro, rd, t0, **sizes, **depths)
    k3_plain = lambda ro, rd, t0, **kw: ts.closest_hit_stream_plain(*k3_tables, ro, rd, t0, **sizes, **kw)
    k4 = lambda so, sd, mt, o0: ts.occlusion_stream(*k4_tables, so, sd, mt, o0, **sizes, **depths)
    k4_plain = lambda so, sd, mt, o0, **kw: ts.occlusion_stream_plain(*k4_tables, so, sd, mt, o0, **sizes, **kw)

    k3_err = 0.0
    for label, (ro, rd, t0) in closest.items():
        got = k3(ro, rd, t0)
        k3_err = max(k3_err, check_closest(label, "K3", got, k3_plain(ro, rd, t0), ro.shape[0]))
        # the same rays through K1 on the same mesh's wide tables
        k1 = tc.closest_hit_wbvh(*k1_tables, ro, rd, t0, wide_depth=static.wide_depth)
        torch.cuda.synchronize()
        t_same = torch.equal(got[0], k1[0])
        tri_diff = int((got[1] != k1[1]).sum())
        log(f"K3 vs K1 {label}: t bitwise equal: {t_same}, tri differs on {tri_diff} lanes "
            f"(each an exact-t tie, as t is equal)")
        if not t_same:
            raise AssertionError(f"K3 and K1 disagree on t ({label})")
    k4_err = 0.0
    for label, (so, sd, mt, o0) in shadow.items():
        got = k4(so, sd, mt, o0)
        k4_err = max(k4_err, check_shadow(label, "K4", got, k4_plain(so, sd, mt, o0), mt, o0, so.shape[0]))
        k2 = tc.occlusion_wbvh(*k2_tables, so, sd, mt, o0, wide_depth=static.wide_depth)
        torch.cuda.synchronize()
        same = torch.equal(got, k2)
        log(f"K4 vs K2 {label}: identical: {same}")
        if not same:
            raise AssertionError(f"K4 and K2 disagree ({label})")

    ro, rd, t0 = closest["continuation"]
    so, sd, mt, o0 = shadow["NEE"]
    n = ro.shape[0]
    k3_ms = cuda_ms(lambda: k3(ro, rd, t0))
    k3_plain_ms = cuda_ms(lambda: k3_plain(ro, rd, t0))
    k4_ms = cuda_ms(lambda: k4(so, sd, mt, o0))
    k4_plain_ms = cuda_ms(lambda: k4_plain(so, sd, mt, o0))
    k1_ms = cuda_ms(lambda: tc.closest_hit_wbvh(*k1_tables, ro, rd, t0, wide_depth=static.wide_depth))
    k2_ms = cuda_ms(lambda: tc.occlusion_wbvh(*k2_tables, so, sd, mt, o0, wide_depth=static.wide_depth))
    c3, c4 = {"box": 0, "tri": 0}, {"box": 0, "tri": 0}
    k3_plain(ro, rd, t0, counts=c3)
    k4_plain(so, sd, mt, o0, counts=c4)
    b3 = bound(nbytes(*k3_tables, ro, rd, t0) + 16 * n, c3)
    b4 = bound(nbytes(*k4_tables, so, sd, mt, o0) + n, c4)
    log(f"K3 time at {n} continuation rays of glasstorus160k: kernel {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.4f} ms (median of 5); walk {c3['box']} box + {c3['tri']} triangle tests, "
        f"bound {b3[0]:.4f} ms ({b3[1]}); K1 on the same rays and mesh {k1_ms:.4f} ms")
    log(f"K4 time at {n} NEE shadow rays of glasstorus160k: kernel {k4_ms:.4f} ms, plain "
        f"{k4_plain_ms:.4f} ms (median of 5); walk {c4['box']} box + {c4['tri']} triangle tests, "
        f"bound {b4[0]:.4f} ms ({b4[1]}); K2 on the same rays and mesh {k2_ms:.4f} ms")
    return {
        "K3": ("closest_hit_stream", SRC_STREAM, "pathtracer_tpu/ops/traverse_pallas.py:871",
               k3_err, k3_ms, k3_plain_ms, b3),
        "K4": ("occlusion_stream", SRC_STREAM, "pathtracer_tpu/ops/traverse_pallas.py:1448",
               k4_err, k4_ms, k4_plain_ms, b4),
    }


def launch_counts() -> dict:
    from pathtracer_tpu_torch.ops import traverse_cuda as tc
    from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts

    return {"K1": tc.closest_launches, "K2": tc.occlusion_launches,
            "K3": ts.closest_launches, "K4": ts.occlusion_launches}


def phase_main_path(scene_path, used: tuple, unused: tuple) -> dict:
    """The port's main path on `scene_path`, as a user calls it; the kernels
    in `used` must launch and those in `unused` must not."""
    import numpy as np

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.ops import traverse_cuda as tc
    from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t0 = time.perf_counter()
    scene = load_scene(scene_path)
    t1 = time.perf_counter()
    r = Renderer(scene, RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(RES, RES), trace_depth=DEPTH, device="cuda")
    t2 = time.perf_counter()
    tc.reset_launch_counts()
    ts.reset_launch_counts()
    stats = r.step(SPP)
    launches = launch_counts()
    img = r.hdr_sum() / r.iteration
    out = ROOT / "pathtracer_tpu_torch" / "_build" / f"{r.static.image_name}_mis_{RES}.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    r.save_png(out)
    log(f"main path: {scene_path.name} MIS {RES}x{RES} depth {DEPTH} {SPP} spp: "
        f"{stats.mrays_per_sec:.3f} Mrays/s, {stats.rays_traced} rays in "
        f"{stats.wall_seconds:.3f} s wall over {stats.iterations_done - 1} timed iterations "
        f"({statistics.mean(stats.per_iter_seconds):.4f} s/iteration; warm-up "
        f"{stats.compile_seconds:.3f} s); host set-up: parse {t1 - t0:.3f} s, tables (BVH, "
        f"wide collapse, stream split, upload) {t2 - t1:.3f} s; launches {launches}, "
        f"image mean {float(img.mean()):.5f}, saved {out.relative_to(ROOT)}")
    if not all(launches[k] > 0 for k in used) or any(launches[k] for k in unused):
        raise AssertionError(f"main path on {scene_path.name} launched {launches}; "
                             f"needs {used} and none of {unused}")
    if not (np.isfinite(img).all() and img.mean() > 0 and stats.rays_traced > 0):
        raise AssertionError("main path image is not finite and positive")
    return launches


def phase_card_vs_cpu(scene_path):
    import numpy as np

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    imgs = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(scene_path, RenderOptions(sample_mode=SampleMode.MIS),
                     resolution=(64, 64), trace_depth=DEPTH, device=dev)
        r.step(2)
        imgs[dev] = r.hdr_sum()
    ok = np.isclose(imgs["cuda"], imgs["cpu"], rtol=IMG_RTOL, atol=IMG_ATOL).all(-1)
    log(f"card vs cpu: {scene_path.name} MIS 64x64 depth {DEPTH} 2 spp: {ok.mean():.5f} of pixels "
        f"within rtol {IMG_RTOL} atol {IMG_ATOL} ({int((~ok).sum())} outliers; need >= {IMG_MIN_FRAC})")
    if ok.mean() < IMG_MIN_FRAC:
        raise AssertionError(f"card and CPU renders of {scene_path.name} disagree")


def main() -> int:
    t_start = time.perf_counter()
    name = phase_device()
    import torch

    from tools.make_torus_obj import ensure_torus_obj

    phase_build()
    t0 = time.perf_counter()
    ensure_torus_obj(*TORUS_160K)
    log(f"{TORUS_160K[0].relative_to(ROOT)}: ready in {time.perf_counter() - t0:.2f} s")
    kernels = {**phase_resident_kernels(), **phase_stream_kernels()}
    launches = phase_main_path(SCENE, used=("K1", "K2"), unused=("K3", "K4"))
    stream_launches = phase_main_path(SCENE_160K, used=("K3", "K4"), unused=("K1", "K2"))
    launches.update(K3=stream_launches["K3"], K4=stream_launches["K4"])
    phase_card_vs_cpu(SCENE)
    phase_card_vs_cpu(SCENE_160K)
    rows = [
        {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        for key, (name_, source, replaces, err, ms, plain_ms, (bound_ms, bound_by))
        in kernels.items()
    ]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
