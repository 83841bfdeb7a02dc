"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero without a result
line):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the kernels from pathtracer_tpu_torch/csrc with nvcc;
3. kernel parity at the main path's shapes: K1 (closest hit) and K2 (shadow
   any-hit) against their plain PyTorch versions on the card, on the 640,000
   camera rays of an 800x800 frame of scenes/glasstorus.txt and on one
   bounce's continuation rays, plus dead-lane and t-cap variants; median
   times over 5 runs each;
4. main path: Renderer(glasstorus, MIS, device="cuda") at 800x800, depth 8,
   8 spp; both kernels must have launched;
5. card against CPU: the same scene at 64x64, 2 spp, MIS, rendered on
   "cuda" and on "cpu", held to the CPU slice test's image tolerance.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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
RES, DEPTH, SPP = 800, 8, 8
IMG_RTOL, IMG_ATOL, IMG_MIN_FRAC = 1e-4, 1e-5, 0.999  # tests/test_torch_render.py
KERNEL_RTOL = 1e-5


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

    fresh = not (_build.BUILD_DIR / _build.LIB_NAME).exists()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'nvcc from pathtracer_tpu_torch/csrc' if fresh else 'library already built'})")


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernels():
    """K1/K2 against their plain versions at the main path's shapes."""
    import torch

    from pathtracer_tpu.scene.parser import load_scene
    from pathtracer_tpu.utils.config import RenderOptions, SampleMode
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.integrator.wavefront import _Pool, bounce, camera_rays
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.ops import traverse_cuda as tc

    scene = load_scene(SCENE)
    r = Renderer(scene, RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(RES, RES), trace_depth=DEPTH, device="cuda")
    flat, static = r.flat, r.static
    cam = r._cam_arrays()
    o, d = camera_rays(cam, RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    n = o.shape[0]
    # camera rays with their analytic t budget, root-box culled as the main path does
    t_geo, *_ = tv._geoms_closest(flat, static, o, d)
    t_cam = tv._root_box_cull(static, o, d, t_geo)
    # one bounce's continuation rays, from the port's own first bounce
    pool = _Pool(o=o, d=d, color=torch.ones_like(o), contrib=torch.zeros_like(o),
                 prev_pdf=torch.full((n,), -1.0, device=o.device),
                 alive=torch.ones((n,), dtype=torch.bool, device=o.device))
    pool, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, 0, pool)
    o2, d2 = pool.o, pool.d
    t_geo2, *_ = tv._geoms_closest(flat, static, o2, d2)
    t_cont = tv._root_box_cull(static, o2, d2, torch.where(pool.alive, t_geo2, tv.DEAD_T))
    gen = torch.Generator(device="cuda").manual_seed(0)
    dead = torch.rand(n, device="cuda", generator=gen) < 0.25
    k1_cases = {
        "camera": (o, d, t_cam),
        "continuation": (o2, d2, t_cont),
        "camera, 25% dead": (o, d, torch.where(dead, tv.DEAD_T, t_cam)),
        "continuation, t cap 2.0": (o2, d2, torch.clamp(t_cont, max=2.0)),
    }
    tables = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k1_err = 0.0
    for label, (ro, rd, t0) in k1_cases.items():
        got = tc.closest_hit_wbvh(*tables, ro, rd, t0, wide_depth=static.wide_depth)
        ref = tc.closest_hit_wbvh_plain(*tables, ro, rd, t0)
        torch.cuda.synchronize()
        same_tri = torch.equal(got[1], ref[1])
        hit = ref[1] >= 0
        errs = [_max_err(a[hit], b[hit]) for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3]))]
        for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
            torch.testing.assert_close(a[hit], b[hit], rtol=KERNEL_RTOL, atol=0.0)
        miss_same = torch.equal(got[0][~hit], ref[0][~hit])
        log(f"K1 {label}: {n} lanes, {int(hit.sum())} hits, tri identical: {same_tri}, "
            f"t/u/v max abs err {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}, miss t identical: {miss_same}")
        if not (same_tri and miss_same):
            raise AssertionError(f"K1 disagrees with its plain version ({label})")
        k1_err = max(k1_err, *errs)

    # shadow rays from the first hits toward the lamp, as NEE casts them
    hit0 = tv.closest_hit(flat, static, o, d)
    lamp = flat.geom_transform[static.analytic_lights[0][1]][:3, 3]
    to_l = lamp[None, :] - hit0.point
    min_t = torch.sqrt((to_l * to_l).sum(1))
    sd = to_l / min_t[:, None]
    so = hit0.point + 1e-5 * sd
    lane = torch.arange(n, device="cuda")
    occ0 = lane % 7 == 0
    k2_cases = {
        "NEE": (min_t, torch.zeros_like(occ0)),
        "NEE, occluded0 every 7th, 25% -FLT_MAX": (torch.where(dead, tv.DEAD_T, min_t), occ0),
    }
    k2_err = 0.0
    for label, (mt, o0) in k2_cases.items():
        got = tc.occlusion_wbvh(flat.bvh_wf, flat.bvh_wi, flat.tri_pk, so, sd, mt, o0,
                                wide_depth=static.wide_depth)
        ref = tc.occlusion_wbvh_plain(flat.bvh_wf, flat.bvh_wi, flat.tri_pk, so, sd, mt, o0)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        k2_err = max(k2_err, float((got != ref).any()))  # |a - b| of booleans
        log(f"K2 {label}: {n} lanes, {int(ref.sum())} blocked, identical: {same}, "
            f"occluded0 kept: {bool(got[o0].all())}, -FLT_MAX lanes clear: "
            f"{not bool(got[(mt < 0) & ~o0].any())}")
        if not same or not bool(got[o0].all()) or bool(got[(mt < 0) & ~o0].any()):
            raise AssertionError(f"K2 disagrees with its plain version ({label})")

    ro, rd, t0 = k1_cases["continuation"]
    k1_ms = cuda_ms(lambda: tc.closest_hit_wbvh(*tables, ro, rd, t0, wide_depth=static.wide_depth))
    k1_plain_ms = cuda_ms(lambda: tc.closest_hit_wbvh_plain(*tables, ro, rd, t0))
    mt, o0 = k2_cases["NEE"]
    k2_args = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk, so, sd, mt, o0)
    k2_ms = cuda_ms(lambda: tc.occlusion_wbvh(*k2_args, wide_depth=static.wide_depth))
    k2_plain_ms = cuda_ms(lambda: tc.occlusion_wbvh_plain(*k2_args))
    log(f"K1 time at {n} continuation rays: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms (median of 5)")
    log(f"K2 time at {n} NEE shadow rays: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms (median of 5)")
    return {
        "K1": ("closest_hit_wbvh", "pathtracer_tpu/ops/traverse_pallas.py:418", k1_err, k1_ms, k1_plain_ms),
        "K2": ("occlusion_wbvh", "pathtracer_tpu/ops/traverse_pallas.py:1529", k2_err, k2_ms, k2_plain_ms),
    }


def phase_main_path():
    """The port's main path, as a user calls it, through both kernels."""
    import numpy as np
    import torch

    from pathtracer_tpu.utils.config import RenderOptions, SampleMode
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.ops import traverse_cuda as tc

    r = Renderer(SCENE, RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(RES, RES), trace_depth=DEPTH, device="cuda")
    tc.reset_launch_counts()
    stats = r.step(SPP)
    launches = {"K1": tc.closest_launches, "K2": tc.occlusion_launches}
    img = r.hdr_sum() / r.iteration
    out = ROOT / "pathtracer_tpu_torch" / "_build" / "glasstorus_mis_800.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    r.save_png(out)
    log(f"main path: glasstorus MIS {RES}x{RES} depth {DEPTH} {SPP} spp: "
        f"{stats.mrays_per_sec:.3f} Mrays/s, {stats.rays_traced} rays in "
        f"{stats.wall_seconds:.3f} s wall over {stats.iterations_done - 1} timed iterations "
        f"({statistics.mean(stats.per_iter_seconds):.4f} s/iteration; warm-up "
        f"{stats.compile_seconds:.3f} s), launches K1 {launches['K1']} K2 {launches['K2']}, "
        f"image mean {float(img.mean()):.5f}, saved {out.relative_to(ROOT)}")
    if not (launches["K1"] > 0 and launches["K2"] > 0):
        raise AssertionError(f"main path did not launch both kernels: {launches}")
    if not (np.isfinite(img).all() and img.mean() > 0 and stats.rays_traced > 0):
        raise AssertionError("main path image is not finite and positive")
    return launches


def phase_card_vs_cpu():
    import numpy as np

    from pathtracer_tpu.utils.config import RenderOptions, SampleMode
    from pathtracer_tpu_torch.integrator.render import Renderer

    imgs = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(SCENE, RenderOptions(sample_mode=SampleMode.MIS),
                     resolution=(64, 64), trace_depth=DEPTH, device=dev)
        r.step(2)
        imgs[dev] = r.hdr_sum()
    ok = np.isclose(imgs["cuda"], imgs["cpu"], rtol=IMG_RTOL, atol=IMG_ATOL).all(-1)
    log(f"card vs cpu: glasstorus MIS 64x64 depth {DEPTH} 2 spp: {ok.mean():.5f} of pixels "
        f"within rtol {IMG_RTOL} atol {IMG_ATOL} ({int((~ok).sum())} outliers; need >= {IMG_MIN_FRAC})")
    if ok.mean() < IMG_MIN_FRAC:
        raise AssertionError("card and CPU renders disagree")


def main() -> int:
    name = phase_device()
    import torch

    phase_build()
    kernels = phase_kernels()
    launches = phase_main_path()
    phase_card_vs_cpu()
    rows = [
        {"name": name_, "route": "cuda", "source": "pathtracer_tpu_torch/csrc/wbvh_traverse.cu",
         "replaces": replaces, "launches": launches[key], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms}
        for key, (name_, replaces, err, ms, plain_ms) in kernels.items()
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
