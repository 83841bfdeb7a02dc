"""Whole-image cross-check of the PyTorch port against the independent numpy
oracle (tools/oracle.py), on the card by default.

The port's counterpart of tools/oracle_compare.py, which renders through the
JAX package: this one renders the same scene with `pathtracer_tpu_torch`
and with the oracle at matched spp and prints one JSON line with the same
keys:

  rmse_lin    cross-implementation RMSE of mean linear radiance
  rmse_ldr    cross RMSE after the display transform (ACES + gamma, [0, 1])
  floor_*     each implementation's own seed-0 against seed-1 RMSE at the
              same spp (the Monte Carlo noise floor); two unbiased renders
              of the same integral differ by about the quadrature of the
              two floors, `floor_quad_ldr`, so for matched physics
              rmse_ldr / floor_quad_ldr is about 1/sqrt(2)

plus `device`, and on CUDA the card's name and power limit as nvidia-smi
gives them (`card`).  The oracle imports only numpy and runs on the host's
CPU, in two worker processes (one a seed) while the port renders.

Usage:
  python tools/oracle_compare_torch.py scenes/cornell_spheres.txt --mode mis --res 64 --spp 128
  python tools/oracle_compare_torch.py scenes/envtorus.txt --env-is --res 64 --spp 128
  python tools/oracle_compare_torch.py scenes/cornell_spheres.txt --device cpu --res 16 --spp 4
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools import oracle  # noqa: E402

SEEDS = (0, 1)


def ours_render(scene_path, mode, res, spp, depth, seed, env_is=False, device="cuda"):
    """Mean linear radiance (H, W, 3) of the port's render, in pixel order.

    `env_is=True` turns on env-map importance sampling (which the reference
    left TODO) on the port's side only: both estimators are unbiased for the
    same integral, so the cross RMSE against the oracle, which has none,
    still converges to the quadrature of the two floors."""
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    modes = {"bsdf": SampleMode.BSDF, "direct": SampleMode.DIRECT_LI, "mis": SampleMode.MIS}
    r = Renderer(str(scene_path), opts=RenderOptions(sample_mode=modes[mode],
                                                     env_importance=env_is),
                 resolution=(res, res), trace_depth=depth, device=device)
    r.set_seed(seed)
    r.step(spp)
    return r.hdr_sum() / max(r.iteration, 1)


def oracle_render(scene_path, mode, res, spp, depth, seed):
    """(mean linear radiance (H, W, 3), seconds) of the oracle's render."""
    t0 = time.perf_counter()
    img = oracle.render(oracle.load_scene(scene_path), mode=mode, spp=spp, width=res,
                        height=res, depth=depth, seed=seed)
    return img, time.perf_counter() - t0


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def ldr(img):
    return oracle.ldr(np.clip(np.nan_to_num(img), 0.0, None))


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def compare(scene_path, mode="mis", res=64, spp=64, depth=None, floors=True,
            clamp_pct=None, env_is=False, device="cuda", log=lambda *a: None) -> dict:
    """One row: the port's and the oracle's renders at seed 0 (and seed 1
    for the floors).  `clamp_pct` (e.g. 99.0) clamps both linear images at
    that percentile of the oracle's seed-0 render before every RMSE, as
    tools/oracle_compare.py does, to bound the heavy tail of near-delta
    light samples; the clamp is the same on both sides, so a systematic
    divergence still shows."""
    scene_path = str(scene_path)
    seeds = SEEDS if floors else SEEDS[:1]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(seeds), mp_context=ctx) as pool:
        jobs = [pool.submit(oracle_render, scene_path, mode, res, spp, depth, s) for s in seeds]
        ours, secs_ours = [], []
        for s in seeds:
            t0 = time.perf_counter()
            ours.append(ours_render(scene_path, mode, res, spp, depth, s, env_is, device))
            secs_ours.append(time.perf_counter() - t0)
            log(f"ours seed {s}: {secs_ours[-1]:.1f} s on {device}")
        orc, secs_orc = zip(*(job.result() for job in jobs))
    log(f"oracle: {', '.join(f'{t:.1f}' for t in secs_orc)} s")
    clamp_v = None
    if clamp_pct is not None:
        clamp_v = float(np.percentile(orc[0], clamp_pct))
        ours = [np.minimum(a, clamp_v) for a in ours]
        orc = [np.minimum(a, clamp_v) for a in orc]
    out = {
        "scene": Path(scene_path).stem,
        "mode": mode,
        "res": res,
        "spp": spp,
        "rmse_lin": rmse(ours[0], orc[0]),
        **({"env_is": True} if env_is else {}),
        "rmse_ldr": rmse(ldr(ours[0]), ldr(orc[0])),
        "secs_ours": round(secs_ours[0], 1),
        "secs_oracle": round(secs_orc[0], 1),
        "device": str(device),
    }
    if clamp_v is not None:
        out["clamp_pct"] = clamp_pct
        out["clamp_value"] = round(clamp_v, 4)
    if floors:
        out["floor_ours_lin"] = rmse(ours[0], ours[1])
        out["floor_oracle_lin"] = rmse(orc[0], orc[1])
        out["floor_ours_ldr"] = rmse(ldr(ours[0]), ldr(ours[1]))
        out["floor_oracle_ldr"] = rmse(ldr(orc[0]), ldr(orc[1]))
        out["floor_quad_ldr"] = float(np.hypot(out["floor_ours_ldr"], out["floor_oracle_ldr"]))
    if str(device).startswith("cuda"):
        out["card"] = card_name()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("--mode", default="mis", choices=["bsdf", "direct", "mis"])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--no-floors", action="store_true")
    ap.add_argument("--clamp", type=float, default=None,
                    help="percentile clamp on both linear images")
    ap.add_argument("--env-is", action="store_true",
                    help="env importance sampling on for the port only")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from tools.make_texture_assets import ensure_texture_assets

    ensure_texture_assets()
    out = compare(args.scene, args.mode, args.res, args.spp, args.depth,
                  floors=not args.no_floors, clamp_pct=args.clamp, env_is=args.env_is,
                  device=args.device, log=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
