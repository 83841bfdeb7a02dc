#!/usr/bin/env python3
"""The two readings the limits of the comparison that decides `correct` sit
between, each judged by that comparison against the float32 reference:

- `--variant bfloat16`, the control: the plain reference put in the
  program's place, computed in bfloat16 (the precision below the float32
  the scenes state).  It has to come out not correct; its readings are the
  upper ends the limits in benchmark/workloads/<cell>.json were set below.
  It renders `--iterations` full frames (summed into a float32 film, as the
  program's film sums).
- `--variant rounded`, a sound program that rounds differently: the
  reference in float32 with every dot product, cross product, point
  transform and triangle test rounded once (worked in float64, then
  rounded), as FMA contraction or a fused kernel would round them.  Its
  readings sit below the limits.  `--iterations` is the window's count of
  samples: the film check's pixels are summed over all of them, the frame
  check is the last.

    python3 benchmark/control.py --workload glasstorus.mis --seeds 11 12 13 --iterations 4
    python3 benchmark/control.py --workload glasstorus.mis --variant rounded --seeds 11 --iterations 550

Every reference here is built for the cell's mix: with its
`env_importance`, an environment map is sampled as a light, as the program
samples it.  Each seed prints one JSON line with the two compared numbers.  `--device
cpu --res 32x16` runs it small (benchmark/tests).  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _setup(name, device, resolution):
    """(reference of the cell's scene in a dtype, MIS, film, swizzle)."""
    import torch

    from benchmark.lib import cells
    from benchmark.reference.render import Reference

    c = cells.cell(name)
    cfg, mix = c["config"], c["traffic"]
    res = tuple(resolution or cfg["film"])
    opts = mix.get("options", {})
    swizzle = int(cfg.get("devices", 1)) == 1 and opts.get("swizzle", True)
    env = bool(opts.get("env_importance", False))

    def reference(dtype=torch.float32):
        return Reference(cells.ROOT / cfg["scene"], device, dtype=dtype, resolution=res, env_importance=env)

    return reference, mix["mode"] == "mis", res, swizzle


@contextlib.contextmanager
def rounded_once():
    """The reference's dot and cross products, point transforms and triangle
    tests each worked in float64 and rounded once to the inputs' type."""
    import torch

    from benchmark.reference import bvh, render

    saved = render.dot, render.cross, render.xform_point, bvh.moller_trumbore
    mt = bvh.moller_trumbore

    def dot(a, b):
        return (a.double() * b.double()).sum(-1).to(a.dtype)

    def cross(a, b):
        return torch.linalg.cross(a.double(), b.double(), dim=-1).to(a.dtype)

    def xform_point(m, p):
        md = m.double()
        return (torch.einsum("...ij,...j->...i", md[..., :3, :3], p.double()) + md[..., :3, 3]).to(p.dtype)

    def moller_trumbore(r, *ray):
        hit, t, u, v = mt(r.double(), *(x.double() for x in ray))
        return hit, t.to(r.dtype), u.to(r.dtype), v.to(r.dtype)

    render.dot, render.cross, render.xform_point, bvh.moller_trumbore = \
        dot, cross, xform_point, moller_trumbore
    try:
        yield
    finally:
        render.dot, render.cross, render.xform_point, bvh.moller_trumbore = saved


def rounded_numbers(name: str, seed: int, iterations: int, device: str = "cuda",
                    resolution=None) -> dict:
    """The compared numbers of `rounded_once`'s reference after `iterations`
    samples: the film check's pixels hold its sum of every sample, the
    frame check's its last sample."""
    import numpy as np
    import torch

    from benchmark.lib import check
    from benchmark.reference import rng

    reference, mis, res, swizzle = _setup(name, device, resolution)
    ref = reference()
    swizzle = swizzle and ref.bvh is not None
    key = rng.base_key(seed)
    npix = res[0] * res[1]
    sample = check.film_sample(seed, npix)
    with rounded_once():
        var = reference()
        counters = var.counters(swizzle)
        frame = check.radiance(var, key, mis, counters, torch.arange(npix, device=device),
                               iterations).float().cpu().numpy()
        sp = torch.as_tensor(sample, device=device)
        p_all = sp.repeat(iterations)
        it_all = torch.arange(1, iterations + 1, device=device).repeat_interleave(sp.shape[0])
        cs = check.radiance(var, key, mis, counters[p_all], p_all, it_all).float().cpu().numpy()
    cs = cs.reshape(iterations, sample.shape[0], 3)
    acc = np.zeros((sample.shape[0], 3), np.float32)
    for k in range(iterations - 1):  # the film's order of adds
        acc = (acc + cs[k]).astype(np.float32)
    before = np.zeros((npix, 3), np.float32)
    before[sample] = acc
    film = (before + frame).astype(np.float32)
    return check.compare(ref, key, mis, swizzle, film, before, iterations, iterations, sample)


def control_numbers(name: str, seed: int, iterations: int, device: str = "cuda",
                    resolution=None) -> dict:
    import numpy as np
    import torch

    from benchmark.lib import check
    from benchmark.reference import rng

    reference, mis, res, swizzle = _setup(name, device, resolution)
    ref = reference()
    low = reference(torch.bfloat16)
    swizzle = swizzle and ref.bvh is not None
    key = rng.base_key(seed)
    npix = res[0] * res[1]
    counters = low.counters(swizzle)
    pix = torch.arange(npix, device=device)
    film = np.zeros((npix, 3), np.float32)
    before = film
    for it in range(1, iterations + 1):
        before = film
        c_low = check.radiance(low, key, mis, counters, pix, it).float().cpu().numpy()
        film = (film + c_low).astype(np.float32)
    return check.compare(ref, key, mis, swizzle, film, before, iterations, iterations,
                         check.film_sample(seed, npix))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", choices=("bfloat16", "rounded"), default="bfloat16")
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--res", default=None, help="WxH, the cell's film by default")
    args = p.parse_args(argv)
    res = tuple(int(x) for x in args.res.split("x")) if args.res else None
    for seed in args.seeds:
        numbers = control_numbers if args.variant == "bfloat16" else rounded_numbers
        out = numbers(args.workload, seed, args.iterations, args.device, res)
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": args.variant,
                          "iterations": args.iterations, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
