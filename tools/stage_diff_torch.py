"""Where the card and the CPU part ways in the port's integrator, and which
PyTorch op is behind it.

    python tools/stage_diff_torch.py [--scenes NAME,NAME] [--res 64] [--depth 8] \\
        [--spp 2] [--out FILE]

For each scene (a stem under scenes/; default glasstorus, glasstorus160k,
cornell_spheres) it builds one Renderer on "cuda" and one on "cpu" (MIS, the
same tables, RNG key and camera) and runs `integrator/wavefront.py bounce`
lap by lap, `--spp` iterations of up to `--depth` + 1 laps, from identical
pools: each lap's CPU input is the card's input copied to the CPU, and the
next lap starts from the card's output, so a difference never compounds.
Per lap it compares, lane by lane and bit for bit, the stage arrays that
`bounce` records (its `trace`) in the order the pass makes them:

    hit (t, geom, tri, point, normal), shading normal, scatter_sample (dir,
    pdf, bsdf), light_sample (pos, pdf, emit), pdf_eval, bsdf_eval, the
    light-hit and NEE terms before process_nan, contrib, the next pool
    (o, d, color, prev_pdf, alive)

and counts, for each stage, the lanes whose first difference lies there and
the largest distance there in float32 ulps.  The laps run on unsorted pools,
as `compaction=False` runs them: the tool calls `bounce` itself, with no
per-bounce sort, shrink ladder or regeneration, so position l of every
stage array is lane l on both devices.  The scheduler only reorders lanes
(its images are bitwise those of the unsorted pool: tests/test_torch_schedule.py),
so what differs here differs under the default schedule too.  It also counts the discrete
choices that came out differently: the geom hit, a lane's alive bit, the
dielectric branch (is_delta), pdf != 0, a dielectric's reflect or refract,
the shadow test (pdf < 0), and a term scrubbed to 0 by process_nan on one
device only.

The CPU pass runs under a function mode that runs every PyTorch op a
second time on copies of its inputs on the card and compares the two
results bit for bit: per op, the calls and elements that differ and the
largest ulp distance, in the order the pass first meets each op.  Then the
same laps run with each device on its own pool, as two renders run: per lap,
the lanes whose pools have drifted apart and the discrete choices that
differ.  Last, two independent renders of each scene (card and CPU, `--spp`
iterations) are held to the CPU slice tolerance, as chip_smoke.py
phase_card_vs_cpu does.

Prints the card's name and power limit and a summary per scene; `--out`
writes everything as JSON.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CARD = "cuda"
IMG_RTOL, IMG_ATOL = 1e-4, 1e-5  # tests/test_torch_render.py
# ops that move, read out or describe a tensor rather than compute one
NOT_COMPUTE = {"to", "cpu", "cuda", "numpy", "tolist", "item", "__get__", "__bool__",
               "__len__", "__index__", "__int__", "__float__", "__repr__", "__format__",
               "data_ptr", "numel", "dim", "size", "element_size", "is_contiguous",
               "contiguous", "clone", "detach", "view", "reshape", "expand", "expand_as",
               "__setitem__"}


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in float32 ulps (0 where both are NaN), as float64."""
    ia, ib = (x.float().contiguous().view(torch.int32).to(torch.int64) for x in (a, b))
    oa = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ob = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return torch.where(both_nan, 0, (oa - ob).abs()).double()


def lane_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lanes that differ bit for bit, largest ulps per lane) of two (N, ...)
    arrays on the CPU; NaN equals NaN; integer and bool arrays have ulps 0."""
    if a.dtype.is_floating_point:
        dist = ulps(a, b)
        if dist.dim() > 1:
            dist = dist.flatten(1).max(1).values
        return dist > 0, dist
    neq = a != b
    if neq.dim() > 1:
        neq = neq.flatten(1).any(1)
    return neq, torch.zeros(a.shape[0], dtype=torch.float64)


def stages(trace: dict, out) -> list[tuple[str, torch.Tensor]]:
    """The pass's arrays in the order it makes them."""
    hit, srec = trace["hit"], trace["srec"]
    rows = [("hit.t", hit.t), ("hit.geom", hit.geom), ("hit.tri", hit.tri),
            ("hit.point", hit.point), ("hit.normal", hit.normal), ("shading normal", trace["nrm"]),
            ("scatter_sample.dir", srec.dir), ("scatter_sample.pdf", srec.pdf),
            ("scatter_sample.bsdf", srec.bsdf)]
    if "lrec" in trace:
        lrec = trace["lrec"]
        rows += [("light_sample.pos", lrec.pos), ("light_sample.pdf", lrec.pdf),
                 ("light_sample.emit", lrec.emit)]
    if "b_pdf" in trace:
        rows.append(("pdf_eval", trace["b_pdf"]))
    if "li_bsdf" in trace:
        rows.append(("bsdf_eval", trace["li_bsdf"]))
    rows += [(f"term.{k}", trace[k]) for k in ("light_color", "nee") if k in trace]
    rows.append(("contrib", out.contrib))
    rows += [(f"next pool.{k}", getattr(out, k)) for k in ("o", "d", "color", "prev_pdf", "alive")]
    return rows


def flips(tr_card: dict, tr_cpu: dict, pool_card, pool_cpu, out_card, out_cpu) -> dict:
    """Lanes where a discrete choice came out differently on the two devices
    (among lanes live on either)."""
    from pathtracer_tpu_torch.scene.parser import DIELECTRIC

    def c(x):
        return x.cpu()

    h1, h2 = tr_card["hit"], tr_cpu["hit"]
    delta1, delta2 = c(tr_card["params"].type) == DIELECTRIC, tr_cpu["params"].type == DIELECTRIC

    def reflects(tr, delta, pool):
        nrm = c(tr["nrm"])
        s = (c(tr["srec"].dir) * nrm).sum(-1) * (pool.d.cpu() * nrm).sum(-1)
        return delta & (s < 0)

    live = pool_card.alive.cpu() | pool_cpu.alive.cpu()
    got = {
        "geom": (c(h1.geom) != h2.geom) & live,
        "alive": c(out_card.alive) != out_cpu.alive,
        "is_delta": (delta1 != delta2) & live,
        "pdf != 0": ((c(tr_card["srec"].pdf) != 0) != (tr_cpu["srec"].pdf != 0)) & live,
        "reflect or refract": ((reflects(tr_card, delta1, pool_card)
                                != reflects(tr_cpu, delta2, pool_cpu)) & delta1 & delta2 & live),
    }
    if "lrec" in tr_card:
        got["shadow test (pdf < 0)"] = ((c(tr_card["lrec"].pdf) < 0) != (tr_cpu["lrec"].pdf < 0)) & live
    for k in ("light_color", "nee"):
        if k in tr_card:
            fin1 = torch.isfinite(c(tr_card[k])).all(-1)
            fin2 = torch.isfinite(tr_cpu[k]).all(-1)
            got[f"process_nan ({k})"] = (fin1 != fin2) & live
    return {k: int(v.sum()) for k, v in got.items()}


class OpCensus(TorchFunctionMode):
    """Runs each PyTorch op of the pass again on copies of its inputs on
    `device` and compares the results with the CPU's, bit for bit."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.ops: dict[str, dict] = {}
        # the scene tables, copied once (each kept beside its source, whose
        # address then cannot be reused)
        self._copies: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def _moved(self, x):
        if isinstance(x, torch.Tensor):
            if x.numel() < 1 << 20:
                return x.to(self.device), True
            key = (x.data_ptr(), x._version, x.dtype, tuple(x.shape), x.stride())
            if key not in self._copies:
                self._copies[key] = (x, x.to(self.device))
            return self._copies[key][1], True
        if isinstance(x, (list, tuple)):
            moved = [self._moved(v) for v in x]
            return type(x)(m for m, _ in moved), any(t for _, t in moved)
        return x, False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name in NOT_COMPUTE:
            return func(*args, **kwargs)
        card_args, has = self._moved(list(args))
        card_kwargs = {k: self._moved(v)[0] for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if not has or not isinstance(out, torch.Tensor) or out.device.type != "cpu":
            return out
        want = func(*card_args, **card_kwargs)
        if not isinstance(want, torch.Tensor) or want.shape != out.shape:
            return out
        want = want.cpu()
        rec = self.ops.setdefault(name, {"order": len(self.ops), "calls": 0, "calls_differ": 0,
                                         "elements": 0, "elements_differ": 0, "max_ulps": 0.0})
        rec["calls"] += 1
        rec["elements"] += out.numel()
        if out.numel():
            if out.dtype.is_floating_point:
                dist = ulps(out, want)
                n_diff = int((dist > 0).sum())
                rec["max_ulps"] = max(rec["max_ulps"], float(dist.max()))
            else:
                n_diff = int((out != want).sum())
            rec["elements_differ"] += n_diff
            rec["calls_differ"] += int(n_diff > 0)
        return out


def pool_to(pool, device):
    return type(pool)(*(x.to(device) for x in pool))


def diff_scene(path: Path, res: int, depth: int, spp: int) -> dict:
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.integrator.wavefront import bounce, camera_rays, new_pool
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    mode = SampleMode.MIS
    rs = {dev: Renderer(path, RenderOptions(sample_mode=mode), resolution=(res, res),
                        trace_depth=depth, device=dev) for dev in (CARD, "cpu")}
    card, cpu = rs[CARD], rs["cpu"]
    census = OpCensus(CARD)
    laps = []
    for it in range(1, spp + 1):
        o, d = camera_rays(card._cam_arrays(), res, res, card.key, it, pixel_xy=card.pixel_xy)
        o2, d2 = camera_rays(cpu._cam_arrays(), res, res, cpu.key, it, pixel_xy=cpu.pixel_xy)
        cam_lanes = int(lane_diff(d.cpu(), d2)[0].sum() + lane_diff(o.cpu(), o2)[0].sum())
        n = o.shape[0]
        pool = new_pool(o, d)
        for lap in range(depth + 1):
            if not bool(pool.alive.any()):
                break
            tr_card, tr_cpu = {}, {}
            out_card, _ = bounce(card.flat, card.static, mode, card.key, it, lap, pool, trace=tr_card)
            pool_cpu = pool_to(pool, "cpu")
            with census:
                out_cpu, _ = bounce(cpu.flat, cpu.static, mode, cpu.key, it, lap, pool_cpu,
                                    trace=tr_cpu)
            torch.cuda.synchronize()
            first = torch.zeros(n, dtype=torch.bool)
            per_stage = []
            for (name, a), (_, b) in zip(stages(tr_card, out_card), stages(tr_cpu, out_cpu)):
                differ, dist = lane_diff(a.cpu(), b)
                new = differ & ~first
                first |= differ
                per_stage.append({"stage": name, "lanes_first": int(new.sum()),
                                  "lanes": int(differ.sum()),
                                  "max_ulps_first": float(dist[new].max()) if new.any() else 0.0})
            laps.append({"iteration": it, "lap": lap, "live": int(pool.alive.sum()),
                         "camera_lanes_differ": cam_lanes if lap == 0 else 0,
                         "stages": per_stage,
                         "flips": flips(tr_card, tr_cpu, pool, pool_cpu, out_card, out_cpu)})
            pool = out_card
    # the same laps with each device on its own pool, as two renders run:
    # how far the pools have drifted apart, and the choices that flip
    drift = []
    for it in range(1, spp + 1):
        pools = {}
        for dev, r in rs.items():
            o, d = camera_rays(r._cam_arrays(), res, res, r.key, it, pixel_xy=r.pixel_xy)
            pools[dev] = new_pool(o, d)
        for lap in range(depth + 1):
            if not bool(pools[CARD].alive.any() | pools["cpu"].alive.cpu().any()):
                break
            traces, outs = {}, {}
            for dev, r in rs.items():
                traces[dev] = {}
                outs[dev], _ = bounce(r.flat, r.static, mode, r.key, it, lap, pools[dev],
                                      trace=traces[dev])
            apart = torch.zeros(n, dtype=torch.bool)
            for name in ("o", "d", "color", "prev_pdf", "alive"):
                apart |= lane_diff(getattr(pools[CARD], name).cpu(), getattr(pools["cpu"], name))[0]
            drift.append({"iteration": it, "lap": lap, "pool_lanes_differ": int(apart.sum()),
                          "flips": flips(traces[CARD], traces["cpu"], pools[CARD], pools["cpu"],
                                         outs[CARD], outs["cpu"])})
            pools = outs
    # two independent renders, as chip_smoke.py phase_card_vs_cpu
    imgs = {}
    for dev, r in rs.items():
        r.reset()
        r.step(spp)
        imgs[dev] = r.hdr_sum()
    ok = np.isclose(imgs[CARD], imgs["cpu"], rtol=IMG_RTOL, atol=IMG_ATOL).all(-1)
    ops = sorted(census.ops.items(), key=lambda kv: kv[1]["order"])
    return {"scene": path.stem, "res": res, "depth": depth, "spp": spp, "laps": laps,
            "drift": drift,
            "image_outliers": int((~ok).sum()), "image_pixels": int(ok.size),
            "image_bitwise_equal": int((imgs[CARD] == imgs["cpu"]).all(-1).sum()),
            "ops": [{"op": k, **v} for k, v in ops]}


def summarize(res: dict) -> None:
    print(f"== {res['scene']} MIS {res['res']}x{res['res']} depth {res['depth']} "
          f"{res['spp']} spp: card vs CPU images {res['image_outliers']} outliers of "
          f"{res['image_pixels']} (rtol {IMG_RTOL}, atol {IMG_ATOL}), "
          f"{res['image_bitwise_equal']} bitwise equal", flush=True)
    totals: dict[str, list] = {}
    flips_per_lap: dict[int, dict] = {}
    for lap in res["laps"]:
        for st in lap["stages"]:
            t = totals.setdefault(st["stage"], [0, 0.0])
            t[0] += st["lanes_first"]
            t[1] = max(t[1], st["max_ulps_first"])
        f = flips_per_lap.setdefault(lap["lap"], {})
        for k, v in lap["flips"].items():
            f[k] = f.get(k, 0) + v
        if lap["camera_lanes_differ"]:
            print(f"  iteration {lap['iteration']}: camera rays differ on "
                  f"{lap['camera_lanes_differ']} lanes")
    print("  lanes whose first difference lies at each stage (all laps; largest ulps there):")
    for name, (lanes, u) in totals.items():
        if lanes:
            print(f"    {name:24s} {lanes:6d} lanes, <= {u:.0f} ulps")
    print("  discrete choices that differ, per lap (summed over iterations):")
    for lap, f in sorted(flips_per_lap.items()):
        print(f"    lap {lap}: " + ", ".join(f"{k} {v}" for k, v in f.items()))
    print("  each device on its own pool, per lap (summed over iterations): lanes whose "
          "pool differs on entry; discrete choices that differ")
    per_lap: dict[int, dict] = {}
    for lap in res["drift"]:
        f = per_lap.setdefault(lap["lap"], {"pool lanes differ": 0})
        f["pool lanes differ"] += lap["pool_lanes_differ"]
        for k, v in lap["flips"].items():
            f[k] = f.get(k, 0) + v
    for lap, f in sorted(per_lap.items()):
        print(f"    lap {lap}: " + ", ".join(f"{k} {v}" for k, v in f.items()))
    print("  PyTorch ops whose card result differs from the CPU's on identical inputs, "
          "in the order the pass meets them:")
    for op in res["ops"]:
        if op["elements_differ"]:
            print(f"    {op['op']:20s} {op['calls_differ']}/{op['calls']} calls, "
                  f"{op['elements_differ']}/{op['elements']} elements, <= {op['max_ulps']:.0f} ulps")
    agree = [op["op"] for op in res["ops"] if not op["elements_differ"]]
    print(f"  ops bitwise equal on every call: {', '.join(agree)}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenes", default="glasstorus,glasstorus160k,cornell_spheres")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_diff_torch: needs CUDA", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    from tools.make_torus_obj import ensure_torus_obj

    results = []
    for name in args.scenes.split(","):
        if name == "glasstorus160k":
            ensure_torus_obj(ROOT / "scenes" / "assets" / "torus160k.obj", 400, 200)
        res = diff_scene(ROOT / "scenes" / f"{name}.txt", args.res, args.depth, args.spp)
        summarize(res)
        results.append(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "scenes": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
