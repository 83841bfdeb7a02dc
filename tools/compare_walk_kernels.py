"""Times the traversal kernels K1-K5 of several checkouts of this repository
on one GPU, in turns, inside one process tree on one card.

    python tools/compare_walk_kernels.py [--meshes M,M] [--runs N] [--out FILE] \\
        TREE[:NAME=VALUE,...] [TREE ...]

for instance, with the parent commit unpacked into `_checkout/parent`
(`git archive <commit> | tar -x -C _checkout/parent`; `_checkout/` is
gitignored):

    python tools/compare_walk_kernels.py _checkout/parent . . _checkout/parent

Each TREE is the root of a checkout that holds `chip_smoke.py` and the
port; the trees run in the order given, each in a process of its own
(`tools/turns.py`), so old-new-new-old shows the run-to-run spread beside
the difference.  A tree may carry compile-time defines for its kernels
(`.:WALK_THREADS=64`): they are passed to nvcc as `-D`, and the libraries go
into a build directory of their own.  In each turn the tree's own `chip_smoke.py` builds the three
scenes' tables (glasstorus, glasstorus160k, glasstorus640k) and calls the
tree's kernels; the rays are those of this checkout's `chip_smoke.py
ray_cases` for every tree (the 800x800 frame's 640,000 camera and
continuation rays, and two sets of NEE shadow rays, from the camera rays'
hits and from the continuation rays' hits), made with the tree's port.  A
turn checks K1 and K3 (bit for bit, all four ray sets) and K2 and K4 (every
lane, all four shadow sets) against the tree's plain versions on glasstorus
and glasstorus160k, and K3 against K1, K5's t against K3's and K4 against K2
on the two large meshes (K5 through the tree's own chip_smoke.py
stream_calls, with whatever tables that tree's K5 takes), and times K1, K3
and K5 on the continuation rays ("K1", "K3", "K5") and on the camera rays
("K1cam", "K3cam", "K5cam") and K2 and K4 on both shadow sets ("K2", "K4":
from the camera rays' hits; "K2c", "K4c": from the continuation rays' hits)
with CUDA events (median of `--runs`, 5 unless given, after a warm-up), the
SM clock sampled over the mesh's turn.
`--meshes` keeps the turns to some of the three.
Prints the card's name and power limit, one
line per turn and mesh, and a table of medians per tree; `--out FILE`
writes the same as JSON.  Needs CUDA; the large OBJs are written once and
shared between the trees.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import turns as T  # noqa: E402

# Runs in a tree after turns.BUILD_PRELUDE; uses only what every tree's
# chip_smoke.py has had since the streaming kernels landed.
WORKER = r"""
import importlib.util, json, sys
meshes, runs, rays_from = sys.argv[1].split(","), int(sys.argv[2]), sys.argv[3]
import torch
import chip_smoke as cs
from pathtracer_tpu_torch.ops import traverse_cuda as tc
from tools.cuda_timing import describe_clock, median_ms, sm_clock
spec = importlib.util.spec_from_file_location("ray_source", rays_from)
ray_source = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ray_source)
report = {k: v for k, v in _build.ptxas_report().items() if not k.startswith("p")}
out = {"ptxas": report, "meshes": {}}
for scene in (cs.SCENE, cs.SCENE_160K, cs.SCENE_640K):
    if scene.stem not in meshes:
        continue
    r = cs.build_renderer(scene)[0]
    closest, shadow = ray_source.ray_cases(r)
    flat, static = r.flat, r.static
    wide = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k2_tables = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk)
    k1 = lambda ro, rd, t0: tc.closest_hit_wbvh(*wide, ro, rd, t0, wide_depth=static.wide_depth)
    k2 = lambda so, sd, mt, o0: tc.occlusion_wbvh(*k2_tables, so, sd, mt, o0,
                                                  wide_depth=static.wide_depth)
    k = cs.stream_calls(flat, static) if static.stream_subs else None
    check = scene != cs.SCENE_640K  # the plain walks take minutes there
    same = True
    with sm_clock() as clock:
        for label, (ro, rd, t0) in closest.items():
            got1 = k1(ro, rd, t0)
            if check:
                want = tc.closest_hit_wbvh_plain(*wide, ro, rd, t0)
                same &= all(torch.equal(a, b) for a, b in zip(got1, want))
            if k:
                got3 = k["K3"](ro, rd, t0)
                same &= all(torch.equal(a, b) for a, b in zip(got3, got1))
                same &= torch.equal(k["K5"](ro, rd, t0)[0], got3[0])
                if check:
                    want = k["K3_plain"](ro, rd, t0)
                    same &= all(torch.equal(a, b) for a, b in zip(got3, want))
        for label, (so, sd, mt, o0) in shadow.items():
            got2 = k2(so, sd, mt, o0)
            if check:
                same &= torch.equal(got2, tc.occlusion_wbvh_plain(*k2_tables, so, sd, mt, o0))
            if k:
                got4 = k["K4"](so, sd, mt, o0)
                same &= torch.equal(got4, got2)
                if check:
                    same &= torch.equal(got4, k["K4_plain"](so, sd, mt, o0))
        ms = {}
        for tag, label in (("", "continuation"), ("cam", "camera")):
            ro, rd, t0 = closest[label]
            ms["K1" + tag] = median_ms(lambda: k1(ro, rd, t0), runs)
            if k:
                ms["K3" + tag] = median_ms(lambda: k["K3"](ro, rd, t0), runs)
                ms["K5" + tag] = median_ms(lambda: k["K5"](ro, rd, t0), runs)
        for tag, label in zip(("", "c"), ray_source.SHADOW_SETS):
            so, sd, mt, o0 = shadow[label]
            ms["K2" + tag] = median_ms(lambda: k2(so, sd, mt, o0), runs)
            if k:
                ms["K4" + tag] = median_ms(lambda: k["K4"](so, sd, mt, o0), runs)
    out["meshes"][scene.stem] = {"ms": ms, "bitwise_equal": bool(same), "clock": describe_clock(clock),
                                 "rays": ro.shape[0]}
    del r, closest, shadow, flat, k
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", metavar="TREE[:NAME=VALUE,...]")
    p.add_argument("--out", type=Path)
    p.add_argument("--meshes", default="glasstorus,glasstorus160k,glasstorus640k")
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args(argv)

    smi = T.card()
    from tools.make_torus_obj import ensure_torus_obj

    assets = {"torus160k.obj": (400, 200), "torus640k.obj": (800, 400)}
    for name, (major, minor) in assets.items():
        ensure_torus_obj(ROOT / "scenes" / "assets" / name, major, minor)

    turns = []
    for spec in args.trees:
        for name in assets:  # the OBJs are gitignored, so a fresh checkout lacks them
            dst = T.tree_root(spec) / "scenes" / "assets" / name
            if not dst.exists():
                shutil.copy(ROOT / "scenes" / "assets" / name, dst)
        res = T.run_turn(spec, WORKER, args.meshes, str(args.runs), str(ROOT / "chip_smoke.py"))
        turns.append({"tree": spec, **res})
        T.print_ptxas(spec, res["ptxas"])
        for mesh, m in res["meshes"].items():
            ms = m["ms"]
            ratio = (f", K3/K1 {ms['K3'] / ms['K1']:.3f}, K5/K3 {ms['K5'] / ms['K3']:.3f}, "
                     f"camera K5/K3 {ms['K5cam'] / ms['K3cam']:.3f}" if "K3" in ms else "")
            print(f"{spec} {mesh} at {m['rays']} rays: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()) + ratio
                  + f"; K1-K4 equal to the plain versions and K5's t to K3's on every lane: "
                  f"{m['bitwise_equal']}; {m['clock']}",
                  flush=True)
        if not all(m["bitwise_equal"] for m in res["meshes"].values()):
            raise SystemExit(f"{spec}: a kernel disagrees with its plain version")

    print("medians over each tree's turns (ms):")
    T.print_medians(turns, lambda t: {f" {mesh}": m["ms"] for mesh, m in t["meshes"].items()},
                    ".4f")
    T.write_out(args.out, smi, turns)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
