"""A one-device Renderer on the second card while the first is current: the
graph route (integrator/graphs.py) against the eager loop.

    python tools/graphs_second_card.py

Renders cornell_spheres (no traversal kernel) and glasstorus (K1/K2), MIS,
128x128, depth 8, 3 samples per pixel, with cuda:0 the current device:

- on cuda:1 through the graph route, whose steps are captured and replayed
  on cuda:1;
- on cuda:1 through the eager loop (`render_iteration`);
- on cuda:0 through the eager loop, the reference.

Prints the card's name and power limit, then per scene and route the HDR
sum's total, the rays, the laps, the graphs and their nodes, the K1/K2
launches (the graph route's include one eager run of each step before its
capture), and the error where a route raised; then one JSON line.  Exits 0
when the graph route on cuda:1 gives the reference image bit for bit on both
scenes, with the same rays and laps and K1/K2 launched on glasstorus, and
cuda:0 stayed the current device throughout.  Needs two cards.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RES, DEPTH, SPP = 128, 8, 3
SCENES = ("cornell_spheres", "glasstorus")


def render(scene: str, device: str, graphs: bool) -> dict:
    """One Renderer's SPP samples on `device`, on the graph route or the eager
    loop: its image and what it counted."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.ops import _build
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
    from tools.profile_torch_port import eager_route

    k0 = dict(_build.launches)
    r = Renderer(ROOT / "scenes" / f"{scene}.txt", RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(RES, RES), trace_depth=DEPTH, device=device)
    try:
        with eager_route() if not graphs else contextlib.nullcontext():
            if r.graph_route != graphs:
                route = "graph route" if graphs else "eager loop"
                raise RuntimeError(f"the renderer does not take the {route}")
            r.step(SPP)
        img = r.hdr_sum()
    except Exception as e:  # reported: the route's error is the finding
        return {"error": f"{type(e).__name__}: {e}"}
    return {"img": img, "sum": float(np.float64(img).sum()), "rays": r.stats.rays_traced,
            "laps": list(r.lap_pools), "graphs": r.graphs.num_graphs if r.graphs else 0,
            "nodes": sum(r.graphs.nodes.values()) if r.graphs else 0,
            "k1k2": tuple(_build.launches[t] - k0[t] for t in ("K1", "K2")),
            "current": torch.cuda.current_device()}


def main() -> int:
    import numpy as np
    import torch

    if torch.cuda.device_count() < 2:
        print("graphs_second_card: needs two cards", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0]} ({len(smi)} cards)")
    torch.cuda.set_device(0)
    ok, out = True, {}
    for scene in SCENES:
        runs = {"graphs cuda:1": render(scene, "cuda:1", True),
                "eager cuda:1": render(scene, "cuda:1", False),
                "eager cuda:0": render(scene, "cuda:0", False)}
        for name, run in runs.items():
            print(f"{scene} MIS {RES}x{RES} depth {DEPTH} {SPP} spp, {name}: "
                  + (run["error"] if "error" in run else
                     f"HDR sum {run['sum']!r}, rays {run['rays']}, laps {run['laps']}, "
                     f"{run['graphs']} graphs of {run['nodes']} nodes, K1/K2 launches "
                     f"{run['k1k2']}, current device {run['current']}"))
        g, ref = runs["graphs cuda:1"], runs["eager cuda:0"]
        same = ("error" not in g and "error" not in ref and np.array_equal(g["img"], ref["img"])
                and g["rays"] == ref["rays"] and g["laps"] == ref["laps"]
                and g["current"] == 0 and g["graphs"] > 0
                and (scene != "glasstorus" or min(g["k1k2"]) > 0))
        e1 = runs["eager cuda:1"]
        out[scene] = {"graphs_cuda1_bitwise_eager_cuda0": bool(same),
                      "eager_cuda1": e1["error"] if "error" in e1 else
                      bool("error" not in ref and np.array_equal(e1["img"], ref["img"]))}
        ok &= same
    print(json.dumps({"ok": ok, "scenes": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
