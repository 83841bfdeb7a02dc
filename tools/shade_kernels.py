"""The material lobes' and the light side's kernels on the card:
`chip_smoke.py`'s phases 1, 2, 23 and 24 alone.

    python tools/shade_kernels.py

Prints the card's name and power limit and builds the kernels (phases 1-2),
then runs phases 23 and 24 on cornell_spheres (all five materials) and
glasstorus at 800x800: M1 (csrc/shade.cu scatter_lobes) and M2 (eval_lobes)
bit for bit against their plain versions on the main path's shading inputs,
M1's draw word for word against utils/rng.py, L1 (csrc/lights.cu
sample_lights) and L2 (eval_light_pdf) bit for bit against theirs on its NEE
inputs, and each kernel's and plain version's median time beside its bound.
The last line is the kernels' rows as JSON.
Exits 0 when every check holds.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs

    t0 = time.perf_counter()
    _, smi = cs.phase_device()
    cs.phase_build()
    rows = {}
    for scene, path in (("cornell_spheres", cs.SCENE_CORNELL), ("glasstorus", cs.SCENE)):
        r = cs.build_renderer(path)[0]
        got = cs.phase_shade_kernels(r, scene)
        got.update(cs.phase_light_kernels(r, scene))
        rows.update({f"{k} {scene}": v for k, v in got.items()})
        del r
    cs.log(f"shade_kernels: phases 23 and 24 passed on {smi}, {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": [
        {"name": name, "source": src, "replaces": rep, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
        for name, (_, src, rep, err, ms, plain_ms, (b_ms, by)) in rows.items()]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
