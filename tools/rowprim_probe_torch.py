"""Time the primitives a per-row-stack walk needs on the GPU (P1), the
counterpart of tools/rowprim_probe.py.

    python tools/rowprim_probe_torch.py

Runs the P1 probe of `pathtracer_tpu_torch/ops/probes.py` (kernel in
`csrc/probes.cu`): one CTA on one SM, a warp per row of the (8, 128) tile
and one that sums, 2,000 laps of 8 rows of a (1024, 128) table staged by
TMA bulk copies, 16 broadcasts, 8 per-row any votes packed into bits and
read back as scalars, and a sum of the 8 rows; table and rays from numpy
with seed 0.  Prints the result and ns per lap (the kernel's time over the
laps, median of 200 runs timed with CUDA events after a warm-up, enough for
nvidia-smi to sample the clock), as the
original does, then the SM clock `nvidia-smi` sampled meanwhile, the cycles
per lap at its median, and the bound on one SM at that clock
(`chip_smoke.py probe_bound`: operations, bytes and the accumulator's chain
in clocks a lap, and the share of the bound the time reaches).  The card's
name and power limit come first.  Needs CUDA.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    from chip_smoke import probe_bound
    from pathtracer_tpu_torch.ops import probes
    from tools.cuda_timing import describe_clock, median_ms, sm_clock

    if not torch.cuda.is_available():
        print("rowprim_probe_torch: needs CUDA", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    tab, rays = probes.rowprim_inputs("cuda")
    out = probes.rowprim(tab, rays)
    print("compile ok, result", float(out[0, 0]), flush=True)
    with sm_clock() as mhz:
        ms = median_ms(lambda: probes.rowprim(tab, rays), runs=200)
    ns = ms / probes.ROWPRIM_LAPS * 1e6
    cycles = f", {ns * statistics.median(mhz) / 1e3:.0f} cycles/lap" if mhz else ""
    print(f"{probes.ROWPRIM_LAPS} laps: {ms:.4f} ms -> {ns:.1f} ns/lap "
          f"(8 row-reads + 8x2 bcasts + 8 reduces + scalar readback); "
          f"{describe_clock(mhz)}{cycles}")
    if mhz:
        b = probe_bound("P1", probes.ROWPRIM_LAPS, statistics.median(mhz))
        print(f"bound on one SM: {b['clocks_per_lap']:.2f} cycles/lap ({b['by']}; "
              + ", ".join(f"{k} {v:.2f}" for k, v in b["clocks"].items())
              + f"), {b['ms']:.6f} ms; bound / time {b['ms'] / ms:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
