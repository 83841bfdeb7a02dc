"""Split one wide-node pop into its costs on the GPU (P2), the counterpart of
tools/kernel_microbench.py.

    python tools/kernel_microbench_torch.py [variant ...]

Runs the P2 probe of `pathtracer_tpu_torch/ops/probes.py` (kernels in
`csrc/probes.cu`, popping through the walks' node fetch) for each variant,
on 2,048 lanes (16 CTAs of 128: the TPU probe's 16x128 tile) over F = 20,000
pops, with the probe's tables (311 wide nodes, 10,000 triangle rows; numpy
seed 0), and prints ns per lap (the kernel's time over F, median of 20 runs
timed with CUDA events after a warm-up) and the difference from the first
variant, as the original does.  `nvidia-smi` samples the SM clock over all
the variants' runs; the last lines give its median and range and, for each
variant, its cycles per lap at that median beside its bound on one SM
(`chip_smoke.py probe_bound`: the binding term in clocks a lap) and the
share of the bound its time reaches.  leaf_mt tests 8 triangles a lap.  The
default is every variant.  The card's name and power limit come first.
Needs CUDA.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import torch

    from chip_smoke import probe_bound
    from pathtracer_tpu_torch.ops import probes
    from tools.cuda_timing import describe_clock, median_ms, sm_clock

    variants = (sys.argv[1:] if argv is None else argv) or list(probes.P2_VARIANTS)
    if not torch.cuda.is_available():
        print("kernel_microbench_torch: needs CUDA", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    args = probes.pop_inputs("cuda")
    probes.pop(variants[0], *args, F=1)  # builds the kernels before the clock is sampled
    base = None
    ns = {}
    with sm_clock() as mhz:
        for v in variants:
            ns[v] = median_ms(lambda: probes.pop(v, *args), runs=20) / probes.POP_F * 1e6
            base = ns[v] if base is None else base
            print(f"{v:19s}: {ns[v]:8.3f} ns/lap  (+{ns[v] - base:.3f})", flush=True)
    print(f"{describe_clock(mhz)} over all variants")
    if mhz:
        clock = statistics.median(mhz)
        print("cycles/lap at that clock, against the bound on one SM:")
        for v, t in ns.items():
            b = probe_bound(v, 1, clock)
            print(f"  {v:17s} {t * clock / 1e3:8.1f} cycles/lap; bound {b['clocks_per_lap']:.2f} "
                  f"({b['by']}), bound / time {b['ms'] * 1e6 / t:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
