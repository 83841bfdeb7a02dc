"""Times the probes P1 and P2 of several checkouts of this repository on one
GPU, in turns, inside one process tree on one card, beside their bound on
one SM.

    python tools/compare_probes.py [--runs N] [--out FILE] TREE[:NAME=VALUE,...] [TREE ...]

for instance, with the parent commit unpacked into `_checkout/parent`
(`git archive <commit> | tar -x -C _checkout/parent`; `_checkout/` is
gitignored):

    python tools/compare_probes.py _checkout/parent . . _checkout/parent

Each TREE is the root of a checkout that holds the port; the trees run in
the order given, each in a process of its own (`tools/turns.py`, which also
says how a tree takes compile-time defines), so old-new-new-old shows the
run-to-run spread beside the difference.  A turn holds the tree's P1 (2,000
laps, and 1, 3 and 5) and every P2 variant (from the probe's start, and
from a small one past the wrap of the node index, at this checkout's
`chip_smoke.py` P2_CHECK_F and P2_WRAP_F pops, as its phase 9 does) to the
tree's plain versions bit for bit, then times P1 at the TPU probe's 2,000
laps and every P2 variant at its 20,000 pops with CUDA events (median of
`--runs`, 10 unless given, after a warm-up), the SM clock sampled over the
timing.  Prints the card's name and power limit, one line per turn with ns
and cycles a lap (at the turn's median clock) and the share of this
checkout's bound on one SM (`chip_smoke.py probe_bound`) that each time
reaches, and the medians per tree; `--out FILE` writes the same as JSON.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import P2_CHECK_F, P2_WRAP_F, probe_bound  # noqa: E402
from tools import turns as T  # noqa: E402

# Runs in a tree after turns.BUILD_PRELUDE; uses only what every tree's
# ops/probes.py has had since the probes were ported.
WORKER = r"""
import json, sys
runs, check_f, wrap_f = (int(a) for a in sys.argv[1:4])
import torch
from pathtracer_tpu_torch.ops import probes
from tools.cuda_timing import median_ms, sm_clock
tab, rays = probes.rowprim_inputs("cuda")
args = probes.pop_inputs("cuda")
same = True
for laps in (probes.ROWPRIM_LAPS, 1, 3, 5):
    same &= torch.equal(probes.rowprim(tab, rays, laps), probes.rowprim_plain(tab, rays, laps))
for v in probes.P2_VARIANTS:
    for acc0, F in ((probes.POP_ACC0, check_f), (50.0 if v == "leaf_mt" else 0.0, wrap_f)):
        kw = dict(F=F, acc0=acc0)
        same &= torch.equal(probes.pop(v, *args, **kw), probes.pop_plain(v, *args, **kw))
ms = {}
with sm_clock() as clock:
    ms["P1"] = median_ms(lambda: probes.rowprim(tab, rays), runs)
    for v in probes.P2_VARIANTS:
        ms[v] = median_ms(lambda: probes.pop(v, *args), runs)
report = {k: v for k, v in _build.ptxas_report().items() if k.startswith("p")}
print("RESULT " + json.dumps({"ms": ms, "clock": clock, "bitwise_equal": bool(same),
                              "laps": {"P1": probes.ROWPRIM_LAPS, "P2": probes.POP_F},
                              "ptxas": report}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", metavar="TREE[:NAME=VALUE,...]")
    p.add_argument("--out", type=Path)
    p.add_argument("--runs", type=int, default=10)
    args = p.parse_args(argv)

    smi = T.card()
    turns = []
    for spec in args.trees:
        res = T.run_turn(spec, WORKER, str(args.runs), str(P2_CHECK_F), str(P2_WRAP_F))
        if not res["clock"]:
            raise SystemExit(f"{spec}: the SM clock was not sampled")
        mhz = statistics.median(res["clock"])
        cells = {}
        for probe, ms in res["ms"].items():
            laps = res["laps"]["P1" if probe == "P1" else "P2"]
            b = probe_bound(probe, laps, mhz)
            cells[probe] = {"ms": ms, "ns_per_lap": ms / laps * 1e6,
                            "cycles_per_lap": ms / laps * mhz * 1e3,
                            "bound_cycles": b["clocks_per_lap"], "bound_by": b["by"],
                            "bound_share": b["ms"] / ms}
        turns.append({"tree": spec, "mhz": mhz, "samples": len(res["clock"]), "cells": cells,
                      "bitwise_equal": res["bitwise_equal"], "ptxas": res["ptxas"]})
        T.print_ptxas(spec, res["ptxas"])
        print(f"{spec}: SM clock {mhz:.0f} MHz (median of {len(res['clock'])} samples, "
              f"{min(res['clock']):.0f}-{max(res['clock']):.0f}); P1 and P2 equal to the plain "
              f"versions bit for bit: {res['bitwise_equal']}", flush=True)
        for probe, c in cells.items():
            print(f"  {probe:16s} {c['ms']:9.4f} ms, {c['ns_per_lap']:9.3f} ns, "
                  f"{c['cycles_per_lap']:8.1f} cycles a lap; bound {c['bound_cycles']:7.2f} "
                  f"({c['bound_by']}), bound / time {c['bound_share']:.3f}", flush=True)

    print("medians over each tree's turns (cycles a lap; the turns in brackets):")
    T.print_medians(turns, lambda t: {"": {k: c["cycles_per_lap"] for k, c in t["cells"].items()}},
                    ".1f")
    T.write_out(args.out, smi, turns)
    wrong = sorted({t["tree"] for t in turns if not t["bitwise_equal"]})
    if wrong:
        raise SystemExit(f"a probe disagrees with its plain version in {wrong}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
