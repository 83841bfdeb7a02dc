"""The turns of the tools that time the kernels of several checkouts of this
repository on one card (`compare_walk_kernels.py`, `compare_probes.py`).

A turn is one TREE[:NAME=VALUE,...] argument: the root of a checkout that
holds the port, and compile-time defines for its kernels.  `run_turn` runs a
worker script in a process of its own, with the tree's root as working
directory and import path; the tree's `ops/_build.py` passes the defines to
nvcc as `-D` and puts the libraries into a build directory of their own.
The worker prints its result as one line `RESULT <json>`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# Runs before every worker, in the tree: builds the tree's kernels with the
# turn's defines.  Uses only what every tree's ops/_build.py has had since
# the probes were ported.
BUILD_PRELUDE = r"""
import os
from pathtracer_tpu_torch.ops import _build
_defines = [a for a in os.environ.get("TURN_DEFINES", "").split(",") if a]
if _defines:
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple("-D" + a for a in _defines)
    _build.BUILD_DIR = _build.BUILD_DIR / ("variant_" + "_".join(_defines).replace("=", "-"))
_build.load_library()
"""


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them; printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    return smi


def tree_root(spec: str) -> Path:
    return Path(spec.partition(":")[0]).resolve()


def run_turn(spec: str, worker: str, *args: str) -> dict:
    """Runs `worker` with `args` in the tree of `spec` after BUILD_PRELUDE;
    returns its RESULT, or exits with the worker's output tails."""
    defines = spec.partition(":")[2]
    root = tree_root(spec)
    proc = subprocess.run([sys.executable, "-c", BUILD_PRELUDE + worker, *args], cwd=root,
                          env={**os.environ, "PYTHONPATH": str(root), "TURN_DEFINES": defines},
                          capture_output=True, text=True)
    line = next((l for l in proc.stdout.splitlines() if l.startswith("RESULT ")), None)
    if proc.returncode != 0 or line is None:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
        raise SystemExit(f"the turn of {spec} failed")
    return json.loads(line[len("RESULT "):])


def print_ptxas(spec: str, report: dict) -> None:
    for kernel, props in sorted(report.items()):  # empty when already built
        print(f"{spec} ptxas {kernel}: {props}", flush=True)


def print_medians(turns: list[dict], rows, fmt: str) -> None:
    """For each tree, in the order it first ran, and each row of
    `rows(turn)` ({label: {name: value}}): the median of each value over the
    tree's turns, the turns' values in brackets."""
    for spec in dict.fromkeys(t["tree"] for t in turns):
        mine = [rows(t) for t in turns if t["tree"] == spec]
        for label, names in mine[0].items():
            cells = []
            for name in names:
                vals = [m[label][name] for m in mine]
                cells.append(f"{name} {statistics.median(vals):{fmt}} "
                             f"({' / '.join(f'{v:{fmt}}' for v in vals)})")
            print(f"  {spec}{label}: " + ", ".join(cells))


def write_out(path: Path | None, smi: str, turns: list[dict]) -> None:
    if path:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"card": smi, "turns": turns}, indent=1))
