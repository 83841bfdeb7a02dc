"""A cell's smallest window on the card, through the runner as the benchmark
is run: untraced, and traced with the roofline's kernels (skips where there
is no CUDA card)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell,trace", [("cornell_spheres.bsdf", 0), ("glasstorus.mis", 1)])
def test_smallest_window_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 9),
                          "--seconds", "1", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["metrics"]["walk_roofline_pct"]["value"] <= 100
        assert line["device"]["busy_s"] > 0
    else:
        assert set(line["metrics"]) == {"msamples_per_s", "setup_s"}
