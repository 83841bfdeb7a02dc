"""The port's images against the independent oracle (tools/oracle.py).

tools/oracle.py is a numpy port of the reference CUDA kernels' semantics
that shares no code with either package.  tools/oracle_compare_torch.py
renders a scene with the port and with the oracle at matched spp, seeds 0
and 1: two unbiased renders of the same integral differ by about the
quadrature of the two implementations' seed-to-seed floors, and a shared
misreading of the physics would not shrink with spp.  Here, on the CPU:
scenes/cornell_spheres.txt (all five materials, the sphere lamp's NEE) MIS
at 32x32, 32 spp.  Both renders are seeded, so the numbers are fixed per
code version: rmse_ldr 0.0717 against floor_quad_ldr 0.1036 (ratio 0.69;
1/sqrt(2) for matched physics), rmse_lin 0.0436.
"""

import subprocess
import sys

import pytest
import torch

from tests.test_torch_render import ROOT
from tools.oracle_compare_torch import compare

# about 2x the measured cross RMSE of mean linear radiance (0.0436)
RMSE_LIN_MAX = 0.09


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, as the other port tests that render."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


def test_cross_rmse_at_noise_floor():
    out = compare(ROOT / "scenes" / "cornell_spheres.txt", "mis", res=32, spp=32, device="cpu")
    print(out)
    assert out["device"] == "cpu" and "card" not in out
    assert out["floor_ours_ldr"] > 0 and out["floor_oracle_ldr"] > 0
    assert out["rmse_ldr"] <= out["floor_quad_ldr"], out
    assert out["rmse_lin"] <= RMSE_LIN_MAX, out


def test_tool_runs_without_jax():
    """The tool imports and runs with JAX and the JAX package blocked (the
    card's machine has no JAX)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pathtracer_tpu'] = None\n"
        "from tools import oracle_compare_torch as t\n"
        "assert t.main(['scenes/cornell_spheres.txt', '--device', 'cpu', '--res', '8',\n"
        "               '--spp', '1', '--no-floors']) == 0\n"
        "assert not any(m == 'pathtracer_tpu' or m.startswith(('jax.', 'pathtracer_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert '"rmse_ldr"' in res.stdout and '"device": "cpu"' in res.stdout
