"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either.  Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys

from benchmark.lib import harness
from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pathtracer_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of the modules loaded by running `code`."""
    prog = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_package():
    names = _loaded(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark.reference.render import Reference\n"
        "from benchmark.reference import rng\n"
        "from benchmark.lib import check\n"
        "r = Reference('benchmark/configs/scenes/glasstorus.txt', 'cpu', resolution=(8, 8))\n"
        "p = torch.arange(64)\n"
        "r.radiance(rng.base_key(3), True, p, p, 1)")
    assert not names & (FORBIDDEN | {"pathtracer_tpu_torch"})


def test_runner_loads_no_jax():
    names = _loaded(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark.lib import harness\n"
        "harness.run('cornell_spheres.bsdf', 3, 0.1, False, device='cpu', resolution=(8, 8))")
    assert "pathtracer_tpu_torch" in names and not names & FORBIDDEN


def test_forbidden_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
