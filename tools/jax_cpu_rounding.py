"""How XLA's CPU compiler rounds against the port's eager PyTorch ops, and what
that does to the Cornell-box parity of tests/test_torch_cornell.py.

    JAX_PLATFORMS=cpu python tools/jax_cpu_rounding.py

Runs itself twice, in a process with XLA's default flags and in one with
`--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp` (no fused
multiply-add, no algebraic rewrites).  Each prints, for 1,000,000 float32
inputs made from seed 0, the share of jitted results that differ from one
rounding per operation (numpy float32) for a*b - c, 1/sqrt(x) and x/3;
then renders scenes/cornell_spheres.txt with the JAX package and with the
port on the CPU (64x64, depth 4, 2 spp, seed 0: tests/test_torch_render.py
jax_reference) in the three modes and prints the pixels outside rtol 1e-4,
atol 1e-5 and the pixels bitwise equal.  CPU only; this tool, unlike the
port, imports JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ONE_ROUNDING = "--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"


def child() -> None:
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
    from tests.test_torch_render import ATOL, RTOL, jax_reference

    g = np.random.default_rng(0)
    a, b, c = (g.standard_normal(1_000_000).astype(np.float32) for _ in range(3))
    x = g.uniform(0.1, 10.0, 1_000_000).astype(np.float32)
    one = np.float32(1.0)
    cases = {
        "a*b - c": (jax.jit(lambda a, b, c: a * b - c)(a, b, c), a * b - c),
        "1/sqrt(x)": (jax.jit(lambda x: 1.0 / jnp.sqrt(x))(x), one / np.sqrt(x)),
        "x/3": (jax.jit(lambda x: x / 3.0)(x), x / np.float32(3.0)),
    }
    print("  jitted results that differ from one rounding per operation: " + ", ".join(
        f"{k} {float((np.asarray(j) != want).mean()):.4f}" for k, (j, want) in cases.items()))
    scene = ROOT / "scenes" / "cornell_spheres.txt"
    for mode in SampleMode:
        ref = jax_reference(scene, mode.name)
        port = Renderer(scene, opts=RenderOptions(sample_mode=mode), resolution=(64, 64),
                        trace_depth=4, device="cpu")
        port.set_seed(0)
        port.step(2)
        got = port.hdr_sum()
        ok = np.isclose(got, ref["img"], rtol=RTOL, atol=ATOL).all(-1)
        print(f"  cornell_spheres {mode.name}: {int((~ok).sum())} of {ok.size} pixels outside "
              f"rtol {RTOL}, atol {ATOL}; {int((got == ref['img']).all(-1).sum())} bitwise equal",
              flush=True)


def main() -> int:
    if "--child" in sys.argv:
        child()
        return 0
    for label, flags in (("XLA defaults", ""), (f"XLA_FLAGS {ONE_ROUNDING}", ONE_ROUNDING)):
        print(label, flush=True)
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {flags}".strip()}
        res = subprocess.run([sys.executable, __file__, "--child"], env=env, cwd=ROOT,
                             capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
