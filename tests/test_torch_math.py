"""The port's ops/math.py against the JAX package's on identical inputs.

Tolerance rtol=1e-6, atol=1e-7: both sides are float32 with the same
operation order; the transcendental functions (sin, cos, sqrt, pow) of XLA
and PyTorch may differ in the last bit or two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import math as jm
from pathtracer_tpu_torch.ops import math as tm

N = 4096
RTOL, ATOL = 1e-6, 1e-7


def _dirs(seed):
    v = np.random.default_rng(seed).normal(size=(N, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _u(seed, cols=None, lo=0.0, hi=1.0):
    shape = (N,) if cols is None else (N, cols)
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


def _wo_above(n, seed):
    """Directions on the same side as n (what the GGX samplers are fed)."""
    w = _dirs(seed)
    return np.where((w * n).sum(-1, keepdims=True) < 0, -w, w).astype(np.float32)


n1, n2 = _dirs(1), _dirs(2)
CASES = {
    "dot": ("dot", (n1, n2)),
    "length": ("length", (n1 * 3.0,)),
    "length2": ("length2", (n1 * 3.0,)),
    "normalize": ("normalize", (_u(3, 3, -2, 2),)),
    "cross": ("cross", (n1, n2)),
    "mix": ("mix", (n1, n2, _u(4, 3))),
    "pow5": ("pow5", (_u(5),)),
    "sqr": ("sqr", (_u(5, lo=-2, hi=2),)),
    "process_nan": ("process_nan", (np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32),)),
    "aces_film": ("aces_film", (_u(6, 3, 0, 20),)),
    "gamma_correction": ("gamma_correction", (_u(7, 3, -0.1, 1),)),
    "onb_pixar": ("onb_pixar", (n1,)),
    "sample_triangle_uniform": ("sample_triangle_uniform", (_u(8, 2),)),
    "sample_uniform_disc": ("sample_uniform_disc", (_u(9, 2),)),
    "sample_hemisphere_cosine": ("sample_hemisphere_cosine", (n1, _u(10, 2))),
    "reflect_dir": ("reflect_dir", (n1, n2)),
    "reflect": ("reflect", (n1, n2)),
    "refract_dir": ("refract_dir", (n1, n2, np.float32(1.0), np.float32(1.5))),
    "refract_dir_arrays": ("refract_dir", (n1, n2, _u(11, lo=1, hi=1.6), _u(12, lo=1, hi=1.6))),
    "fresnel_schlick_rgb": ("fresnel_schlick", (_u(13, 3), _u(14))),
    "fresnel_schlick_scalar": ("fresnel_schlick", (np.float32(0.04), _u(14))),
    "fresnel_maxwell": ("fresnel_maxwell", (_u(15), _u(16, lo=1, hi=1.6), _u(17, lo=1, hi=1.6))),
    "ndf_ggx": ("ndf_ggx", (_u(18, lo=-0.2, hi=1), _u(19, lo=1e-3, hi=1))),
    "smith_g1": ("smith_g1", (_u(20, lo=1e-3, hi=1), _u(21, lo=0.01, hi=1))),
    "smith_g2": ("smith_g2", (_u(22, lo=1e-3, hi=1), _u(23, lo=0.01, hi=1), _u(24, lo=0.01, hi=1))),
    "sample_normal_ggx": ("sample_normal_ggx", (n1, _wo_above(n1, 25), _u(26, lo=0.05, hi=1), _u(27, 2))),
    "sample_normal_ggx_scalar_alpha": ("sample_normal_ggx", (n1, _wo_above(n1, 25), np.float32(0.3), _u(27, 2))),
    "power_heuristic": ("power_heuristic", (_u(28, lo=-1, hi=5), _u(29, lo=0, hi=5))),
}


def _to_torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) and x.ndim else float(x)


def _to_jax(x):
    return jnp.asarray(x)


# The VNDF sampler computes sqrt(1 - |p|^2) from a disc sample p, which turns
# a last-bit difference in XLA's and PyTorch's sin/cos (sample_uniform_disc,
# checked on its own above) into ~1e-5 near the rim.  For the GGX cases both
# packages get the same disc points, so the rest is held to the tolerance.
DISC_FED = {"sample_normal_ggx", "sample_normal_ggx_scalar_alpha"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, monkeypatch):
    fn, args = CASES[case]
    if case in DISC_FED:
        r = args[-1].astype(np.float64)
        disc = np.stack(
            [np.sqrt(r[:, 0]) * np.cos(2 * np.pi * r[:, 1]),
             np.sqrt(r[:, 0]) * np.sin(2 * np.pi * r[:, 1])], -1
        ).astype(np.float32)
        monkeypatch.setattr(jm, "sample_uniform_disc", lambda _: jnp.asarray(disc))
        monkeypatch.setattr(tm, "sample_uniform_disc", lambda _: torch.from_numpy(disc))
    want = getattr(jm, fn)(*map(_to_jax, args))
    got = getattr(tm, fn)(*map(_to_torch, args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_power_heuristic_zero_guard():
    z = torch.zeros(3)
    assert torch.equal(tm.power_heuristic(z, z), z)
