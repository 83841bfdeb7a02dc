"""The triangle-free main path: scenes/cornell_spheres.txt, an analytic
Cornell box (spheres and cubes, a sphere lamp) with one sphere of each of the
four surface materials, through the port's Renderer against the JAX
package's on the CPU.

64x64, depth 4, 2 spp, seed 0, in all three modes, held as the torus slice
is (tests/test_torch_render.py render_and_compare): at least 99.9% of the
pixels within rtol 1e-4, atol 1e-5, DIRECT_LI ray counts exact, LDR within
1e-3; the outlier count of each mode is printed.

The JAX package renders in a process of its own, with XLA told to round each
operation of its source as written: no fused multiply-add
(`--xla_cpu_max_isa=AVX`, below the ISA that has one) and no algebraic
rewrites (`--xla_disable_hlo_passes=algsimp`, which turns 1/sqrt(x) into an
rsqrt and x/c into x*(1/c)).  The port's eager PyTorch ops round once per
operation, as the source reads.  With XLA's defaults the two drift by a few
ulps, and this scene magnifies that drift: a near-tangent ray's sphere root
sqrt(vdd^2 - c) moves t by up to 3e-4 for one ulp of its radicand
(test_torch_shading.py test_sphere_silhouettes_match_jax_op_by_op), and the
glossy lobes move the NEE weights with it: 16 of 4,096 MIS pixels past the
tolerance (tools/jax_cpu_rounding.py).  The scene has no triangle, so
closest_hit and occlusion_test return before any traversal kernel or its
plain version: none may be called and no launch counter may move.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.ops import traverse_cuda as tc
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu_torch.scene.parser import (
    CUBE,
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    METALLIC_WORKFLOW,
    MICROFACET,
    SPHERE,
    load_scene,
)
from pathtracer_tpu_torch.utils.config import SampleMode
from tests.test_torch_render import render_and_compare

ROOT = Path(__file__).resolve().parent.parent
SCENE = ROOT / "scenes" / "cornell_spheres.txt"
KERNELS = ("closest_hit_wbvh", "occlusion_wbvh", "closest_hit_stream", "occlusion_stream",
           "closest_hit_blockmajor")
XLA_ONE_ROUNDING = "--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"
MODES = [SampleMode.BSDF, SampleMode.DIRECT_LI, SampleMode.MIS]

_REFERENCE = """
import sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tests.test_torch_render import jax_reference
out = {}
for mode in sys.argv[4].split(","):
    for key, value in jax_reference(sys.argv[2], mode).items():
        out[f"{mode}/{key}"] = value
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's renders of the scene in the three modes, made in one
    process with XLA_ONE_ROUNDING."""
    out = tmp_path_factory.mktemp("cornell_ref") / "ref.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_ROUNDING}".strip()}
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(ROOT), str(SCENE), str(out),
         ",".join(m.name for m in MODES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as f:
        return {m.name: {key: f[f"{m.name}/{key}"] for key in ("img", "ldr", "rays", "iteration")}
                for m in MODES}


def test_scene_is_self_contained():
    """Spheres and cubes only: no OBJ, texture or environment file."""
    scene = load_scene(SCENE)
    assert {g.type for g in scene.geoms} == {SPHERE, CUBE}
    assert not scene.textures and scene.env_map_id < 0
    assert scene.camera.resolution == (800, 800) and scene.trace_depth == 8
    assert scene.iterations == 2000


@pytest.mark.parametrize("mode", MODES)
def test_cornell_matches_jax(mode, references, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a triangle-free scene reached a traversal kernel")

    for name in KERNELS:
        monkeypatch.setattr(ttv, name, refuse)
    tc.reset_launch_counts()
    ts.reset_launch_counts()
    port = render_and_compare(SCENE, mode, ref=references[mode.name])
    assert port.static.num_tris == 0
    assert set(port.static.material_types) == {
        LAMBERTIAN, DIELECTRIC, MICROFACET, METALLIC_WORKFLOW, LIGHT}
    assert (tc.closest_launches, tc.occlusion_launches) == (0, 0)
    assert (ts.closest_launches, ts.occlusion_launches, ts.blockmajor_launches) == (0, 0, 0)
