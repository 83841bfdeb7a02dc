"""The port's pool scheduler: the per-bounce sort, the shrink ladder and the
shadow sort (`pathtracer_tpu_torch/integrator/wavefront.py schedule`,
`ops/traverse.py occlusion_test`).

The scheduler only moves lanes: each lane keys its RNG on its own id and
carries its contributions, and the result is un-permuted by that id before
the env resolve.  So on the CPU the accumulated HDR sum is held **bitwise**
equal to the unsorted pool's (`compaction=False`) under every schedule, with
the rays counted exactly equal, on three scenes at 64x64, depth 6, 3 spp,
MIS, `packet_rows=1` (ladder sizes in tiles of 128 lanes, so that the ladder
fires in a 4,096-lane pool):

- a lit 600-triangle soup over a floor (tests/test_regen.py lit_soup_scene):
  the sort is on (512 triangles or more) and most paths leave the scene;
- scenes/cornell_spheres.txt: analytic and closed, its liveness stays high;
- a sphere under a procedural sky (tests/test_envmap.py make_env_scene):
  analytic and open, so it shrinks without sorting, and its env-missed lanes
  resolve after the ladder has moved them.

The ladder is shown to run: the pool length at each lap is held to a
restatement of the JAX package's rule over the live counts that lap saw.
Against the JAX package: `occlusion_test(shadow_sort=True)` against the JAX
package's with the Pallas kernel in interpret mode, and default-schedule
renders of the 576-triangle torus box and scenes/texcube.txt with
`packet_rows=1`, held to the JAX package's renders as the torus slice is
(tests/test_torch_render.py render_and_compare; the JAX side in a process of
its own with XLA rounding each operation once, as tests/test_torch_textured.py
does).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import traverse as jtv
from pathtracer_tpu.scene.flatscene import build_flat_scene
from pathtracer_tpu.scene.parser import load_scene
from pathtracer_tpu_torch.integrator import wavefront
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.ops import traverse as ttv
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_envmap import make_env_scene
from tests.test_regen import lit_soup_scene
from tests.test_torch_cornell import XLA_ONE_ROUNDING
from tests.test_torch_render import render_and_compare, small_torus_scene
from tests.test_torch_traverse import _box_rays, _port, _t, port_static
from tools.make_texture_assets import ensure_texture_assets

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several files at once, and
    PyTorch's pool of one thread per core, once per worker, spends the
    cores waiting on each other (the port's ops are many and small)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)
RES, DEPTH, SPP = 64, 6, 3
SCHEDULES = {
    "default": {},
    "pool_shrink=False": {"pool_shrink": False},
    "shrink_half": {"shrink_half": True},
    "sort_every=2": {"sort_every": 2},
    "shadow_sort": {"shadow_sort": True},
}


def env_ball_scene(tmp_path) -> Path:
    """A white sphere under a dim sky with a bright patch: the env misses
    carry real energy."""
    img = 0.05 * np.ones((16, 32, 3), np.float32)
    img[4:7, 20:26] = 9.0
    return make_env_scene(tmp_path, img)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schedule")
    return {"lit_soup": lit_soup_scene(tmp, n=600, seed=11),
            "cornell_spheres": ROOT / "scenes" / "cornell_spheres.txt",
            "env_ball": env_ball_scene(tmp)}


def render(scene, **options) -> tuple[np.ndarray, int, Renderer]:
    """The port's MIS render of `scene` on the CPU (RES x RES, DEPTH, SPP,
    seed 0, packet_rows=1, RenderOptions `options` besides): (HDR sum, rays,
    renderer)."""
    r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS, packet_rows=1, **options),
                 resolution=(RES, RES), trace_depth=DEPTH, device="cpu")
    r.set_seed(0)
    stats = r.step(SPP)
    return r.hdr_sum(), stats.rays_traced, r


@pytest.fixture(scope="module")
def unsorted(scenes):
    return {name: render(path, compaction=False)[:2] for name, path in scenes.items()}


@pytest.mark.parametrize("scene", ["lit_soup", "cornell_spheres", "env_ball"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_is_bitwise_neutral(scenes, unsorted, scene, schedule):
    img, rays, _ = render(scenes[scene], **SCHEDULES[schedule])
    want, want_rays = unsorted[scene]
    assert want.sum() > 1.0  # the scene is lit
    np.testing.assert_array_equal(img, want)
    assert rays == want_rays


def expected_pools(n: int, ladder: tuple, alive_after: list) -> list:
    """The pool length at each lap of one iteration, by the JAX package's
    rule: before a lap, while the live lanes fit the next level
    (alive * divisor <= the pool), the pool drops to it."""
    pools, cur, level, alive = [], n, 0, n
    for after in alive_after:
        while level < len(ladder) and alive * ladder[level][1] <= cur:
            cur = ladder[level][0]
            level += 1
        pools.append(cur)
        alive = after
    return pools


@pytest.fixture
def laps(monkeypatch):
    """(pool length, live lanes after the lap) of every bounce run."""
    seen = []
    real = wavefront.bounce

    def spy(*args, **kwargs):
        out, rays = real(*args, **kwargs)
        seen.append((out.lane.shape[0], int(out.alive.sum())))
        return out, rays

    monkeypatch.setattr(wavefront, "bounce", spy)
    return seen


@pytest.mark.parametrize("scene,options,ladder", [
    ("lit_soup", {}, ((1024, 4), (256, 4))),
    ("lit_soup", {"shrink_half": True}, ((2048, 2), (512, 4), (128, 4))),
    # analytic: shrinks without the per-bounce sort, and no half level
    ("env_ball", {"shrink_half": True}, ((1024, 4), (256, 4))),
])
def test_ladder_runs(scenes, laps, scene, options, ladder):
    _, _, r = render(scenes[scene], **options)
    sched = wavefront.schedule(r.static, r.opts, RES * RES)
    assert sched.shrink == ladder
    assert sched.sort_rays == (scene == "lit_soup")
    iterations, cur = [], []
    for pool_n, alive in laps:
        cur.append((pool_n, alive))
        if alive == 0:
            iterations.append(cur)
            cur = []
    assert not cur and len(iterations) == SPP
    for it in iterations:
        assert [p for p, _ in it] == expected_pools(RES * RES, ladder, [a for _, a in it])
    smallest = min(p for p, _ in laps)
    print(f"{scene} {options}: pool lengths per lap {[[p for p, _ in it] for it in iterations]}")
    assert smallest <= ladder[1][0]  # at least two levels ran
    assert r.lap_pools == [p for p, _ in iterations[-1]]
    assert r.traced_depth == len(iterations[-1])


@pytest.fixture(scope="module")
def torus_box(tmp_path_factory):
    path = small_torus_scene(tmp_path_factory.mktemp("schedule_torus"))
    flat, static = build_flat_scene(load_scene(path))
    return flat, static, _port(flat, static)


def test_shadow_sort_matches_jax(torus_box):
    """The port's occlusion_test with the shadow sort against the JAX
    package's (its Pallas any-hit kernel in interpret mode) and against the
    port's own unsorted pass, lane for lane."""
    flat, static, tflat = torus_box
    n = 1024
    o, d = _box_rays(n, seed=43)
    des = o + d * np.random.default_rng(44).uniform(0.5, 6.0, size=(n, 1)).astype(np.float32)
    enabled = np.arange(n) % 3 != 0
    want = jtv.occlusion_test(flat, static, jnp.asarray(o), jnp.asarray(d), jnp.asarray(des),
                              enabled=jnp.asarray(enabled), use_pallas=True, interpret=True,
                              shadow_sort=True)
    static = port_static(static)
    got = ttv.occlusion_test(tflat, static, _t(o), _t(d), _t(des), enabled=_t(enabled),
                             shadow_sort=True)
    plain = ttv.occlusion_test(tflat, static, _t(o), _t(d), _t(des), enabled=_t(enabled))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert 0 < got.sum() < n


_REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tests.test_torch_render import jax_reference
out = {}
for name, scene in json.loads(sys.argv[3]):
    for key, value in jax_reference(scene, "MIS").items():
        out[f"{name}/{key}"] = value
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's MIS renders (64x64, depth 4, 2 spp) of the torus box
    and texcube, in one process with XLA_ONE_ROUNDING."""
    ensure_texture_assets()
    tmp = tmp_path_factory.mktemp("schedule_ref")
    cases = {"glasstorus": small_torus_scene(tmp), "texcube": ROOT / "scenes" / "texcube.txt"}
    out = tmp / "ref.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_ROUNDING}".strip()}
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(ROOT), str(out),
         json.dumps([[k, str(v)] for k, v in cases.items()])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as f:
        refs = {name: {key: f[f"{name}/{key}"] for key in ("img", "ldr", "rays", "iteration")}
                for name in cases}
    return cases, refs


@pytest.mark.parametrize("scene", ["glasstorus", "texcube"])
def test_default_schedule_matches_jax(references, scene):
    """The port's default schedule (the sort, and the ladder in tiles of 128
    lanes) against the JAX package's render."""
    cases, refs = references
    port = render_and_compare(cases[scene], SampleMode.MIS, ref=refs[scene], packet_rows=1)
    sched = wavefront.schedule(port.static, port.opts, 64 * 64)
    assert sched.sort_rays and sched.shrink
    if scene == "texcube":  # an open scene: most paths leave it early
        assert min(port.lap_pools) < 64 * 64
