"""The port's step factory (`integrator/wavefront.py make_render_iteration`)
and driver entry (`pathtracer_tpu_torch/entry.py`) on the CPU.

- Against the JAX package: the factory on scenes/cornell_spheres.txt (64x64,
  depth 4, MIS, seed 0, the scene built as each package's driver entry builds
  it), iterations 1 and 2 accumulated, and a `local_rows=16` step from pixel
  16 * 64, each within rtol 1e-4, atol 1e-5 on every pixel with rays and
  depth exact; the JAX side in a process of its own with XLA rounding each
  operation once (tests/test_torch_cornell.py).  The depth under the shrink
  ladder, on the lit soup of tests/test_regen.py, against the JAX factory's
  traced depth (XLA walk, in this process).
- The port alone, bit for bit: row slices against the full step's rows, the
  regeneration variant against `render_iteration(..., nk=3)`, entry()'s step
  against a Renderer's first iteration, and the dry run's passes (pixel
  sharding on the Cornell box and a 576-triangle torus box, sample sharding)
  against the one-device steps, over two CPU shards.
- The card by default: entry(), the dry run, `build_flat_scene` and `cli
  info` raise without CUDA unless asked for the CPU; `--cards` takes the
  visible cards.
"""

import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.wavefront import CameraArrays as JaxCameraArrays
from pathtracer_tpu.integrator.wavefront import make_render_iteration as jax_make_render_iteration
from pathtracer_tpu.scene.camera import derive_camera
from pathtracer_tpu.scene.flatscene import build_flat_scene as jax_build_flat_scene
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.utils import config as jax_config
from pathtracer_tpu.utils import rng as jax_rng
from pathtracer_tpu_torch import cli, entry
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.integrator.wavefront import make_render_iteration, render_iteration
from pathtracer_tpu_torch.scene.flatscene import build_flat_scene
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tests.test_regen import lit_soup_scene
from tests.test_torch_cornell import XLA_ONE_ROUNDING
from tests.test_torch_render import ATOL, MIN_FRAC, ROOT, RTOL, small_torus_scene

RES, LOCAL_ROWS = 64, 16

_REFERENCE = """
import sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import __graft_entry__ as graft
from pathtracer_tpu.integrator.wavefront import make_render_iteration
res, rows = int(sys.argv[4]), int(sys.argv[5])
flat, static, opts, cam, key = graft._build(res, res, scene_path=sys.argv[2])
step = jax.jit(make_render_iteration(static, opts, res, res))
img, out = jnp.zeros((res * res, 3), jnp.float32), {}
for it in (1, 2):
    img, rays, depth = step(flat, cam, img, jnp.int32(it), key)
    out[f"img{it}"], out[f"rays{it}"], out[f"depth{it}"] = np.asarray(img), int(rays), int(depth)
local = jax.jit(make_render_iteration(static, opts, res, res, local_rows=rows))
img, rays, depth = local(flat, cam, jnp.zeros((rows * res, 3), jnp.float32), jnp.int32(1), key,
                         jnp.int32(rows * res))
out["local_img"], out["local_rays"], out["local_depth"] = np.asarray(img), int(rays), int(depth)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads (see tests/test_torch_schedule.py)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX factory's steps on cornell_spheres (`__graft_entry__._build`),
    made in one process with XLA_ONE_ROUNDING."""
    out = tmp_path_factory.mktemp("entry_ref") / "ref.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_ROUNDING}".strip()}
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(ROOT), str(entry.SCENE), str(out), str(RES),
         str(LOCAL_ROWS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as f:
        return {key: f[key] for key in f.files}


@pytest.fixture(scope="module")
def cornell():
    return entry._build(RES, RES, device="cpu")


@pytest.fixture(scope="module")
def soup(tmp_path_factory):
    return lit_soup_scene(tmp_path_factory.mktemp("entry_soup"), n=600, seed=11)


def zeros(rows=RES):
    return torch.zeros((rows * RES, 3), dtype=torch.float32)


def assert_close(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{int((~ok).sum())} of {ok.size} pixels outside tolerance, "
          f"{int((got == want).all(-1).sum())} bitwise equal")
    assert ok.all()


def test_factory_matches_jax(reference, cornell):
    flat, static, opts, cam, key = cornell
    step = make_render_iteration(static, opts, RES, RES)
    assert step.trace_depth == 4
    img = zeros()
    for it in (1, 2):
        img, rays, depth = step(flat, cam, img, it, key)
        assert img.shape == (RES * RES, 3) and rays.dtype == torch.int64
        assert_close(img, reference[f"img{it}"])
        assert int(rays) == reference[f"rays{it}"]
        assert depth == reference[f"depth{it}"]


def test_local_rows_match_jax(reference, cornell):
    flat, static, opts, cam, key = cornell
    local = make_render_iteration(static, opts, RES, RES, local_rows=LOCAL_ROWS)
    img, rays, depth = local(flat, cam, zeros(LOCAL_ROWS), torch.tensor(1), key,
                             torch.tensor(LOCAL_ROWS * RES))
    assert img.shape == (LOCAL_ROWS * RES, 3)
    assert_close(img, reference["local_img"])
    assert int(rays) == reference["local_rays"]
    assert depth == reference["local_depth"]


def test_depth_under_the_ladder_matches_jax(soup):
    """The lit soup sorts and shrinks (4,096 -> 1,024 -> 256 lanes, tiles of
    128): the laps of every level count, as the JAX package's traced depth
    carries through its sub-pools.  The JAX side walks its XLA BVH with
    XLA's default rounding, hence the slice's 99.9% of pixels."""
    jscene = jax_load_scene(soup)
    jscene.camera.resolution = (RES, RES)
    jscene.trace_depth = 4
    jopts = jax_config.RenderOptions(sample_mode=jax_config.SampleMode.MIS,
                                     pallas_traversal=False, packet_rows=1)
    jflat, jstatic = jax_build_flat_scene(jscene, opts=jopts)
    jcam = JaxCameraArrays(*[jnp.asarray(x) for x in derive_camera(jscene.camera).as_arrays()])
    want, want_rays, want_depth = jax.jit(jax_make_render_iteration(jstatic, jopts, RES, RES))(
        jflat, jcam, jnp.zeros((RES * RES, 3), jnp.float32), jnp.int32(1), jax_rng.base_key(0))

    r = Renderer(soup, opts=RenderOptions(sample_mode=SampleMode.MIS, packet_rows=1,
                                          swizzle=False),
                 resolution=(RES, RES), trace_depth=4, device="cpu")
    step = make_render_iteration(r.static, r.opts, RES, RES)
    img, rays, depth = step(r.flat, r._cam_arrays(), zeros(), 1, r.key)
    laps = render_iteration(r.flat, r.static, r.opts, r._cam_arrays(), r.key, 1)[2]
    assert min(laps) < RES * RES  # the ladder ran
    assert depth == len(laps) == int(want_depth)
    assert int(rays) == int(want_rays)
    ok = np.isclose(img.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= MIN_FRAC


@pytest.mark.parametrize("row0", [0, 16, 40])
def test_local_rows_are_the_full_steps_rows(cornell, row0):
    flat, static, opts, cam, key = cornell
    full, full_rays, _ = make_render_iteration(static, opts, RES, RES)(flat, cam, zeros(), 2, key)
    local = make_render_iteration(static, opts, RES, RES, local_rows=LOCAL_ROWS)
    img, rays, depth = local(flat, cam, zeros(LOCAL_ROWS), 2, key, row0 * RES)
    assert torch.equal(img, full[row0 * RES:(row0 + LOCAL_ROWS) * RES])
    assert 0 < int(rays) < int(full_rays) and depth >= 1


@pytest.mark.parametrize("scene", ["cornell_spheres", "lit_soup"])
def test_regen_variant_is_render_iteration(cornell, soup, scene):
    if scene == "cornell_spheres":
        flat, static, opts, cam, key = cornell
    else:
        r = Renderer(soup, opts=RenderOptions(sample_mode=SampleMode.MIS, packet_rows=1,
                                              swizzle=False),
                     resolution=(RES, RES), trace_depth=4, device="cpu")
        flat, static, opts, cam, key = r.flat, r.static, r.opts, r._cam_arrays(), r.key
    batch = make_render_iteration(static, opts, RES, RES, regen_k=3)
    assert batch.trace_depth == 4
    base = torch.rand((RES * RES, 3), generator=torch.Generator().manual_seed(0))
    img, rays, depth = batch(flat, cam, base, 2, key, 3)
    contrib, want_rays, laps = render_iteration(flat, static, opts, cam, key, 2, nk=3)
    assert torch.equal(img, base + contrib)
    assert torch.equal(rays, want_rays) and depth == len(laps)


def test_factory_rejects(cornell):
    _, static, opts, _, _ = cornell
    with pytest.raises(ValueError, match="built for a 64x64 film, not 64x32"):
        make_render_iteration(static, opts, RES, 32)
    for bad in (RenderOptions(sample_mode=SampleMode.DIRECT_LI), RenderOptions(show_normal=True)):
        with pytest.raises(ValueError, match="ray regeneration applies"):
            make_render_iteration(static, bad, RES, RES, regen_k=2)


def test_entry_is_the_renderers_first_iteration():
    fn, args = entry.entry(device="cpu")
    flat, cam, img, iteration, key = args
    assert img.shape == (RES * RES, 3) and iteration == 1 and flat.device.type == "cpu"
    img, rays, depth = fn(*args)
    assert img.shape == (RES * RES, 3)
    assert int(rays) > 0 and depth >= 1
    r = Renderer(entry.SCENE, opts=RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(RES, RES), trace_depth=4, device="cpu")
    r.step(1)
    assert r.pixel_order is None  # no triangle, no swizzle: lane order is pixel order
    assert torch.equal(img, r.img)
    assert depth == r.traced_depth


def test_entry_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is checked where it does not")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(ValueError, match="only 0 CUDA devices are visible"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2, devices=["cuda:0", "cuda:0"])


def test_tables_need_cuda_by_default():
    """build_flat_scene builds on the card unless asked for the CPU: without
    CUDA the default raises before the build, as entry() does."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is checked where it does not")
    assert inspect.signature(build_flat_scene).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flat_scene(load_scene(entry.SCENE))
    flat, _ = build_flat_scene(load_scene(entry.SCENE), device="cpu")
    assert flat.device.type == "cpu"


def test_cli_info_device(capsys):
    """`cli info` builds on `--device` (the card by default, an error
    without one) and prints the scene's statistics."""
    assert cli.main(["info", str(entry.SCENE), "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["geoms"] == 11 and info["triangles"] == 0 and info["traversal"] is None
    if not torch.cuda.is_available():
        assert cli.main(["info", str(entry.SCENE)]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_dryrun_fast(capsys):
    entry.dryrun_multichip(2, fast=True, devices=["cpu", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(line.startswith("dryrun_multichip ok: ") for line in lines)
    assert "scene cornell_spheres (tris=0, traversal=none)" in lines[0]
    assert "(cpu, cpu)" in lines[0] and "bitwise the one-device step" in lines[0]
    assert "sample-space sharding" in lines[1] and "bitwise the sequential" in lines[1]


def test_main_cards_takes_the_visible_cards(monkeypatch):
    """`--cards N` runs the dry run over the first N visible cards (the mesh
    make_mesh gives, no device list); `--shards` over shards of --device."""
    calls = []
    monkeypatch.setattr(entry, "dryrun_multichip", lambda n, **kw: calls.append((n, kw)))
    assert entry.main(["--device", "cpu", "--cards", "3"]) == 0
    assert entry.main(["--device", "cpu", "--shards", "2"]) == 0
    assert calls == [(3, {}), (2, {"devices": ["cpu", "cpu"]})]
    with pytest.raises(SystemExit):
        entry.main(["--cards", "2", "--shards", "2"])


def test_main_runs_entry_and_full_dryrun(tmp_path, monkeypatch, capsys):
    """`python -m pathtracer_tpu_torch.entry --device cpu --shards 2`, with
    the mesh pass on a 576-triangle torus box (the plain K1/K2 walks)."""
    monkeypatch.setattr(entry, "MESH_SCENE", small_torus_scene(tmp_path))
    assert entry.main(["--device", "cpu", "--shards", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("entry ok: img (4096, 3) on cpu, rays ")
    assert len(lines) == 4 and all(line.startswith("dryrun_multichip ok: ") for line in lines[1:])
    assert "scene glasstorus_small (tris=576, traversal=plain versions)" in lines[2]
