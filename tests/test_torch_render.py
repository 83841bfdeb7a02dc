"""The slice end to end: the port's Renderer against the JAX package's on the
CPU, plus import hygiene and the no-fallback rule.

The scene is the glass-torus Cornell box with a 24x12-segment torus (576
triangles, enough to keep the JAX package's per-bounce sort on), rendered at
64x64, depth 4, 2 spp, seed 0.  The JAX side runs its XLA walk; the port its
plain traversal.  At least 99.9% of the pixels of the accumulated HDR sum
must agree within rtol=1e-4, atol=1e-5: a last-bit difference can flip a
Fresnel or edge branch and send one path elsewhere, so a few outliers are
allowed and printed.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.render import Renderer as JaxRenderer
from pathtracer_tpu.utils import config as jax_config
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from tools.make_torus_obj import write_torus_obj

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL, MIN_FRAC = 1e-4, 1e-5, 0.999


def small_torus_scene(tmp_path) -> Path:
    """scenes/glasstorus.txt with a 24x12-segment (576-triangle) torus."""
    write_torus_obj(tmp_path / "torus576.obj", 24, 12)
    text = (ROOT / "scenes" / "glasstorus.txt").read_text()
    path = tmp_path / "glasstorus_small.txt"
    path.write_text(text.replace("assets/torus10k.obj", str(tmp_path / "torus576.obj")))
    return path


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return small_torus_scene(tmp_path_factory.mktemp("slice"))


def jax_reference(scene, mode_name: str, **options) -> dict:
    """The JAX Renderer's (XLA walk) render of `scene` at 64x64, depth 4, 2
    spp, seed 0, one iteration per dispatch (bit-identical to batched ones),
    with RenderOptions `options` besides: the accumulated HDR sum in pixel
    order, the LDR image, the rays traced and the iteration count."""
    jax_mode = jax_config.SampleMode[mode_name]
    ref = JaxRenderer(scene, opts=jax_config.RenderOptions(sample_mode=jax_mode,
                                                           iters_per_dispatch=1, **options),
                      resolution=(64, 64), trace_depth=4)
    ref.set_seed(0)
    stats = ref.step(2)
    return {"img": ref._unswizzle(np.asarray(ref.img)).reshape(64, 64, 3),
            "ldr": np.asarray(ref.ldr_image()), "rays": int(stats.rays_traced),
            "iteration": int(ref.iteration)}


def render_and_compare(scene, mode, ref: dict | None = None, **options) -> Renderer:
    """Render `scene` with the port on the CPU (64x64, depth 4, 2 spp, seed
    0, RenderOptions `options` besides) and hold it to `ref`, the JAX
    package's render of it (`jax_reference`, made here when not given);
    returns the port's renderer."""
    if ref is None:
        ref = jax_reference(scene, mode.name, **options)
    port = Renderer(scene, opts=RenderOptions(sample_mode=mode, **options), resolution=(64, 64),
                    trace_depth=4, device="cpu")
    port.set_seed(0)
    stats = port.step(2)

    want = ref["img"]
    got = port.hdr_sum()
    ok = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{mode.name}: {int((~ok).sum())} of {ok.size} pixels outside tolerance, "
          f"{int((got == want).all(-1).sum())} bitwise equal")
    assert ok.mean() >= MIN_FRAC
    assert want.mean() > 0
    assert port.iteration == ref["iteration"] == 2
    if mode == SampleMode.DIRECT_LI:
        assert stats.rays_traced == ref["rays"]
    else:
        assert abs(stats.rays_traced - ref["rays"]) <= 1e-3 * ref["rays"]
    np.testing.assert_allclose(port.ldr_image(), ref["ldr"], atol=1e-3)
    return port


@pytest.mark.parametrize("mode", [SampleMode.BSDF, SampleMode.DIRECT_LI, SampleMode.MIS])
def test_slice_matches_jax(scene, mode):
    port = render_and_compare(scene, mode)
    assert port.static.stream_subs == 0  # the resident kernels' path


def test_save_png_and_hdr(scene, tmp_path):
    r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS),
                 resolution=(16, 16), trace_depth=2, device="cpu")
    r.step(1)
    r.save_png(tmp_path / "a.png")
    r.save_hdr(tmp_path / "a.hdr")
    assert (tmp_path / "a.png").stat().st_size > 0 and (tmp_path / "a.hdr").stat().st_size > 0


PORT_MODULES = [
    "pathtracer_tpu_torch",
    "pathtracer_tpu_torch.accel",
    "pathtracer_tpu_torch.accel.bvh",
    "pathtracer_tpu_torch.accel.native",
    "pathtracer_tpu_torch.cli",
    "pathtracer_tpu_torch.entry",
    "pathtracer_tpu_torch.integrator",
    "pathtracer_tpu_torch.integrator.graphs",
    "pathtracer_tpu_torch.integrator.render",
    "pathtracer_tpu_torch.integrator.wavefront",
    "pathtracer_tpu_torch.ops",
    "pathtracer_tpu_torch.ops._build",
    "pathtracer_tpu_torch.ops.envmap",
    "pathtracer_tpu_torch.ops.intersect",
    "pathtracer_tpu_torch.ops.lights",
    "pathtracer_tpu_torch.ops.materials",
    "pathtracer_tpu_torch.ops.math",
    "pathtracer_tpu_torch.ops.probes",
    "pathtracer_tpu_torch.ops.texture",
    "pathtracer_tpu_torch.ops.traverse",
    "pathtracer_tpu_torch.ops.traverse_cuda",
    "pathtracer_tpu_torch.ops.traverse_stream_cuda",
    "pathtracer_tpu_torch.parallel",
    "pathtracer_tpu_torch.parallel.sharding",
    "pathtracer_tpu_torch.preview",
    "pathtracer_tpu_torch.preview.server",
    "pathtracer_tpu_torch.scene",
    "pathtracer_tpu_torch.scene.camera",
    "pathtracer_tpu_torch.scene.flatscene",
    "pathtracer_tpu_torch.scene.obj_loader",
    "pathtracer_tpu_torch.scene.parser",
    "pathtracer_tpu_torch.utils",
    "pathtracer_tpu_torch.utils.config",
    "pathtracer_tpu_torch.utils.image_io",
    "pathtracer_tpu_torch.utils.profiling",
    "pathtracer_tpu_torch.utils.rng",
    "chip_smoke",
    "tools.blockmajor_reckoning",
    "tools.compare_probes",
    "tools.compare_walk_kernels",
    "tools.cuda_timing",
    "tools.graph_launch_cost",
    "tools.graphs_second_card",
    "tools.kernel_microbench_torch",
    "tools.make_texture_assets",
    "tools.profile_torch_port",
    "tools.rowprim_probe_torch",
    "tools.shard_cards",
    "tools.stage_diff_torch",
    "tools.time_lines",
    "tools.turns",
]


def test_port_imports_without_jax():
    """Every port module, and chip_smoke, imports with both JAX and the JAX
    package blocked; the list covers every module file of the port."""
    pkg = ROOT / "pathtracer_tpu_torch"
    files = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    }
    assert files <= set(PORT_MODULES)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pathtracer_tpu'] = None\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'pathtracer_tpu' or m.startswith(('jax.', 'pathtracer_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_hidden_cpu_fallback(scene, monkeypatch):
    """Without CUDA, asking for it raises; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is checked where it does not")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(scene, device="cuda")
    from pathtracer_tpu_torch.integrator.render import render_scene
    from pathtracer_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_scene(scene, spp=1, resolution=(8, 8))
    with pytest.raises(ValueError, match="only 0 CUDA devices are visible"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2, ["cuda:0", "cuda:0"])
    from pathtracer_tpu_torch import cli

    for cmd in ("render", "bench", "preview"):
        assert cli.main([cmd, str(scene), "--res", "8x8", "--spp", "1"]) == 2
    # a missing nvcc is an error on first use, never a silent plain version
    from pathtracer_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent/_build"))
    monkeypatch.setattr(_build, "_lib", None)
    if _build.find_nvcc() is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library()


@pytest.mark.parametrize("field,value", [
    ("use_bvh", False),
])
def test_unported_options_raise(scene, field, value):
    """The options that raised NotImplementedError until the port had their
    walks no longer raise: `use_bvh=False` renders through the sweep (held
    to the JAX package in tests/test_torch_traverse_modes.py)."""
    from pathtracer_tpu_torch.integrator import render

    assert not hasattr(render, "_check_options")
    r = Renderer(scene, opts=RenderOptions(**{field: value}), resolution=(8, 8), trace_depth=2,
                 device="cpu")
    r.step(1)
    assert np.isfinite(r.hdr_sum()).all()


def test_multi_device_raises(scene):
    """devices=2 on the card needs two CUDA devices, and raises without
    them (the CPU stands in for a mesh only when asked for:
    tests/test_torch_sharding.py)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has two CUDA devices")
    with pytest.raises(ValueError, match="2-device mesh"):
        Renderer(scene, devices=2)
