"""The port's own copies of the JAX package's numpy-only host modules (config,
image I/O, OBJ loader, scene parser, camera, BVH build and its native
builder, the texture atlas and environment CDF builds, the preview's page
and PNG writer) against the originals, on the CPU: identical inputs must give equal results, arrays
element for element and files byte for byte.  Also the asset tools, and the
host side of the tools that time the card (turns and timed log lines)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from pathtracer_tpu.accel import bvh as jbvh
from pathtracer_tpu.scene import camera as jcam
from pathtracer_tpu.scene import flatscene as jflat
from pathtracer_tpu.scene import obj_loader as jobj
from pathtracer_tpu.scene import parser as jparser
from pathtracer_tpu.utils import config as jconfig
from pathtracer_tpu.utils import image_io as jio
from pathtracer_tpu_torch.accel import bvh as tbvh
from pathtracer_tpu_torch.accel import native as tnative
from pathtracer_tpu_torch.scene import camera as tcam
from pathtracer_tpu_torch.scene import flatscene as tflat
from pathtracer_tpu_torch.scene import obj_loader as tobj
from pathtracer_tpu_torch.scene import parser as tparser
from pathtracer_tpu_torch.utils import config as tconfig
from pathtracer_tpu_torch.utils import image_io as tio
from tests.test_integrator import write_scene
from tests.test_torch_render import small_torus_scene
from tests.test_traverse import tri_soup_scene
from tools import make_texture_assets as mta
from tools import time_lines, turns
from tools.make_torus_obj import ensure_torus_obj

ROOT = Path(__file__).resolve().parent.parent


def assert_same(a, b, where="value"):
    """Deep equality across the two packages: dataclasses field by field,
    containers item by item, arrays with np.array_equal (dtype included)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], where
        for n in names:
            assert_same(getattr(a, n), getattr(b, n), f"{where}.{n}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def textured_scene(tmp_path) -> Path:
    jio.write_png(tmp_path / "tex.png", np.linspace(0, 1, 48, dtype=np.float32).reshape(4, 4, 3))
    return write_scene(tmp_path, f"""
        MATERIAL tex
        TYPE\tLambertian
        ALBEDO      {tmp_path / 'tex.png'}
        METALLIC    0
        ROUGHNESS   0
        IOR         0

        CAMERA
        RES         8 6
        FOVY        45
        ITERATIONS  1
        DEPTH       2
        FILE        tex
        EYE         0 0 5
        LOOKAT      0 0 0
        UP          0 1 0

        OBJECT ball
        sphere
        material tex
        TRANS       0 0 0
        ROTAT       0 30 0
        SCALE       1 2 1
        """)


@pytest.fixture(params=["glasstorus", "torus576", "textured"])
def scene_path(request, tmp_path):
    if request.param == "glasstorus":
        return ROOT / "scenes" / "glasstorus.txt"
    if request.param == "torus576":
        return small_torus_scene(tmp_path)
    return textured_scene(tmp_path)


def test_parsers_agree(scene_path):
    assert_same(tparser.load_scene(scene_path), jparser.load_scene(scene_path), "scene")


def test_obj_loader_agrees(tmp_path):
    scene = small_torus_scene(tmp_path)
    obj = next(scene.parent.glob("*.obj"))
    assert_same(tobj.load_obj(obj), jobj.load_obj(obj), "mesh")


def test_camera_agrees(scene_path):
    desc = jparser.load_scene(scene_path).camera
    got = tcam.derive_camera(tparser.load_scene(scene_path).camera)
    want = jcam.derive_camera(desc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for a, b in zip(got.as_arrays(), want.as_arrays()):
        assert_same(a, b, "camera array")
    orbit = dict(theta=20.0, phi=-75.0, position=(1.0, 2.0, 3.0))
    assert dataclasses.asdict(tcam.derive_camera(desc, **orbit)) == dataclasses.asdict(
        jcam.derive_camera(desc, **orbit))


def _soup_tris(tmp_path, n=300, seed=5):
    scene = jparser.load_scene(tri_soup_scene(tmp_path, n=n, seed=seed))
    return next(iter(scene.meshes.values()))["positions"].astype(np.float32)


@pytest.mark.parametrize("use_sah,mtbvh", [(True, True), (True, False), (False, True)])
def test_bvh_and_wide_agree(tmp_path, use_sah, mtbvh):
    tris = _soup_tris(tmp_path)
    got = tbvh.build_bvh(tris, use_sah=use_sah, mtbvh=mtbvh)
    want = jbvh.build_bvh(tris, use_sah=use_sah, mtbvh=mtbvh)
    assert_same(got, want, "bvh")
    assert_same(tbvh.collapse_wide(got, 8), jbvh.collapse_wide(want, 8), "wide")


def test_native_builder_builds_outside_the_source_tree(tmp_path):
    pkg = ROOT / "pathtracer_tpu_torch"
    assert tnative._LIB.parent == pkg / "_build"
    tris = _soup_tris(tmp_path, n=120, seed=2)
    native = tbvh.build_bvh(tris, use_native=True)
    assert_same(native, jbvh.build_bvh(tris, use_native=True), "bvh")
    if tnative.available():
        assert tnative._LIB.exists()
    assert not list((pkg / "accel" / "native").glob("*.so"))


@pytest.mark.parametrize("sub_nodes,sub_tris", [(8, 48), (16, 64), (512, 4096)])
def test_partition_stream_agrees(tmp_path, sub_nodes, sub_tris):
    tris = _soup_tris(tmp_path)
    w = tbvh.collapse_wide(tbvh.build_bvh(tris), 8)
    got = tbvh.partition_stream(w, sub_nodes, sub_tris)
    want = jbvh.partition_stream(jbvh.collapse_wide(jbvh.build_bvh(tris), 8), sub_nodes, sub_tris)
    assert_same(got, want, "stream")
    assert tbvh.validate_stream_bvh(got, w, tris.shape[0]) == []
    assert tbvh.validate_wide_bvh(w, tris.shape[0]) == []


def test_image_io_writes_equal_bytes(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 4, size=(7, 9, 3)).astype(np.float32)
    for fmt, (tw, jw, read) in {
        "png": (tio.write_png, jio.write_png, tio.read_png),
        "hdr": (tio.write_hdr, jio.write_hdr, tio.read_hdr),
    }.items():
        tw(tmp_path / f"t.{fmt}", img)
        jw(tmp_path / f"j.{fmt}", img)
        assert (tmp_path / f"t.{fmt}").read_bytes() == (tmp_path / f"j.{fmt}").read_bytes(), fmt
        assert read(tmp_path / f"t.{fmt}").shape[:2] == (7, 9)
    assert_same(tio.load_image(tmp_path / "t.png"), jio.load_image(tmp_path / "j.png"), "png")
    assert_same(tio.load_image(tmp_path / "t.hdr"), jio.load_image(tmp_path / "j.hdr"), "hdr")


def test_preview_page_and_png_writer_agree():
    """The preview server's page and in-memory PNG writer, copied: the same
    page, and the same bytes for the same image (values past [0, 1] too)."""
    import io

    from pathtracer_tpu.preview import server as jserver
    from pathtracer_tpu_torch.preview import server as tserver

    assert tserver._PAGE == jserver._PAGE
    img = np.random.default_rng(1).uniform(-0.2, 1.3, size=(13, 17, 3)).astype(np.float32)
    ours, theirs = io.BytesIO(), io.BytesIO()
    tserver._write_png_bytes(ours, img)
    jserver._write_png_bytes(theirs, img)
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().startswith(b"\x89PNG")


def test_render_options_defaults_equal():
    got, want = tconfig.RenderOptions(), jconfig.RenderOptions()
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for n in names:
        a, b = getattr(got, n), getattr(want, n)
        if isinstance(b, jconfig.SampleMode):
            assert isinstance(a, tconfig.SampleMode) and (a.name, a.value) == (b.name, b.value)
        else:
            assert a == b, n
    assert [(m.name, m.value) for m in tconfig.SampleMode] == [
        (m.name, m.value) for m in jconfig.SampleMode]
    assert (tconfig.PI, tconfig.TWO_PI, tconfig.INV_PI) == (jconfig.PI, jconfig.TWO_PI, jconfig.INV_PI)


def test_missing_obj_error_names_the_file(tmp_path):
    text = (ROOT / "scenes" / "glasstorus.txt").read_text()
    scene = tmp_path / "s.txt"
    scene.write_text(text.replace("assets/torus10k.obj", "assets/nowhere.obj"))
    with pytest.raises(FileNotFoundError, match="nowhere.obj"):
        tparser.load_scene(scene)


def test_ensure_torus_obj(tmp_path):
    path = tmp_path / "assets" / "t.obj"
    assert ensure_torus_obj(path, 8, 4) == path
    first = path.read_bytes()
    assert first.count(b"\nf ") == 64
    path.write_bytes(first + b"# kept\n")
    ensure_torus_obj(path, 8, 4)  # an existing file is left alone
    assert path.read_bytes().endswith(b"# kept\n")
    assert not list(path.parent.glob("*.tmp"))
    big = (ROOT / "scenes" / "glasstorus160k.txt").read_text()
    assert "assets/torus160k.obj" in big and "--major 400 --minor 200" in big


@pytest.mark.parametrize("name", ["texcube", "normalcube", "envtorus"])
def test_texture_atlas_and_env_cdfs_agree(name):
    """`_pack_textures` (LDR 8-bit and RGBE words, the texture table) and
    `_env_cdfs` (the flat CDF over 2M sky texels, plateaus included) on the
    new scenes, each package on its own parse."""
    mta.ensure_texture_assets()
    path = ROOT / "scenes" / f"{name}.txt"
    got_scene, want_scene = tparser.load_scene(path), jparser.load_scene(path)
    assert_same(tflat._pack_textures(got_scene), jflat._pack_textures(want_scene), "textures")
    assert_same(tflat._env_cdfs(got_scene), jflat._env_cdfs(want_scene), "env cdfs")
    assert got_scene.textures and (name != "envtorus" or got_scene.env_map_id >= 0)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P"])
def test_png_decoder_agrees_with_pil(tmp_path, mode):
    """The port decodes 8-bit PNGs itself: every colour type, every filter
    (PIL's `optimize` picks all five), equal to the JAX package's PIL read."""
    from PIL import Image

    g = np.random.default_rng(3)
    img = (np.linspace(0, 255, 61 * 97 * 4).reshape(61, 97, 4)
           + g.integers(0, 40, (61, 97, 4))).clip(0, 255).astype(np.uint8)
    im = Image.fromarray(img, "RGBA") if mode == "RGBA" else Image.fromarray(img[..., :3]).convert(mode)
    for optimize in (False, True):
        path = tmp_path / f"{mode}{optimize}.png"
        im.save(path, optimize=optimize)
        assert tio._decode_png(path.read_bytes()) is not None
        assert_same(tio.load_image(path), jio.load_image(path), f"{mode} png")


def test_texture_assets_are_deterministic(tmp_path):
    """Each ensure_* writes the same bytes on a second, fresh write, and
    leaves an existing file alone; the PNGs and the HDR read back equal
    through both packages' image_io; the committed UV cube is the tool's."""
    assert mta.UV_CUBE.read_text() == mta.uv_cube_obj()
    for ensure in (mta.ensure_uv_cube_obj, mta.ensure_albedo_png, mta.ensure_metallic_png,
                   mta.ensure_roughness_png, mta.ensure_sky_hdr):
        a, b = tmp_path / "a" / ensure.__name__, tmp_path / "b" / ensure.__name__
        assert ensure(a) == a and ensure(b) == b
        assert a.read_bytes() == b.read_bytes(), ensure.__name__
        a.write_bytes(a.read_bytes() + b"#")
        ensure(a)
        assert a.read_bytes().endswith(b"#")
        if ensure is not mta.ensure_uv_cube_obj:
            suffix = ".hdr" if ensure is mta.ensure_sky_hdr else ".png"
            c = b.rename(b.with_suffix(suffix))
            assert_same(tio.load_image(c), jio.load_image(c), ensure.__name__)
    assert not list(tmp_path.rglob("*.tmp"))
    sky = mta.sky(256, 128)
    assert sky.max() > 1.0 and not sky[64:].any() and sky[:64].min() > 0.0


def test_missing_texture_error_names_the_file(tmp_path):
    text = (ROOT / "scenes" / "normalcube.txt").read_text()
    scene = tmp_path / "s.txt"
    scene.write_text(text.replace("assets/wave_normal.png", "assets/nowhere.png")
                     .replace("assets/uvcube.obj", str(ROOT / "scenes" / "assets" / "uvcube.obj")))
    with pytest.raises(FileNotFoundError, match="nowhere.png"):
        tparser.load_scene(scene)
    assert jparser.load_scene(scene).materials[2].normal_tex == -1  # the JAX package reads on


def test_time_lines_stamps_each_line_and_keeps_the_code(capsys):
    code = "import sys; print('a'); print('b', file=sys.stderr); sys.exit(3)"
    assert time_lines.main(["--", sys.executable, "-c", code]) == 3
    lines = capsys.readouterr().out.splitlines()
    assert [l.split(None, 1)[1] for l in lines] == ["a", "b"]
    assert all(float(l.split(None, 1)[0]) >= 0.0 for l in lines)


def test_turn_builds_with_the_trees_defines(tmp_path):
    """A turn runs its worker in the tree, after the tree's _build has taken
    the turn's defines and its own build directory."""
    ops = tmp_path / "pathtracer_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops.parent / "__init__.py").write_text("")
    (ops / "__init__.py").write_text("")
    (ops / "_build.py").write_text("from pathlib import Path\nNVCC_FLAGS = ('-O3',)\n"
                                   "BUILD_DIR = Path('b')\nbuilt = []\n"
                                   "def load_library():\n    built.append(BUILD_DIR)\n")
    worker = ("import json, sys\nprint('RESULT ' + json.dumps([list(_build.NVCC_FLAGS), "
              "str(_build.built[0]), sys.argv[1:]]))")
    assert turns.run_turn(f"{tmp_path}:A=1,B=2", worker, "x") == [
        ["-O3", "-DA=1", "-DB=2"], "b/variant_A-1_B-2", ["x"]]
    assert turns.run_turn(str(tmp_path), worker) == [["-O3"], "b", []]
    with pytest.raises(SystemExit, match="failed"):
        turns.run_turn(str(tmp_path), "raise ValueError")
