"""The port's scene tables must equal the JAX package's tables."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch.scene.flatscene as tfs
from pathtracer_tpu.scene.flatscene import build_flat_scene as jax_build
from pathtracer_tpu.scene.parser import load_scene as jax_load
from pathtracer_tpu_torch.ops.traverse_cuda import STACK
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.image_io import write_hdr, write_png
from tests.test_integrator import write_scene
from tests.test_traverse import tri_soup_scene

GLASSTORUS = Path(__file__).resolve().parent.parent / "scenes" / "glasstorus.txt"


def _soup(tmp_path):
    return tri_soup_scene(tmp_path, n=200, seed=3, vertex_normals=True)


@pytest.fixture(params=["glasstorus", "soup"])
def scene_path(request, tmp_path):
    return GLASSTORUS if request.param == "glasstorus" else _soup(tmp_path)


def _jax_arrays(flat):
    return {k: np.asarray(v) for k, v in flat._asdict().items()}


# SceneStatic fields that only the port has: the streaming walk's depths, and
# the route the built tables serve (the JAX package reads its route from the
# budgets at call time, `packet_mode`, and keeps no such field)
PORT_STATIC = {"stream_top_depth", "stream_sub_depth", "traversal"}
# FlatScene fields that only the port has, each derived from the stream
# tables: K5's block root boxes, which the JAX package builds inside its
# kernel's call, K3's padded triangle rows and per-block rows, and K5's
# padded root boxes and group boxes; and the SceneStatic facts that every
# lap reads on the device (scene_constants)
PORT_FLAT = {"str_roots", "str_subt12", "str_blocks", "str_roots8", "str_groups",
             "scene_lo", "scene_hi", "root_box", "light_geoms"}
# FlatScene fields that only the JAX package has: the float texture planes,
# which feed only its gather_material (the main path samples atlas_u32)
JAX_FLAT = {"atlas"}


def _same_array(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal bit for bit; the port holds the packed atlas (uint32 in the JAX
    package) as int32."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return b.dtype == a.dtype and b.shape == a.shape and np.array_equal(a, b, equal_nan=True)


def _assert_tables_equal(path):
    """Both packages' tables of the scene at `path`, field for field."""
    jflat, jstatic = jax_build(jax_load(path))
    tflat, tstatic = tfs.build_flat_scene(load_scene(path), device="cpu")
    want = _jax_arrays(jflat)
    assert set(want) - JAX_FLAT | PORT_FLAT == {f.name for f in dataclasses.fields(tfs.FlatScene)}
    want["str_roots"] = tfs.stream_roots(want["str_topf"], want["str_topl"], want["str_base"].size)
    want["str_subt12"], want["str_blocks"] = tfs.stream_walk_tables(
        want["str_subi"], want["str_subt"], want["str_base"], tfs.STREAM_SUB_NODES,
        tfs.STREAM_SUB_TRIS)
    want["str_roots8"], want["str_groups"] = tfs.stream_cull_tables(want["str_roots"])
    want.update(tfs.scene_constants(jstatic))
    for name, a in want.items():
        if name not in JAX_FLAT:
            assert _same_array(a, getattr(tflat, name).numpy()), name
    got = dataclasses.asdict(tstatic)
    assert set(got) - set(dataclasses.asdict(jstatic)) == PORT_STATIC
    assert {k: v for k, v in got.items() if k not in PORT_STATIC} == dataclasses.asdict(jstatic)
    return tflat, tstatic


def test_tables_equal(scene_path):
    _, tstatic = _assert_tables_equal(scene_path)
    assert tstatic.stream_top_depth == tstatic.stream_sub_depth == 0  # resident scenes


def test_flat_from_arrays_round_trip(tmp_path):
    jflat, jstatic = jax_build(jax_load(_soup(tmp_path)))
    arrays = _jax_arrays(jflat)
    flat = tfs.flat_from_arrays(arrays, "cpu", jstatic)
    for name, a in arrays.items():
        if name in JAX_FLAT:
            assert not hasattr(flat, name)
            continue
        t = getattr(flat, name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert _same_array(a, t.numpy()), name


def test_glasstorus_takes_the_resident_kernels():
    _, static = tfs.build_flat_scene(load_scene(GLASSTORUS), device="cpu")
    assert static.num_tris == 10_000
    assert tfs.resident_tables_fit(static.wide_nodes, static.num_tris)
    assert 7 * static.wide_depth + 1 <= STACK


def test_textured_scene_not_ported(tmp_path):
    """Textured scenes were refused until textures were ported: now the
    packed atlas (8-bit RGB and RGBE words), the texture table and the
    texture slots equal the JAX package's."""
    write_png(tmp_path / "tex.png", np.linspace(0, 1, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3))
    write_hdr(tmp_path / "rough.hdr", np.linspace(0, 3, 3 * 2 * 3, dtype=np.float32).reshape(3, 2, 3))
    scene = write_scene(tmp_path, f"""
        MATERIAL tex
        TYPE\tLambertian
        ALBEDO      {tmp_path / 'tex.png'}
        METALLIC    0
        ROUGHNESS   {tmp_path / 'rough.hdr'}
        IOR         0

        CAMERA
        RES         8 8
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
        ROTAT       0 0 0
        SCALE       1 1 1
        """)
    tflat, tstatic = _assert_tables_equal(scene)
    assert tstatic.has_textures and tstatic.tex_slots == (True, False, True, False)
    assert [row[3] for row in tstatic.tex_rows] == [0, 1]  # 8-bit RGB, RGBE
    assert tflat.atlas_u32.dtype == torch.int32 and tflat.atlas_u32.numel() == 4 * 5 + 3 * 2


def test_env_scene_not_ported(tmp_path):
    """Environment maps were refused until they were ported: now the sky's
    RGBE texels, its flat CDF and its pdf table equal the JAX package's."""
    sky = np.ones((4, 8, 3), np.float32) * np.arange(1, 5, dtype=np.float32)[:, None, None]
    sky[0] = 0.0  # a row of zero luminance: a plateau of the CDF
    write_hdr(tmp_path / "sky.hdr", sky)
    scene = write_scene(tmp_path, f"""
        MATERIAL white
        TYPE\tLambertian
        ALBEDO      1 1 1
        METALLIC    0
        ROUGHNESS   0
        IOR         0

        ENV {tmp_path / 'sky.hdr'}

        CAMERA
        RES         8 8
        FOVY        45
        ITERATIONS  1
        DEPTH       2
        FILE        env
        EYE         0 0 5
        LOOKAT      0 0 0
        UP          0 1 0

        OBJECT ball
        sphere
        material white
        TRANS       0 0 0
        ROTAT       0 0 0
        SCALE       1 1 1
        """)
    tflat, tstatic = _assert_tables_equal(scene)
    assert tstatic.env_map_id == 0 and tstatic.tex_rows[0][3] == 1
    cdf = tflat.env_flat_cdf.numpy()
    assert cdf.shape == (4 * 8 + 1,) and tflat.env_pdf.shape == (4, 8)
    assert cdf[-1] == 1.0 and (cdf[1:] == cdf[:-1]).sum() >= 8


def test_mesh_past_resident_budget_not_ported(tmp_path, monkeypatch):
    """Past the resident budget a mesh takes the streaming tables; a mesh
    that fits neither them nor the stream split is no longer refused: its
    tables are built without a split and record no kernel route (the JAX
    package's XLA-walk fallback, ported as the MTBVH walk)."""
    monkeypatch.setattr(tfs, "RESIDENT_SMEM_BUDGET", 0)
    _, static = tfs.build_flat_scene(load_scene(_soup(tmp_path)), device="cpu")
    assert static.stream_subs > 0 and static.stream_top > 0
    assert static.traversal == "stream"
    monkeypatch.setattr(tfs, "STREAM_SMEM_BUDGET", 0)
    _, static = tfs.build_flat_scene(load_scene(_soup(tmp_path)), device="cpu")
    assert static.stream_subs == 0 and static.traversal is None
    assert static.stream_top_depth == static.stream_sub_depth == 0
