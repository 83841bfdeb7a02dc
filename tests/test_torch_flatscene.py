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


# SceneStatic fields that only the port has (the streaming walk's depths)
PORT_STATIC = {"stream_top_depth", "stream_sub_depth"}
# FlatScene fields that only the port has, each derived from the stream
# tables: K5's block root boxes, which the JAX package builds inside its
# kernel's call, K3's padded triangle rows and per-block rows, and K5's
# padded root boxes and group boxes
PORT_FLAT = {"str_roots", "str_subt12", "str_blocks", "str_roots8", "str_groups"}


def test_tables_equal(scene_path):
    jflat, jstatic = jax_build(jax_load(scene_path))
    tflat, tstatic = tfs.build_flat_scene(load_scene(scene_path), device="cpu")
    want = _jax_arrays(jflat)
    assert set(want) | PORT_FLAT == {f.name for f in dataclasses.fields(tfs.FlatScene)}
    want["str_roots"] = tfs.stream_roots(want["str_topf"], want["str_topl"], want["str_base"].size)
    want["str_subt12"], want["str_blocks"] = tfs.stream_walk_tables(
        want["str_subi"], want["str_subt"], want["str_base"], tfs.STREAM_SUB_NODES,
        tfs.STREAM_SUB_TRIS)
    want["str_roots8"], want["str_groups"] = tfs.stream_cull_tables(want["str_roots"])
    for name, a in want.items():
        b = getattr(tflat, name).numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, name
        assert np.array_equal(a, b, equal_nan=True), name
    got = dataclasses.asdict(tstatic)
    assert set(got) - set(dataclasses.asdict(jstatic)) == PORT_STATIC
    assert {k: v for k, v in got.items() if k not in PORT_STATIC} == dataclasses.asdict(jstatic)
    assert tstatic.stream_top_depth == tstatic.stream_sub_depth == 0  # resident scenes


def test_flat_from_arrays_round_trip(tmp_path):
    jflat, _ = jax_build(jax_load(_soup(tmp_path)))
    arrays = _jax_arrays(jflat)
    flat = tfs.flat_from_arrays(arrays, "cpu")
    for name, a in arrays.items():
        t = getattr(flat, name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), a, equal_nan=True), name


def test_glasstorus_takes_the_resident_kernels():
    _, static = tfs.build_flat_scene(load_scene(GLASSTORUS), device="cpu")
    assert static.num_tris == 10_000
    assert tfs.resident_tables_fit(static.wide_nodes, static.num_tris)
    assert 7 * static.wide_depth + 1 <= STACK


def test_textured_scene_not_ported(tmp_path):
    write_png(tmp_path / "tex.png", np.full((4, 4, 3), 0.5, np.float32))
    scene = write_scene(tmp_path, f"""
        MATERIAL tex
        TYPE\tLambertian
        ALBEDO      {tmp_path / 'tex.png'}
        METALLIC    0
        ROUGHNESS   0
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
    with pytest.raises(NotImplementedError, match="item 11"):
        tfs.build_flat_scene(load_scene(scene))


def test_env_scene_not_ported(tmp_path):
    write_hdr(tmp_path / "sky.hdr", np.ones((4, 8, 3), np.float32))
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
    with pytest.raises(NotImplementedError, match="item 12"):
        tfs.build_flat_scene(load_scene(scene))


def test_mesh_past_resident_budget_not_ported(tmp_path, monkeypatch):
    """Past the resident budget a mesh takes the streaming tables; only a
    mesh that fits neither them nor the stream split is refused (the JAX
    package's XLA-walk fallback is not ported)."""
    monkeypatch.setattr(tfs, "RESIDENT_SMEM_BUDGET", 0)
    _, static = tfs.build_flat_scene(load_scene(_soup(tmp_path)))
    assert static.stream_subs > 0 and static.stream_top > 0
    monkeypatch.setattr(tfs, "STREAM_SMEM_BUDGET", 0)
    with pytest.raises(NotImplementedError, match="fits neither"):
        tfs.build_flat_scene(load_scene(_soup(tmp_path)))
