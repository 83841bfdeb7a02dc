"""The plain reference reads an environment map (an ENV line, Radiance
RGBE) and judges a film of a scene lit by it: the sky along the rays that
escape, and under MIS with the traffic's `env_importance` the sky sampled
as one more light.  The scenes are the repository's `scenes/envtorus.txt`
(the gold torus on a floor under the procedural sky), written here with a
small sky, alone and with a sphere lamp beside the sky; the cells exist
only in the test (`cells.cell` patched), as a configuration and a mix
would hold them."""

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.lib import cells, harness
from benchmark.reference import render, scene
from benchmark.run import result_line
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bench_faults import altered, half_left_out, unchanged

SEED = 2**31 + 61
RES = (24, 24)
SKY = (256, 128)
LIMITS = {"frame_mismatch_pct": 0.5, "film_error_pct": 0.2}
LAMP = """
MATERIAL lamp
TYPE        Light
ALBEDO      6 5 4
METALLIC    0
ROUGHNESS   0
IOR         0

OBJECT lamp
sphere
material lamp
TRANS       -1.5 3 1
ROTAT       0 0 0
SCALE       .6 .6 .6
"""
# name: (scene, mode, env_importance)
CELLS = {"env.mis-envimp": ("env", "mis", True), "env.mis": ("env", "mis", False),
         "env.bsdf": ("env", "bsdf", False), "envlamp.mis-envimp": ("envlamp", "mis", True)}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{"env": path, "envlamp": path}: envtorus.txt with a small sky beside it."""
    from pathtracer_tpu_torch.utils.image_io import write_hdr
    from tools.make_texture_assets import sky

    d = tmp_path_factory.mktemp("env")
    write_hdr(d / "sky.hdr", sky(*SKY))
    text = (ROOT / "scenes" / "envtorus.txt").read_text()
    text = text.replace("assets/generated/sky.hdr", "sky.hdr").replace(
        "assets/torus10k.obj", str(ROOT / "benchmark" / "configs" / "scenes" / "assets" / "torus10k.obj"))
    (d / "env.txt").write_text(text)
    (d / "envlamp.txt").write_text(text + LAMP)
    return {"env": d / "env.txt", "envlamp": d / "envlamp.txt"}


@pytest.fixture
def env_cells(scenes, monkeypatch):
    """The cells of CELLS, each with its scene, mix and LIMITS."""
    cell = cells.cell

    def env_cell(name):
        if name not in CELLS:
            return cell(name)
        sc, mode, env = CELLS[name]
        return {"entry": {"name": name, "config": sc, "traffic": name.split(".")[1], "chips": 1},
                "config": {"name": sc, "scene": str(scenes[sc]), "film": [800, 800], "depth": 8,
                           "devices": 1},
                "traffic": {"mode": mode, "options": {"env_importance": env}, "samples_per_step": 1},
                "own": {"limits": LIMITS}, "end_to_end": [], "per_layer": []}

    monkeypatch.setattr(cells, "cell", env_cell)


def _run(name, hooks=(), device="cpu", res=RES, seconds=0.2):
    m = harness.run(name, SEED, seconds, False, device=device, resolution=res, hooks=hooks)
    m.update(kind=device, power_limit=None)
    return result_line(cells.cell(name), m, False)["correct"], m["checks"]


def _hdr(rgbe: np.ndarray) -> bytes:
    """A Radiance file of `rgbe` (H, W, 4) uint8, flat scanlines."""
    h, w, _ = rgbe.shape
    return f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode() + rgbe.tobytes()


def test_hdr_texels(tmp_path):
    """Each texel is c * 2^(e - 136), 0 where e is 0."""
    gen = np.random.default_rng(3)
    rgbe = gen.integers(0, 256, (5, 40, 4), dtype=np.uint8)
    rgbe[2, :, 3] = 0
    rgbe[3, :, 3] = gen.integers(1, 12, 40)  # scales below float32's normal range
    (tmp_path / "t.hdr").write_bytes(_hdr(rgbe))
    want = rgbe[..., :3].astype(np.float64) * np.where(
        rgbe[..., 3:] == 0, 0.0, np.ldexp(1.0, rgbe[..., 3:].astype(np.int64) - 136))
    got = scene._read_hdr(tmp_path / "t.hdr")
    assert got.dtype == np.float32 and np.array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("head,body,match", [
    (b"-Y 2 +X 8\n", bytes([2, 2, 0, 8, 136, 9] * 8), "run-length"),  # each channel one run
    (b"+Y 2 +X 2\n", bytes(range(16)), "-Y H"),
], ids=["run_length", "orientation"])
def test_hdr_others_raise(tmp_path, head, body, match):
    (tmp_path / "t.hdr").write_bytes(b"#?RADIANCE\n\n" + head + body)
    with pytest.raises(ValueError, match=match):
        scene._read_hdr(tmp_path / "t.hdr")


def test_env_is_read_as_the_program_reads_it(scenes):
    """The map's texels, its rows flipped so that the zenith is the last."""
    from pathtracer_tpu_torch.utils.image_io import load_image

    env = scene.load(scenes["env"]).env
    assert env.shape == (SKY[1], SKY[0], 3)
    assert np.array_equal(env, load_image(scenes["env"].parent / "sky.hdr"))
    assert env[0].max() == 0.0 < env[-1].min()


def test_other_properties_still_raise(tmp_path):
    text = (ROOT / "benchmark" / "configs" / "scenes" / "glasstorus.txt").read_text()
    (tmp_path / "t.txt").write_text(text.replace("ALBEDO", "NORMAL_MAP n.png\nALBEDO", 1))
    with pytest.raises(ValueError, match="not read here"):
        scene.load(tmp_path / "t.txt")


@pytest.mark.parametrize("name", list(CELLS))
def test_env_film_is_correct(env_cells, name):
    ok, checks = _run(name)
    assert ok, checks


def test_env_importance_is_what_judges(env_cells, monkeypatch):
    """A film rendered with the sky as a light, judged by a reference that
    does not sample it, and the other way round, is not correct."""
    build = render.Reference

    def swapped(*args, env_importance=False, **kw):
        return build(*args, env_importance=not env_importance, **kw)

    monkeypatch.setattr(render, "Reference", swapped)
    for name in ("env.mis-envimp", "env.mis"):
        ok, checks = _run(name)
        assert not ok, (name, checks)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=["unchanged", "half_left_out", "altered"])
def test_env_fault(env_cells, fault):
    ok, checks = _run("env.mis-envimp", (fault,))
    assert not ok, checks


def test_env_controls(env_cells):
    """The reference in bfloat16 fails the limits; rounded once, it passes."""
    low = control.control_numbers("env.mis-envimp", SEED, 2, device="cpu", resolution=(32, 16))
    assert any(low[k] > LIMITS[k] for k in LIMITS), low
    rounded = control.rounded_numbers("env.mis-envimp", SEED, 4, device="cpu", resolution=(32, 32))
    assert all(rounded[k] <= LIMITS[k] for k in LIMITS), rounded


@pytest.mark.card
@pytest.mark.parametrize("name", ["env.mis-envimp", "envlamp.mis-envimp"])
def test_env_film_is_correct_on_the_card(env_cells, name):
    """The program's card path (L1 with the sky's draw, the env resolve)
    against the reference on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    ok, checks = _run(name, device="cuda", res=(160, 160), seconds=1.0)
    assert ok, checks

