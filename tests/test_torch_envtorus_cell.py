"""The benchmark's sky-lit cell, `envtorus.mis-envimp`, on the CPU: the gold
torus on a glossy floor under the 2048 x 1024 procedural sky, no lamp, MIS
with the sky sampled as a light (`env_importance`).

- The port through the cell's harness (`benchmark/lib/harness.run`) at
  16x16 and 32x16: the Renderer of the cell's configuration renders its
  warm-up iteration and one more, and `benchmark/lib/check.compare` judges
  the film against the plain reference (`benchmark/reference`), each
  compared number at or under the cell's own limits
  (`benchmark/workloads/envtorus.mis-envimp.json`).  Both sides draw every
  path's random numbers from the same counter stream, so a sound port
  agrees path for path up to rounding; at these films it reads 0 on both.
- The same films judged by a reference with `env_importance` swapped are
  not correct: what is compared is the sky sampled as a light.
- The frozen copies under `benchmark/configs/scenes/`: the scene is
  `scenes/envtorus.txt` byte for byte, and the sky is what
  `tools/make_texture_assets.py` writes (the harness reads the scene from
  under the benchmark's own directory, so the sky is a committed file
  there, not generated at run time).
"""

import json
import sys

import pytest
import torch

from benchmark.lib import harness
from benchmark.reference import render
from tests.test_torch_render import ROOT

sys.path.insert(0, str(ROOT / "tools"))
import make_texture_assets  # noqa: E402

CELL = "envtorus.mis-envimp"
SEED = 2**31 + 91
LIMITS = json.loads((ROOT / "benchmark" / "workloads" / f"{CELL}.json").read_text())["limits"]
SCENES = ROOT / "benchmark" / "configs" / "scenes"
FILMS = [(16, 16), (32, 16)]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def checks(film) -> dict:
    m = harness.run(CELL, SEED, 0.0, False, device="cpu", resolution=film)
    assert m["window_samples"] >= 1 and m["lap_pools"]  # the warm-up iteration and one more
    return m["checks"]


@pytest.mark.parametrize("film", FILMS, ids=lambda f: f"{f[0]}x{f[1]}")
def test_envtorus_matches_reference(film):
    got = checks(film)
    for name, limit in LIMITS.items():
        assert got[name] <= limit, (name, got)


@pytest.mark.parametrize("film", FILMS, ids=lambda f: f"{f[0]}x{f[1]}")
def test_envtorus_swapped_reference_is_not_correct(film, monkeypatch):
    """A reference that samples the sky where the film did not, or the
    other way round, judges the film not correct."""
    build = render.Reference

    def swapped(*args, env_importance=False, **kw):
        return build(*args, env_importance=not env_importance, **kw)

    monkeypatch.setattr(render, "Reference", swapped)
    got = checks(film)
    assert any(got[name] > limit for name, limit in LIMITS.items()), got


def test_frozen_scene_is_the_repositorys():
    assert (SCENES / "envtorus.txt").read_bytes() == (ROOT / "scenes" / "envtorus.txt").read_bytes()


def test_frozen_sky_is_the_generators(tmp_path):
    out = tmp_path / "sky.hdr"
    make_texture_assets.write_hdr(out, make_texture_assets.sky())
    assert (SCENES / "assets" / "generated" / "sky.hdr").read_bytes() == out.read_bytes()
