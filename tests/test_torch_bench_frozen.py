"""The benchmark's frozen copies of the streamed scene match their sources:
`benchmark/configs/scenes/glasstorus160k.txt` is `scenes/glasstorus160k.txt`
byte for byte, and `benchmark/configs/scenes/assets/torus160k.obj` is what
`tools/make_torus_obj.py` writes for the 400 x 200 torus (the harness reads
the scene from under the benchmark's own directory, so the mesh is a
committed file there, not generated at run time)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import make_torus_obj  # noqa: E402

SCENES = ROOT / "benchmark" / "configs" / "scenes"


def test_scene_is_the_repositorys():
    assert (SCENES / "glasstorus160k.txt").read_bytes() == \
        (ROOT / "scenes" / "glasstorus160k.txt").read_bytes()


def test_mesh_is_the_generators(tmp_path):
    out = tmp_path / "torus160k.obj"
    assert make_torus_obj.write_torus_obj(out, 400, 200) == 160_000
    assert (SCENES / "assets" / "torus160k.obj").read_bytes() == out.read_bytes()
