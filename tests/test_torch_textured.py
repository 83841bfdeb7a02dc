"""The textured and environment-lit main path: scenes/texcube.txt (an albedo
map, and metallic and roughness maps), scenes/normalcube.txt (a normal map)
and scenes/envtorus.txt (an HDR sky around the 10,000-triangle torus),
through the port's Renderer against the JAX package's on the CPU.

64x64, depth 4, 2 spp, seed 0, in all three modes, plus envtorus in MIS
with env importance sampling and the show_normal view of normalcube, held
as the torus slice is (tests/test_torch_render.py render_and_compare): at
least 99.9% of the pixels within rtol 1e-4, atol 1e-5, DIRECT_LI ray counts
exact, LDR within 1e-3; the outlier count of each case is printed.

The JAX package renders in a process of its own with XLA rounding each
operation once, as tests/test_torch_cornell.py does: jitted, XLA contracts
the cross products of the normal-map frame into multiply-adds, and on
normalcube the shading normal's last-bit drift flips a few NEE terms (4
pixels past the LDR tolerance in DIRECT_LI, and past the pixel share in
MIS).  Every traversal of these scenes is resident: their meshes are small.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.config import SampleMode
from tests.test_torch_cornell import XLA_ONE_ROUNDING
from tests.test_torch_render import render_and_compare
from tools.make_texture_assets import ensure_texture_assets

ROOT = Path(__file__).resolve().parent.parent
SCENES = ("texcube", "normalcube", "envtorus")
CASES = [(s, m, {}) for s in SCENES for m in ("BSDF", "DIRECT_LI", "MIS")] + [
    ("envtorus", "MIS", {"env_importance": True}),
    ("normalcube", "MIS", {"show_normal": True}),
]


def _case_id(case) -> str:
    scene, mode, options = case
    return "-".join([scene, mode, *options])


_REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from tests.test_torch_render import jax_reference
out = {}
for name, scene, mode, options in json.loads(sys.argv[3]):
    for key, value in jax_reference(scene, mode, **options).items():
        out[f"{name}/{key}"] = value
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's renders of every case, made in one process with
    XLA_ONE_ROUNDING."""
    ensure_texture_assets()
    out = tmp_path_factory.mktemp("textured_ref") / "ref.npz"
    cases = [[_case_id(c), str(ROOT / "scenes" / f"{c[0]}.txt"), c[1], c[2]] for c in CASES]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {XLA_ONE_ROUNDING}".strip()}
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(ROOT), str(out), json.dumps(cases)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as f:
        return {name: {key: f[f"{name}/{key}"] for key in ("img", "ldr", "rays", "iteration")}
                for name, *_ in cases}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_textured_scene_matches_jax(case, references):
    scene, mode, options = case
    port = render_and_compare(ROOT / "scenes" / f"{scene}.txt", SampleMode[mode],
                              ref=references[_case_id(case)], **options)
    static = port.static
    assert static.stream_subs == 0 and static.num_tris > 0  # the resident kernels' path
    assert static.has_textures
    if scene == "texcube":
        assert static.tex_slots == (True, True, True, False)
    if scene == "normalcube":
        assert static.tex_slots == (False, False, False, True)
    if scene == "envtorus":
        assert static.env_map_id >= 0 and static.num_lights == 0


@pytest.mark.parametrize("scene", SCENES)
def test_scene_names_only_repo_files(scene):
    """Every file a new scene names is a relative path inside the repository,
    committed or written by tools/make_texture_assets.py."""
    ensure_texture_assets()
    path = ROOT / "scenes" / f"{scene}.txt"
    text = path.read_text()
    named = re.findall(r"^\s*(?:ALBEDO|METALLIC|ROUGHNESS|NORMAL|ENV)\s+(\S+\.[a-z]+)\s*$|^(\S+\.obj)\s*$",
                       text, flags=re.M)
    files = [a or b for a, b in named]
    assert files
    for name in files:
        assert not Path(name).is_absolute(), name
        resolved = (path.parent / name).resolve()
        assert resolved.is_file() and ROOT in resolved.parents, name
    parsed = load_scene(path)
    assert parsed.textures and len(parsed.textures) == len(
        {f for f in files if not f.endswith(".obj")})
