"""Scene text-format parser.

Port of `pathtracer_tpu/scene/parser.py`, kept as the port's own copy so
that the port imports nothing of the JAX package.

Reads the reference's line-oriented scene format
(reference: src/scene.cpp:47-337): top-level directives `MATERIAL <name>`,
`OBJECT <name>`, `CAMERA`, `ENV <hdr>`; material blocks of up to 6
`TYPE/ALBEDO/METALLIC/ROUGHNESS/NORMAL/IOR` lines where ALBEDO / METALLIC /
ROUGHNESS / NORMAL are each either a constant or a texture path
(tried as a texture first, reference: src/scene.cpp:275-306); object blocks
with a type line (`sphere` / `cube` / `*.obj`), a `material <name-or-id>`
line and `TRANS/ROTAT/SCALE` lines; a camera block with 5 fixed lines
(`RES/FOVY/ITERATIONS/DEPTH/FILE`) followed by `EYE`, `LOOKAT` or
`ROTAT theta phi`, and `UP`.

All host-side, pure numpy.
"""

from __future__ import annotations

import math as pymath
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from pathtracer_tpu_torch.scene.obj_loader import load_obj
from pathtracer_tpu_torch.utils.image_io import load_image

# Material type ids (reference: src/material.h:32-38 + map src/scene.cpp:12-18)
LAMBERTIAN = 0
METALLIC_WORKFLOW = 1
DIELECTRIC = 2
MICROFACET = 3
LIGHT = 4

MATERIAL_TYPES = {
    "Lambertian": LAMBERTIAN,
    "MetallicWorkflow": METALLIC_WORKFLOW,
    "Dielectric": DIELECTRIC,
    "Microfacet": MICROFACET,
    "Light": LIGHT,
}

# Geometry types (reference: src/sceneStructs.h GeomType)
SPHERE = 0
CUBE = 1
OBJ = 2

# a material or ENV token with one of these suffixes names an image file
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".hdr")

ROUGHNESS_MIN = 1e-3  # load-time clamp (reference: src/scene.cpp:295)


@dataclass
class MaterialDesc:
    type: int = LAMBERTIAN
    albedo: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    roughness: float = 0.0
    metallic: float = 0.0
    ior: float = 1.5
    albedo_tex: int = -1
    metallic_tex: int = -1
    roughness_tex: int = -1
    normal_tex: int = -1


@dataclass
class GeomDesc:
    type: int
    material_id: int
    translation: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    transform: np.ndarray
    inverse_transform: np.ndarray
    inv_transpose: np.ndarray
    mesh_key: str | None = None  # filename key into the mesh pool for OBJ


@dataclass
class CameraDesc:
    resolution: tuple[int, int] = (800, 800)  # (width, height)
    fovy: float = 45.0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    look_at: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    theta: float = 0.0
    phi: float = 0.0
    pos_init: bool = True  # True if LOOKAT was given, False if ROTAT


@dataclass
class SceneData:
    path: Path
    materials: list[MaterialDesc]
    geoms: list[GeomDesc]
    camera: CameraDesc
    iterations: int
    trace_depth: int
    image_name: str
    textures: list[np.ndarray]          # float32 (H, W, 3), vertically flipped
    texture_names: list[str]
    meshes: dict[str, dict]             # mesh pool: filename → raw arrays
    env_map_id: int = -1
    material_names: dict[str, int] = field(default_factory=dict)
    geom_names: dict[str, int] = field(default_factory=dict)


def build_transformation_matrix(translation, rotation, scale) -> np.ndarray:
    """T @ Rx @ Ry @ Rz @ S (reference: src/utilities.cpp:65-72)."""

    def rot(axis, deg):
        r = pymath.radians(deg)
        c, s = pymath.cos(r), pymath.sin(r)
        if axis == 0:
            m = np.array(
                [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64
            )
        elif axis == 1:
            m = np.array(
                [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float64
            )
        else:
            m = np.array(
                [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64
            )
        return m

    t = np.eye(4, dtype=np.float64)
    t[:3, 3] = np.asarray(translation, np.float64)
    s = np.diag([*np.asarray(scale, np.float64), 1.0])
    m = t @ rot(0, rotation[0]) @ rot(1, rotation[1]) @ rot(2, rotation[2]) @ s
    return m.astype(np.float32)


def _tokenize(line: str) -> list[str]:
    return line.split()


def _resolve_asset(token: str, scene_dir: Path) -> Path | None:
    """Find an asset referenced by a scene file.

    The reference resolves relative to its build CWD; scene files use
    Windows-style paths like `..\\scenes\\texture\\x.png`.  We normalise
    separators and probe a few sensible roots.
    """
    norm = token.replace("\\", "/")
    candidates = [Path(norm)]
    p = Path(norm)
    candidates.append(scene_dir / norm)
    candidates.append(scene_dir.parent / norm)
    # build-dir emulation: `../scenes/...` relative to a sibling of scenes/
    if norm.startswith("../"):
        candidates.append(scene_dir.parent / norm[3:])
    if not p.is_absolute():
        # bare filename relative to scene dir subfolders
        candidates.append(scene_dir / "model" / p.name)
    for c in candidates:
        try:
            if c.is_file():
                return c
        except OSError:
            continue
    return None


class SceneParser:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.scene_dir = self.path.parent
        self.materials: list[MaterialDesc] = []
        self.material_names: dict[str, int] = {}
        self.geoms: list[GeomDesc] = []
        self.geom_names: dict[str, int] = {}
        self.textures: list[np.ndarray] = []
        self.texture_names: list[str] = []
        self._texture_ids: dict[str, int] = {}
        self.meshes: dict[str, dict] = {}
        self.camera = CameraDesc()
        self.iterations = 0
        self.trace_depth = 8
        self.image_name = "render"
        self.env_map_id = -1

    # -- texture pool (reference: src/scene.cpp:318-337, 465-477) ----------
    def load_texture(self, token: str, gamma: float = 1.0) -> int:
        path = _resolve_asset(token, self.scene_dir)
        if path is None:
            # a token that is no file is a constant (ALBEDO .85 .85 .85); the
            # JAX package reads a missing image's name as one too, 0, where
            # the port refuses, naming the file, so that a missing
            # (generated) texture never yields a black material
            if Path(token.replace("\\", "/")).suffix.lower() in IMAGE_SUFFIXES:
                raise FileNotFoundError(
                    f"texture {token!r} not found (scene {self.path}; looked next to "
                    "the scene and in its parent; tools/make_texture_assets.py writes "
                    "the in-repo scenes' generated textures)"
                )
            return -1
        key = str(path)
        if key in self._texture_ids:
            return self._texture_ids[key]
        try:
            img = load_image(path, gamma=gamma, flip_vertical=True)
        except Exception:
            return -1
        tex_id = len(self.textures)
        self.textures.append(img)
        self.texture_names.append(key)
        self._texture_ids[key] = tex_id
        return tex_id

    # -- blocks -------------------------------------------------------------
    def _load_material(self, name: str, lines: "_LineReader") -> None:
        if name in self.material_names:
            return
        mat = MaterialDesc()
        for _ in range(6):  # exactly 6 lines (reference: src/scene.cpp:259)
            line = lines.next()
            if line is None:
                break
            tokens = _tokenize(line)
            if not tokens:
                break
            key = tokens[0]
            if key == "TYPE":
                mat.type = MATERIAL_TYPES.get(tokens[1], mat.type)
            elif key == "ALBEDO":
                mat.albedo_tex = self.load_texture(tokens[1])
                if mat.albedo_tex < 0:
                    vals = [_atof(t) for t in tokens[1:4]]
                    vals += [0.0] * (3 - len(vals))
                    mat.albedo = np.array(vals, np.float32)
            elif key == "METALLIC":
                mat.metallic_tex = self.load_texture(tokens[1])
                if mat.metallic_tex < 0:
                    mat.metallic = _atof(tokens[1])
            elif key == "ROUGHNESS":
                mat.roughness_tex = self.load_texture(tokens[1])
                if mat.roughness_tex < 0:
                    mat.roughness = max(_atof(tokens[1]), ROUGHNESS_MIN)
            elif key == "NORMAL":
                mat.normal_tex = self.load_texture(tokens[1])
            elif key == "IOR" or key == "RIOR":  # mis_test.txt has a RIOR typo
                if key == "IOR":
                    mat.ior = _atof(tokens[1])
        self.material_names[name] = len(self.materials)
        self.materials.append(mat)

    def _load_geom(self, name: str, lines: "_LineReader") -> None:
        if name in self.geom_names:
            return
        type_line = lines.next() or ""
        mesh_key = None
        if type_line.strip() == "sphere":
            gtype = SPHERE
        elif type_line.strip() == "cube":
            gtype = CUBE
        elif ".obj" in type_line:
            gtype = OBJ
            token = type_line.strip()
            path = _resolve_asset(token, self.scene_dir)
            if path is None:
                # missing asset: the JAX package warns and renders the scene
                # without the mesh; the port refuses, naming the file, so a
                # missing (generated) OBJ never yields an empty-box image
                raise FileNotFoundError(
                    f"OBJ file {token!r} of object {name!r} not found (scene "
                    f"{self.path}; looked next to the scene and in its parent)"
                )
            mesh_key = str(path)
            if mesh_key not in self.meshes:
                self.meshes[mesh_key] = load_obj(path)
        else:
            raise ValueError(f"unknown object type: {type_line!r}")

        mat_line = lines.next() or ""
        tokens = _tokenize(mat_line)
        mat_token = tokens[1] if len(tokens) > 1 else "0"
        if mat_token in self.material_names:
            material_id = self.material_names[mat_token]
        else:
            material_id = _atoi(mat_token)  # atoi fallback (scene.cpp:121-133)

        translation = np.zeros(3, np.float32)
        rotation = np.zeros(3, np.float32)
        scale = np.ones(3, np.float32)
        while True:
            line = lines.next()
            if line is None or not line.strip():
                break
            tokens = _tokenize(line)
            vals = np.array([_atof(t) for t in tokens[1:4]], np.float32)
            if tokens[0] == "TRANS":
                translation = vals
            elif tokens[0] == "ROTAT":
                rotation = vals
            elif tokens[0] == "SCALE":
                scale = vals

        transform = build_transformation_matrix(translation, rotation, scale)
        self.geom_names[name] = len(self.geoms)
        self.geoms.append(
            GeomDesc(
                type=gtype,
                material_id=material_id,
                translation=translation,
                rotation=rotation,
                scale=scale,
                transform=transform,
                inverse_transform=np.linalg.inv(transform.astype(np.float64)).astype(
                    np.float32
                ),
                inv_transpose=np.linalg.inv(transform.astype(np.float64)).T.astype(
                    np.float32
                ),
                mesh_key=mesh_key,
            )
        )

    def _load_camera(self, lines: "_LineReader") -> None:
        cam = self.camera
        for _ in range(5):  # fixed 5 lines (reference: src/scene.cpp:172)
            tokens = _tokenize(lines.next() or "")
            if not tokens:
                continue
            if tokens[0] == "RES":
                cam.resolution = (_atoi(tokens[1]), _atoi(tokens[2]))
            elif tokens[0] == "FOVY":
                cam.fovy = _atof(tokens[1])
            elif tokens[0] == "ITERATIONS":
                self.iterations = _atoi(tokens[1])
            elif tokens[0] == "DEPTH":
                self.trace_depth = _atoi(tokens[1])
            elif tokens[0] == "FILE":
                self.image_name = tokens[1]
        while True:
            line = lines.next()
            if line is None or not line.strip():
                break
            tokens = _tokenize(line)
            if tokens[0] == "EYE":
                cam.position = np.array([_atof(t) for t in tokens[1:4]], np.float32)
            if tokens[0] == "ROTAT":  # note: `if`, not elif (scene.cpp:201)
                cam.theta = float(np.clip(_atof(tokens[1]), -89.0, 89.0))
                cam.phi = _atof(tokens[2])
                cam.pos_init = False
            elif tokens[0] == "LOOKAT":
                cam.look_at = np.array([_atof(t) for t in tokens[1:4]], np.float32)
                cam.pos_init = True
            elif tokens[0] == "UP":
                cam.up = np.array([_atof(t) for t in tokens[1:4]], np.float32)

    def parse(self) -> SceneData:
        text = self.path.read_text()
        lines = _LineReader(text.splitlines())
        while True:
            line = lines.next()
            if line is None:
                break
            tokens = _tokenize(line)
            if not tokens:
                continue
            if tokens[0] == "MATERIAL":
                self._load_material(tokens[1], lines)
            elif tokens[0] == "OBJECT":
                self._load_geom(tokens[1], lines)
            elif tokens[0] == "CAMERA":
                self._load_camera(lines)
            elif tokens[0] == "ENV":
                self.env_map_id = self.load_texture(tokens[1])
        return SceneData(
            path=self.path,
            materials=self.materials,
            geoms=self.geoms,
            camera=self.camera,
            iterations=self.iterations,
            trace_depth=self.trace_depth,
            image_name=self.image_name,
            textures=self.textures,
            texture_names=self.texture_names,
            meshes=self.meshes,
            env_map_id=self.env_map_id,
            material_names=self.material_names,
            geom_names=self.geom_names,
        )


class _LineReader:
    def __init__(self, lines: list[str]):
        self.lines = [ln.rstrip("\r") for ln in lines]
        self.pos = 0

    def next(self) -> str | None:
        if self.pos >= len(self.lines):
            return None
        line = self.lines[self.pos]
        self.pos += 1
        return line


def _atof(s: str) -> float:
    """C atof: parse a leading float, 0.0 on failure."""
    try:
        return float(s)
    except ValueError:
        import re

        m = re.match(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s.strip())
        return float(m.group(0)) if m else 0.0


def _atoi(s: str) -> int:
    try:
        return int(s)
    except ValueError:
        import re

        m = re.match(r"^[+-]?\d+", s.strip())
        return int(m.group(0)) if m else 0


def load_scene(path: str | Path) -> SceneData:
    return SceneParser(path).parse()
