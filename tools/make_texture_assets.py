"""Write the procedural assets of the textured and environment-lit scenes.

numpy only (through `pathtracer_tpu_torch/utils/image_io.py`'s writers) and
deterministic: the same call always writes the same bytes.

- `scenes/assets/uvcube.obj`, committed: a unit cube with texture
  coordinates, 24 vertices and 12 triangles, each face mapped to the whole
  [0, 1]^2 (the scenes' textured and normal-mapped cubes);
- into `scenes/assets/generated/` (gitignored; `ensure_texture_assets`
  writes what is missing at first use, or by hand
  `python tools/make_texture_assets.py`):
  - `albedo_checker.png`, 1024 x 1024 RGB: an 8 x 8 checker over a colour
    gradient (red grows with x, green with y, a blue marker square in one
    corner), so a wrong tap, flip or channel order shows;
  - `metallic.png` and `roughness.png`, 512 x 512, grey (the samplers read
    channel 0): metallic in stripes, roughness a radial ramp;
  - `sky.hdr`, 2048 x 1024 equirect Radiance RGBE: a sky gradient over the
    upper half with a bright sun disc, and rows of zero luminance below the
    horizon, so the environment CDF has plateaus.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pathtracer_tpu_torch.utils.image_io import write_hdr, write_png  # noqa: E402

ASSETS = ROOT / "scenes" / "assets"
GENERATED = ASSETS / "generated"
UV_CUBE = ASSETS / "uvcube.obj"
SUN_DIR = (0.45, 0.6, 0.66)  # toward the sun: in front of the scenes' camera, up and right


def uv_cube_obj() -> str:
    """The text of the UV cube: per face 4 vertices, 4 texture coordinates
    (0,0) (1,0) (1,1) (0,1) and the face normal, two triangles."""
    faces = []  # (normal, u axis, v axis)
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3)
            n[axis] = sign
            u = np.zeros(3)
            u[(axis + 1) % 3] = sign
            faces.append((n, u, np.cross(n, u)))
    lines = ["# unit cube with texture coordinates: 24 vertices, 12 triangles"]
    for n, u, v in faces:
        for cu, cv in ((0, 0), (1, 0), (1, 1), (0, 1)):
            p = 0.5 * n + (cu - 0.5) * u + (cv - 0.5) * v
            lines.append("v " + " ".join(f"{x:.6f}" for x in p + 0.0))
    lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1"]
    for n, _, _ in faces:
        lines.append("vn " + " ".join(f"{x:.6f}" for x in n + 0.0))
    for f in range(6):
        a, b, c, d = (4 * f + k + 1 for k in range(4))
        t = (1, 2, 3, 4)
        lines.append(f"f {a}/{t[0]}/{f + 1} {b}/{t[1]}/{f + 1} {c}/{t[2]}/{f + 1}")
        lines.append(f"f {a}/{t[0]}/{f + 1} {c}/{t[2]}/{f + 1} {d}/{t[3]}/{f + 1}")
    return "\n".join(lines) + "\n"


def albedo_checker(size: int = 1024) -> np.ndarray:
    """(size, size, 3) uint8: 8 x 8 checker over a red-x / green-y gradient,
    a blue square in the first rows' first columns."""
    x = (np.arange(size) + 0.5) / size
    gx, gy = np.meshgrid(x, x, indexing="xy")
    dark = ((np.floor(gx * 8) + np.floor(gy * 8)) % 2) == 1
    img = np.stack([0.15 + 0.8 * gx, 0.15 + 0.8 * gy, np.full_like(gx, 0.25)], -1)
    img = np.where(dark[..., None], img * 0.3, img)
    img[(gx < 0.125) & (gy < 0.125)] = (0.1, 0.2, 0.95)
    return np.round(img * 255.0).astype(np.uint8)


def metallic_map(size: int = 512) -> np.ndarray:
    """(size, size, 3) uint8 grey: 16 diagonal stripes of metallic 0.1 / 0.95."""
    i = np.arange(size)
    stripe = ((i[None, :] + i[:, None]) * 16 // size) % 2
    val = np.where(stripe == 1, 0.95, 0.1)
    return np.repeat(np.round(val * 255.0).astype(np.uint8)[..., None], 3, -1)


def roughness_map(size: int = 512) -> np.ndarray:
    """(size, size, 3) uint8 grey: roughness 0.05 at the centre to 0.9 at
    the corners."""
    x = (np.arange(size) + 0.5) / size - 0.5
    r = np.sqrt(x[None, :] ** 2 + x[:, None] ** 2) / np.sqrt(0.5)
    val = 0.05 + 0.85 * r
    return np.repeat(np.round(val * 255.0).astype(np.uint8)[..., None], 3, -1)


def sky(width: int = 2048, height: int = 1024) -> np.ndarray:
    """(height, width, 3) float32 equirect radiance, file row 0 at the
    zenith (the loader flips rows; `ops/math.py sphere_to_plane` maps up to
    v = 1): a horizon-to-zenith gradient that varies with azimuth, a sun
    disc of 2.5 degrees radius at radiance 60, and 0 below the horizon."""
    v = 1.0 - (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    elev = np.pi * (v - 0.5)[:, None]
    phi = 2.0 * np.pi * u[None, :]
    d = np.stack(np.broadcast_arrays(np.cos(elev) * np.cos(phi), np.sin(elev),
                                     np.cos(elev) * np.sin(phi)), -1)
    up = np.clip(d[..., 1], 0.0, 1.0)[..., None]
    horizon = np.array([1.0, 0.93, 0.8])
    zenith = np.array([0.25, 0.45, 0.95])
    img = (horizon + (zenith - horizon) * np.sqrt(up)) * (0.8 + 0.3 * np.cos(phi))[..., None]
    sun = np.asarray(SUN_DIR) / np.linalg.norm(SUN_DIR)
    in_sun = (d @ sun) > np.cos(np.radians(2.5))
    img = np.where(in_sun[..., None], 60.0 * np.array([1.0, 0.95, 0.85]), img)
    img = np.where((d[..., 1] > 0.0)[..., None], img, 0.0)
    return img.astype(np.float32)


def _ensure(path, write) -> Path:
    """Call write(tmp) and rename it to `path`, unless `path` exists; the
    file appears whole or not at all."""
    path = Path(path)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        write(tmp)
        os.replace(tmp, path)
    return path


def ensure_uv_cube_obj(path=UV_CUBE) -> Path:
    return _ensure(path, lambda p: Path(p).write_text(uv_cube_obj()))


def ensure_albedo_png(path=GENERATED / "albedo_checker.png") -> Path:
    return _ensure(path, lambda p: write_png(p, albedo_checker()))


def ensure_metallic_png(path=GENERATED / "metallic.png") -> Path:
    return _ensure(path, lambda p: write_png(p, metallic_map()))


def ensure_roughness_png(path=GENERATED / "roughness.png") -> Path:
    return _ensure(path, lambda p: write_png(p, roughness_map()))


def ensure_sky_hdr(path=GENERATED / "sky.hdr") -> Path:
    return _ensure(path, lambda p: write_hdr(p, sky()))


def ensure_texture_assets() -> list[Path]:
    """Every asset of scenes/texcube.txt, normalcube.txt and envtorus.txt
    at its default path, written where missing."""
    return [ensure_uv_cube_obj(), ensure_albedo_png(), ensure_metallic_png(),
            ensure_roughness_png(), ensure_sky_hdr()]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    for path in ensure_texture_assets():
        print(f"{path.relative_to(ROOT)}: {path.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
