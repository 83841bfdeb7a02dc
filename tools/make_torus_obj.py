"""Write a rippled torus as a Wavefront OBJ with vertex normals.

numpy only and deterministic (no random numbers): the same arguments always
write the same bytes.  The default (100 x 50 segments) gives the 10,000-
triangle mesh committed as `scenes/assets/torus10k.obj`, which
`scenes/glasstorus.txt` renders in place of the reference bunny:

    python tools/make_torus_obj.py -o scenes/assets/torus10k.obj

`scenes/glasstorus160k.txt` renders the 400 x 200 torus (160,000
triangles, about 11 MB), which is not committed; `ensure_torus_obj` writes
it at first use, or by hand:

    python tools/make_torus_obj.py -o scenes/assets/torus160k.obj --major 400 --minor 200

`scenes/glasstorus640k.txt` renders the 800 x 400 torus (640,000
triangles, about 46 MB), written the same way:

    python tools/make_torus_obj.py -o scenes/assets/torus640k.obj --major 800 --minor 400

The tube radius carries a ripple `0.05 * sin(6 phi) * cos(4 theta)` (phi
around the ring, theta around the tube), so the shape is not convex and
rays meet it more than twice.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

MAJOR_RADIUS = 1.0
MINOR_RADIUS = 0.4
RIPPLE = 0.05


def torus_mesh(major_seg: int = 100, minor_seg: int = 50):
    """Returns (positions (V,3), normals (V,3), faces (F,3) 0-based) for a
    rippled torus of major_seg x minor_seg quads, two triangles each."""
    phi = np.arange(major_seg) * (2.0 * np.pi / major_seg)
    theta = np.arange(minor_seg) * (2.0 * np.pi / minor_seg)
    ph, th = np.meshgrid(phi, theta, indexing="ij")  # (U, V)
    r = MINOR_RADIUS + RIPPLE * np.sin(6.0 * ph) * np.cos(4.0 * th)
    ring = MAJOR_RADIUS + r * np.cos(th)
    pos = np.stack([ring * np.cos(ph), r * np.sin(th), ring * np.sin(ph)], -1)

    # analytic surface normal: cross of the two parametric partials
    dr_dph = RIPPLE * 6.0 * np.cos(6.0 * ph) * np.cos(4.0 * th)
    dr_dth = -RIPPLE * 4.0 * np.sin(6.0 * ph) * np.sin(4.0 * th)
    dp_dph = np.stack([
        dr_dph * np.cos(th) * np.cos(ph) - ring * np.sin(ph),
        dr_dph * np.sin(th),
        dr_dph * np.cos(th) * np.sin(ph) + ring * np.cos(ph),
    ], -1)
    dp_dth = np.stack([
        (dr_dth * np.cos(th) - r * np.sin(th)) * np.cos(ph),
        dr_dth * np.sin(th) + r * np.cos(th),
        (dr_dth * np.cos(th) - r * np.sin(th)) * np.sin(ph),
    ], -1)
    nrm = np.cross(dp_dth, dp_dph)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    i = np.arange(major_seg)[:, None]
    j = np.arange(minor_seg)[None, :]
    a = i * minor_seg + j
    b = ((i + 1) % major_seg) * minor_seg + j
    c = ((i + 1) % major_seg) * minor_seg + (j + 1) % minor_seg
    d = i * minor_seg + (j + 1) % minor_seg
    faces = np.concatenate(
        [np.stack([a, c, b], -1).reshape(-1, 3), np.stack([a, d, c], -1).reshape(-1, 3)]
    )
    return pos.reshape(-1, 3), nrm.reshape(-1, 3), faces


def write_torus_obj(path, major_seg: int = 100, minor_seg: int = 50) -> int:
    """Write the torus OBJ (`v`, `vn`, `f v//n`); returns the triangle count."""
    pos, nrm, faces = torus_mesh(major_seg, minor_seg)
    lines = [f"# rippled torus {major_seg}x{minor_seg}, {len(faces)} triangles"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in nrm]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces + 1]
    Path(path).write_text("\n".join(lines) + "\n")
    return len(faces)


def ensure_torus_obj(path, major_seg: int, minor_seg: int) -> Path:
    """Write the torus OBJ to `path` unless it is there already; returns
    the path.  The file appears whole or not at all (written aside, then
    renamed), so concurrent callers never read a partial mesh."""
    path = Path(path)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        write_torus_obj(tmp, major_seg, minor_seg)
        os.replace(tmp, path)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--out", default="scenes/assets/torus10k.obj")
    p.add_argument("--major", type=int, default=100, help="segments around the ring")
    p.add_argument("--minor", type=int, default=50, help="segments around the tube")
    args = p.parse_args(argv)
    n = write_torus_obj(args.out, args.major, args.minor)
    print(f"wrote {args.out}: {n} triangles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
