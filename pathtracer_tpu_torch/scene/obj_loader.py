"""Wavefront OBJ loader.

Port of `pathtracer_tpu/scene/obj_loader.py`, kept as the port's own copy so
that the port imports nothing of the JAX package.

Replaces the reference's vendored tiny_obj_loader (only LoadObj +
attrib/shape arrays are used, reference: src/scene.cpp:340-440).  Matches its
triangulation and normal conventions:

- n-gon faces are fan-triangulated: (i0, i(k+1), i(k+2))
  (reference: src/scene.cpp:385-389)
- vertex normals are used when present, otherwise the face normal
  normalize(cross(v1-v0, v2-v0)) (VERTEX_NORMAL flag,
  reference: src/scene.cpp:395-411, src/utilities.h:26)
- texcoords default to 0 when absent

Large meshes take a fully-vectorized fast path (bulk numpy parses +
index gathers — the per-line Python loop cost ~24 s at 640k faces);
n-gons and mixed face formats fall back to the general loop.

Returns raw numpy arrays; world-space transform + tangent baking happens in
scene/flatscene.py (mirroring Scene::setDevData, reference: src/scene.cpp:479-512).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _fix_idx(idx: np.ndarray, n: int) -> np.ndarray:
    """1-based OBJ indices; negative = relative to the end."""
    return np.where(idx > 0, idx - 1, n + idx)


def _assemble(pos, nor, uv, vi, ti, ni):
    """Gather per-corner attributes for (T, 3) index arrays."""
    ntri = vi.shape[0]
    v = pos[_fix_idx(vi, len(pos))].astype(np.float32)
    t_arr = np.zeros((ntri, 3, 2), np.float32)
    has_uv = uv.shape[0] > 0
    if has_uv:
        valid = ti != 0
        t_arr[valid] = uv[_fix_idx(ti[valid], len(uv))]
    has_normals = nor.shape[0] > 0
    # face normal fallback where any corner lacks a normal index
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    fn = np.cross(e1, e2)
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    fn = np.where(ln > 0, fn / np.maximum(ln, 1e-38), fn)
    n_arr = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    if has_normals:
        use = (ni != 0).all(axis=1)
        n_arr[use] = nor[_fix_idx(ni[use], len(nor))]
    return {
        "positions": v,       # (T, 3 corners, xyz)
        "normals": n_arr,     # (T, 3, 3)
        "uvs": t_arr,         # (T, 3, 2)
        "has_normals": has_normals,
        "has_uvs": has_uv,
    }


def _floats(lines: list[str], width: int) -> np.ndarray:
    if not lines:
        return np.zeros((0, width), np.float32)
    toks = " ".join(lines).split()
    arr = np.asarray(toks, dtype=np.float64)
    if arr.size % len(lines):
        raise ValueError("ragged float block")
    per = arr.size // len(lines)
    if per < width:
        raise ValueError("short float block")
    return arr.reshape(len(lines), per)[:, :width].astype(np.float32)


def load_obj(path: str | Path) -> dict:
    """Parse an OBJ file → dict of (T,3,3) positions, normals, (T,3,2) uvs."""
    text = Path(path).read_text(errors="replace")
    vls: list[str] = []
    vnls: list[str] = []
    vtls: list[str] = []
    fls: list[str] = []
    for line in text.splitlines():
        if line.startswith("v "):
            vls.append(line[2:])
        elif line.startswith("vn "):
            vnls.append(line[3:])
        elif line.startswith("vt "):
            vtls.append(line[3:])
        elif line.startswith("f "):
            fls.append(line[2:])

    try:
        pos = _floats(vls, 3)
        nor = _floats(vnls, 3)
        uv = _floats(vtls, 2)
    except ValueError:
        return _load_obj_slow(vls, vnls, vtls, fls)

    # fast path: uniform pure-triangle faces in one of the standard corner
    # formats (v, v/t, v//n, v/t/n)
    fls = [l for l in fls if l.strip()]
    if fls:
        first = fls[0].split()[0]
        slashes = first.count("/")
        double = "//" in first
        raw = " ".join(fls)
        blob = raw.replace("/", " ") if "/" in raw else raw
        toks = blob.split()
        per_corner = 1 if slashes == 0 else (2 if (slashes == 1 or double) else 3)
        # exactly 3 corners per face AND a uniform corner format: corner-token
        # count, total '/' count, and total '//' count must all match what the
        # first corner's format predicts (catches mixed v/t + v//n files that
        # would otherwise coincide on the slash-split token count)
        uniform = (
            len(raw.split()) == len(fls) * 3
            and raw.count("/") == slashes * 3 * len(fls)
            and raw.count("//") == (3 * len(fls) if double else 0)
        )
        if uniform and len(toks) == len(fls) * 3 * per_corner:
            try:
                idx = np.asarray(toks, dtype=np.int64)
            except ValueError:
                return _load_obj_slow(vls, vnls, vtls, fls)
            idx = idx.reshape(len(fls), 3, per_corner)
            vi = idx[:, :, 0]
            if per_corner == 1:
                ti = np.zeros_like(vi)
                ni = np.zeros_like(vi)
            elif per_corner == 2:
                if double:  # v//n
                    ti = np.zeros_like(vi)
                    ni = idx[:, :, 1]
                else:       # v/t
                    ti = idx[:, :, 1]
                    ni = np.zeros_like(vi)
            else:           # v/t/n
                ti = idx[:, :, 1]
                ni = idx[:, :, 2]
            return _assemble(pos, nor, uv, vi, ti, ni)
        # n-gons or mixed formats: general path below
    return _load_obj_slow(vls, vnls, vtls, fls)


def _load_obj_slow(vls, vnls, vtls, fls) -> dict:
    """General per-line path: n-gon fan triangulation, mixed corner
    formats, missing components (reference: src/scene.cpp:385-411)."""
    pos = np.asarray(
        [[float(x) for x in l.split()[:3]] for l in vls], np.float32
    ).reshape(-1, 3)
    nor = np.asarray(
        [[float(x) for x in l.split()[:3]] for l in vnls], np.float32
    ).reshape(-1, 3)
    uv = np.asarray(
        [[float(x) for x in l.split()[:2]] for l in vtls], np.float32
    ).reshape(-1, 2)

    faces = []
    for l in fls:
        corners = []
        for vert in l.split():
            comp = vert.split("/")
            vi = int(comp[0]) if comp[0] else 0
            ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
            ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
            corners.append((vi, ti, ni))
        if len(corners) >= 3:
            faces.append(corners)

    tri_idx = []
    for corners in faces:
        for k in range(len(corners) - 2):
            tri_idx.append([corners[0], corners[k + 1], corners[k + 2]])
    arr = (
        np.asarray(tri_idx, np.int64)
        if tri_idx
        else np.zeros((0, 3, 3), np.int64)
    )
    return _assemble(pos, nor, uv, arr[:, :, 0], arr[:, :, 1], arr[:, :, 2])
