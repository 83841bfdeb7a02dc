"""The reference's own reading of a scene file: materials, spheres, cubes,
triangle meshes and the camera, as float32 arrays.

Written from the scene format of the reference CUDA path tracer (the text
format `tools/oracle.py` at commit ac61a2f8 also reads): MATERIAL blocks of
six property lines, OBJECT blocks (`sphere`, `cube` or an OBJ path, a
material, TRANS/ROTAT/SCALE), one CAMERA block, and at most one `ENV
<file.hdr>` line, an equirect environment map in Radiance RGBE (flat
scanlines, -Y H +X W, as `tools/make_texture_assets.py` writes), each texel c * 2^(e - 136) (0 where e is
0), its rows flipped so that row 0 is the nadir, as stb_image loads it with
the flip the reference applies.  Numbers are read as
float32, the transform is T @ Rx @ Ry @ Rz @ S formed in float64 and
rounded to float32, its inverse formed in float64 from the rounded matrix,
mesh vertices and normals baked into world space in float64 and rounded, as
the reference's glm code rounds them.  The camera follows the reference's
orbit rebuild: theta = degrees(sin(view.y)), the basis from (theta, phi),
the pixel length from tan of the full FOVY.

Only what the benchmark's scenes use is read: constant material
properties, no textures and no emissive mesh; anything else raises, so a
configuration cannot use it unseen.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

LAMBERTIAN, METALLIC_WORKFLOW, DIELECTRIC, MICROFACET, LIGHT = range(5)
SPHERE, CUBE, MESH = range(3)
ROUGHNESS_MIN = 1e-3
TYPES = {"Lambertian": LAMBERTIAN, "MetallicWorkflow": METALLIC_WORKFLOW,
         "Dielectric": DIELECTRIC, "Microfacet": MICROFACET, "Light": LIGHT}


@dataclass
class Scene:
    mat_type: np.ndarray      # (M,) int
    mat_albedo: np.ndarray    # (M, 3) float32
    mat_rough: np.ndarray     # (M,) float32, floored at ROUGHNESS_MIN
    mat_metal: np.ndarray     # (M,) float32
    mat_ior: np.ndarray       # (M,) float32
    geom_type: list           # per object: SPHERE, CUBE or MESH
    geom_mat: np.ndarray      # (G,) int
    xf: np.ndarray            # (G, 4, 4) float32
    inv: np.ndarray           # (G, 4, 4) float32
    invt: np.ndarray          # (G, 4, 4) float32
    tri_v: np.ndarray         # (T, 3, 3) float32 world-space corners
    tri_n: np.ndarray         # (T, 3, 3) float32 world-space corner normals
    tri_geom: np.ndarray      # (T,) int
    lights: list              # [(geom, type)]: analytic light objects in file order
    env: np.ndarray | None    # (H, W, 3) float32 environment radiance, row 0 at the nadir
    width: int
    height: int
    depth: int
    iterations: int
    cam: dict                 # position, view, up, right (3,), pixel_length (2,): float32


def _f(s: str) -> float:
    return float(np.float32(float(s)))


def _transform(trans, rot, scale) -> np.ndarray:
    def r(axis, deg):
        a = math.radians(deg)
        c, s = math.cos(a), math.sin(a)
        m = np.eye(4)
        i, j = ((1, 2), (0, 2), (0, 1))[axis]
        m[i, i] = m[j, j] = c
        m[i, j], m[j, i] = (s, -s) if axis == 1 else (-s, s)
        return m

    t = np.eye(4)
    t[:3, 3] = trans
    return (t @ r(0, rot[0]) @ r(1, rot[1]) @ r(2, rot[2]) @ np.diag([*scale, 1.0])).astype(np.float32)


def _read_obj(path: Path):
    """Triangles of an OBJ file: corners (T, 3, 3) and corner normals
    (T, 3, 3), float32; a face without normals gets its face normal."""
    vs, vns, faces = [], [], []
    for line in path.read_text().splitlines():
        tk = line.split()
        if not tk:
            continue
        if tk[0] == "v":
            vs.append([float(x) for x in tk[1:4]])
        elif tk[0] == "vn":
            vns.append([float(x) for x in tk[1:4]])
        elif tk[0] == "f":
            if len(tk) != 4:
                raise ValueError(f"{path}: only triangles are read")
            corners = [c.split("/") for c in tk[1:]]
            faces.append([(int(c[0]), int(c[2]) if len(c) > 2 and c[2] else 0) for c in corners])
    v = np.asarray(vs, np.float32)
    vn = np.asarray(vns, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int64)  # (T, 3, 2)
    idx = lambda i, n: np.where(i > 0, i - 1, n + i)  # noqa: E731
    pos = v[idx(f[:, :, 0], len(v))]
    e = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ln = np.linalg.norm(e, axis=-1, keepdims=True)
    fn = np.where(ln > 0, e / np.maximum(ln, 1e-38), e).astype(np.float32)
    nrm = np.repeat(fn[:, None], 3, axis=1)
    has = (f[:, :, 1] != 0).all(axis=1) & (len(vn) > 0)
    nrm[has] = vn[idx(f[has][:, :, 1], len(vn))]
    return pos, nrm


def _read_hdr(path: Path) -> np.ndarray:
    """(H, W, 3) float32 radiance of a Radiance RGBE file of flat scanlines,
    file row 0 first."""
    data = path.read_bytes()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    _, _, body = data.partition(b"\n\n")
    size, _, body = body.partition(b"\n")
    tk = size.split()
    if len(tk) != 4 or tk[0] != b"-Y" or tk[2] != b"+X":
        raise ValueError(f"{path}: only -Y H +X W images are read")
    h, w = int(tk[1]), int(tk[3])
    if len(body) != 4 * w * h:
        raise ValueError(f"{path}: only flat scanlines are read, not run-length ones")
    rgbe = np.frombuffer(body, np.uint8).reshape(h, w, 4)
    e = rgbe[..., 3].astype(np.int64)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136))
    return (rgbe[..., :3].astype(np.float64) * scale[..., None]).astype(np.float32)


def _camera(res, fovy, eye, lookat) -> dict:
    w, h = res
    v0 = np.asarray(lookat, np.float64) - np.asarray(eye, np.float64)
    v0 = v0 / np.linalg.norm(v0)
    phi = math.degrees(math.atan2(v0[2], v0[0]))
    theta = float(np.clip(math.degrees(math.sin(v0[1])), -89.0, 89.0))
    rt, rp = math.radians(theta), math.radians(phi)
    view = np.array([math.cos(rt) * math.cos(rp), math.sin(rt), math.cos(rt) * math.sin(rp)])
    r = np.cross(view, np.array([0.0, 1.0, 0.0]))
    up = np.cross(r, view)
    up = up / np.linalg.norm(up)
    right = r / np.linalg.norm(r)
    ys = math.tan(fovy * math.pi / 180.0)
    xs = ys * w / h
    return {"position": np.asarray(eye, np.float32), "view": view.astype(np.float32),
            "up": up.astype(np.float32), "right": right.astype(np.float32),
            "pixel_length": np.array([2.0 * xs / w, 2.0 * ys / h], np.float32)}


def load(path: str | Path, resolution: tuple | None = None) -> Scene:
    """The scene of file `path`, its film `resolution` (W, H) when given."""
    path = Path(path)
    lines = [ln.split("//")[0].split() if not ln.strip().startswith("//") else []
             for ln in path.read_text().splitlines()]
    mats, mat_ids, geoms, cam, env = [], {}, [], {}, None
    i = 0
    while i < len(lines):
        tk = lines[i]
        i += 1
        if not tk:
            continue
        if tk[0] == "MATERIAL":
            m = {"type": LAMBERTIAN, "albedo": [1.0, 1.0, 1.0], "rough": 0.0, "metal": 0.0, "ior": 1.5}
            for _ in range(6):
                if i >= len(lines) or not lines[i]:
                    break
                key, vals = lines[i][0], lines[i][1:]
                i += 1
                if key == "TYPE":
                    m["type"] = TYPES[vals[0]]
                elif key == "ALBEDO":
                    m["albedo"] = [_f(x) for x in vals[:3]]
                elif key == "METALLIC":
                    m["metal"] = _f(vals[0])
                elif key == "ROUGHNESS":
                    m["rough"] = max(_f(vals[0]), ROUGHNESS_MIN)
                elif key == "IOR":
                    m["ior"] = _f(vals[0])
                else:
                    raise ValueError(f"{path}: material property {key} is not read here")
            mat_ids[tk[1]] = len(mats)
            mats.append(m)
        elif tk[0] == "OBJECT":
            kind = lines[i][0]
            mat = mat_ids[lines[i + 1][1]]
            i += 2
            tr, rot, sc = [0.0] * 3, [0.0] * 3, [1.0] * 3
            while i < len(lines) and lines[i] and lines[i][0] in ("TRANS", "ROTAT", "SCALE"):
                vals = [_f(x) for x in lines[i][1:4]]
                tr, rot, sc = {"TRANS": (vals, rot, sc), "ROTAT": (tr, vals, sc),
                               "SCALE": (tr, rot, vals)}[lines[i][0]]
                i += 1
            gtype = {"sphere": SPHERE, "cube": CUBE}.get(kind, MESH)
            geoms.append((gtype, mat, _transform(tr, rot, sc), path.parent / kind))
        elif tk[0] == "CAMERA":
            while i < len(lines) and lines[i]:
                cam[lines[i][0]] = lines[i][1:]
                i += 1
        elif tk[0] == "ENV":
            if env is not None:
                raise ValueError(f"{path}: one environment map is read")
            env = np.ascontiguousarray(_read_hdr(path.parent / tk[1].replace("\\", "/"))[::-1])

    xf = np.stack([g[2] for g in geoms])
    inv = np.linalg.inv(xf.astype(np.float64))
    invt = np.transpose(inv, (0, 2, 1)).astype(np.float32)
    tri_v, tri_n, tri_g = [], [], []
    for gi, (gtype, mat, m32, obj) in enumerate(geoms):
        if gtype != MESH:
            continue
        if mats[mat]["type"] == LIGHT:
            raise ValueError(f"{path}: emissive meshes are not read here")
        pos, nrm = _read_obj(obj)
        m, it = m32.astype(np.float64), invt[gi].astype(np.float64)
        vw = np.einsum("ij,tcj->tci", m[:3, :3], pos.astype(np.float64)) + m[:3, 3]
        nw = np.einsum("ij,tcj->tci", it[:3, :3], nrm.astype(np.float64))
        ln = np.linalg.norm(nw, axis=-1, keepdims=True)
        nw = np.where(ln > 0, nw / np.maximum(ln, 1e-38), nw)
        tri_v.append(vw.astype(np.float32))
        tri_n.append(nw.astype(np.float32))
        tri_g.append(np.full(len(pos), gi))
    res = tuple(resolution) if resolution else (int(cam["RES"][0]), int(cam["RES"][1]))
    return Scene(
        mat_type=np.array([m["type"] for m in mats]),
        mat_albedo=np.array([m["albedo"] for m in mats], np.float32),
        mat_rough=np.array([m["rough"] for m in mats], np.float32),
        mat_metal=np.array([m["metal"] for m in mats], np.float32),
        mat_ior=np.array([m["ior"] for m in mats], np.float32),
        geom_type=[g[0] for g in geoms],
        geom_mat=np.array([g[1] for g in geoms]),
        xf=xf, inv=inv.astype(np.float32), invt=invt,
        tri_v=np.concatenate(tri_v) if tri_v else np.zeros((0, 3, 3), np.float32),
        tri_n=np.concatenate(tri_n) if tri_n else np.zeros((0, 3, 3), np.float32),
        tri_geom=np.concatenate(tri_g) if tri_g else np.zeros((0,), np.int64),
        lights=[(gi, g[0]) for gi, g in enumerate(geoms)
                if g[0] != MESH and mats[g[1]]["type"] == LIGHT],
        env=env,
        width=res[0], height=res[1], depth=int(cam["DEPTH"][0]),
        iterations=int(cam["ITERATIONS"][0]),
        cam=_camera(res, float(cam["FOVY"][0]), [_f(x) for x in cam["EYE"]],
                    [_f(x) for x in cam["LOOKAT"]]),
    )
