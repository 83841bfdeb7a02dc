"""Camera model & derivation.

Port of `pathtracer_tpu/scene/camera.py`, kept as the port's own copy so
that the port imports nothing of the JAX package.

Replicates the reference's full camera pipeline, including its quirks:

1. scene load derives fov/pixelLength from FOVY using tan of the FULL fovy
   (not fovy/2 — a reference quirk we match, reference: src/scene.cpp:218-227)
2. main() converts EYE/LOOKAT to orbit angles:
     phi   = degrees(atan2(view.z, view.x))
     theta = clamp(degrees(sin(view.y)), -89, 89)   # sin, not asin — quirk
   (reference: src/main.cpp:106-115)
3. every camera change rebuilds the basis from (theta, phi):
     view  = (cosθ·cosφ, sinθ, cosθ·sinφ)
     right = normalize(cross(view, (0,1,0)))
     up    = normalize(cross(right, view))
   (reference: src/main.cpp:181-187; the scene UP vector is ignored here)
4. ray generation (reference: src/pathtrace.cu:135-163):
     dir = normalize(view - right·plx·(x + (rx-.5) - W/2)
                          - up  ·ply·(y + (ry-.5) - H/2))
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from pathtracer_tpu_torch.scene.parser import CameraDesc


@dataclass(frozen=True)
class RenderCamera:
    """Immutable, fully-derived camera ready for ray generation."""

    width: int
    height: int
    position: tuple[float, float, float]
    view: tuple[float, float, float]
    up: tuple[float, float, float]
    right: tuple[float, float, float]
    pixel_length: tuple[float, float]
    theta: float
    phi: float

    def as_arrays(self):
        return (
            np.array(self.position, np.float32),
            np.array(self.view, np.float32),
            np.array(self.up, np.float32),
            np.array(self.right, np.float32),
            np.array(self.pixel_length, np.float32),
        )


def derive_camera(
    cam: CameraDesc,
    theta: float | None = None,
    phi: float | None = None,
    position: tuple[float, float, float] | None = None,
) -> RenderCamera:
    """Produce the basis the reference actually renders with.

    Optional theta/phi override = interactive orbit; optional position
    override = interactive pan/dolly (the mouse drag paths,
    reference: src/main.cpp:229-289).
    """
    w, h = cam.resolution

    if theta is None or phi is None:
        if cam.pos_init:
            view0 = np.asarray(cam.look_at, np.float64) - np.asarray(
                cam.position, np.float64
            )
            view0 = view0 / np.linalg.norm(view0)
            phi = math.degrees(math.atan2(view0[2], view0[0]))
            theta = float(np.clip(math.degrees(math.sin(view0[1])), -89.0, 89.0))
        else:
            theta, phi = cam.theta, cam.phi

    rt, rp = math.radians(theta), math.radians(phi)
    view = np.array(
        [math.cos(rt) * math.cos(rp), math.sin(rt), math.cos(rt) * math.sin(rp)],
        np.float64,
    )
    r = np.cross(view, np.array([0.0, 1.0, 0.0]))
    up = np.cross(r, view)
    up = up / np.linalg.norm(up)
    right = r / np.linalg.norm(r)

    yscaled = math.tan(cam.fovy * math.pi / 180.0)
    xscaled = yscaled * w / h
    pixel_length = (2.0 * xscaled / w, 2.0 * yscaled / h)

    pos = cam.position if position is None else position
    return RenderCamera(
        width=w,
        height=h,
        position=tuple(float(x) for x in pos),
        view=tuple(float(x) for x in view),
        up=tuple(float(x) for x in up),
        right=tuple(float(x) for x in right),
        pixel_length=pixel_length,
        theta=float(theta),
        phi=float(phi),
    )
