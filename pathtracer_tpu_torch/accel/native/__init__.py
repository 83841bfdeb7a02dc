"""ctypes loader for the native SAH builder (compiled on first use).

Port of `pathtracer_tpu/accel/native/__init__.py`.  The C++ builder exports a
plain C ABI and numpy arrays cross via ctypes pointers.  The library is
compiled into the package's `_build/` directory (never into the source
tree), with the JAX copy's compiler flags.  Falls back to the pure-numpy
builder if no C++ toolchain is present; the build is host code either way.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "bvh_builder.cpp"
_LIB = _HERE.parent.parent / "_build" / "libbvh.so"

_lib = None
_tried = False


def _compile() -> bool:
    """Build libbvh.so from bvh_builder.cpp; False without a C++ compiler."""
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    for cc in ("c++", "g++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True, timeout=120,
            )
        except (FileNotFoundError, subprocess.CalledProcessError):
            continue
        os.replace(tmp, _LIB)  # atomic: a concurrent loader never sees a partial file
        return True
    tmp.unlink(missing_ok=True)
    return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _compile():
                return None
        lib = ctypes.CDLL(str(_LIB))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [f32p, f32p, f32p, i64p,
                                  ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.bvh_read.argtypes = [f32p, f32p, i32p, i32p, i32p, i32p, i32p]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build_sah_native(bmin_tri, bmax_tri, centroids, max_prim=1, buckets=20):
    """Run the C++ SAH build.  Returns (order, bmin, bmax, start, end, left,
    right, parent) or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    t = bmin_tri.shape[0]
    order = np.arange(t, dtype=np.int64)
    bmin_tri = np.ascontiguousarray(bmin_tri, np.float32)
    bmax_tri = np.ascontiguousarray(bmax_tri, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    n = lib.bvh_build(
        p(bmin_tri, ctypes.c_float), p(bmax_tri, ctypes.c_float),
        p(centroids, ctypes.c_float), p(order, ctypes.c_int64),
        t, max_prim, buckets,
    )
    bmin = np.empty((n, 3), np.float32)
    bmax = np.empty((n, 3), np.float32)
    start = np.empty(n, np.int32)
    end = np.empty(n, np.int32)
    left = np.empty(n, np.int32)
    right = np.empty(n, np.int32)
    parent = np.empty(n, np.int32)
    lib.bvh_read(
        p(bmin, ctypes.c_float), p(bmax, ctypes.c_float),
        p(start, ctypes.c_int32), p(end, ctypes.c_int32),
        p(left, ctypes.c_int32), p(right, ctypes.c_int32),
        p(parent, ctypes.c_int32),
    )
    return order, bmin, bmax, start, end, left, right, parent
