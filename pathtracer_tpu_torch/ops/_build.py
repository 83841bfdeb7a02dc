"""Build and load the port's CUDA kernels (`csrc/*.cu`).

On first use, nvcc compiles every source under `csrc/` into one shared
library with a plain C interface, `_build/libpt_kernels.so` inside the
package, and ctypes loads it.  The library is rebuilt when a source is newer
than it.  Nothing is compiled or loaded at import, so the module imports on a
machine without CUDA; there, the first call that needs the library raises
with the reason (nvcc missing, or nvcc's stderr).

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false` without fast math, so a
kernel rounds operation for operation like its plain PyTorch version and an
IEEE division by zero gives +-inf.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libpt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str | None:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def _compile(lib: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "CUDA kernels need nvcc (not on PATH, $CUDA_HOME/bin or "
            "/usr/local/cuda/bin); the port does not fall back to its plain "
            "PyTorch versions on a CUDA tensor"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file


def load_library() -> ctypes.CDLL:
    """The kernel library, built if missing or stale, with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = BUILD_DIR / LIB_NAME
            if _stale(lib_path):
                _compile(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pt_closest_hit_wbvh.argtypes = [p] * 11 + [i, p]
            lib.pt_closest_hit_wbvh.restype = i
            lib.pt_occlusion_wbvh.argtypes = [p] * 8 + [i, p]
            lib.pt_occlusion_wbvh.restype = i
            lib.pt_error_string.argtypes = [i]
            lib.pt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load_library().pt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
