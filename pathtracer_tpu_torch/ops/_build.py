"""Build and load the port's CUDA kernels (`csrc/*.cu`).

On first use, nvcc compiles each source under `csrc/` into its own shared
library with a plain C interface, `_build/lib<source>.so` inside the
package, all sources at once in parallel, and ctypes loads them.  A library
is rebuilt when its source or a header under `csrc/` is newer than it.
Nothing is compiled or loaded at import, so the module imports on a machine
without CUDA; there, the first call that needs the kernels raises with the
reason (nvcc missing, or nvcc's stderr).

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false` without fast math, so a
kernel rounds operation for operation like its plain PyTorch version and an
IEEE division by zero gives +-inf.  `-Xptxas=-v` makes ptxas report each
kernel's registers, stack frame and spills; `ptxas_report()` returns them.
`sass_census()` counts, in the machine code of each kernel as `cuobjdump
-sass` prints it, the opcodes that say how it loads and branches.

`builds` counts the libraries nvcc compiled in this process and `load_ns`
holds the host clock (perf_counter_ns) at the start and the end of
`load_library`'s first call: the Renderer's set-up spans read both
(`kernels.load`, `kernel_builds`).  `load_stamps` loads the stamp kernel's
library alone (csrc/stamp.cu), so that tracing a scene that launches no
other kernel builds no other library.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes: c_void_p for every pointer and the stream
ARGTYPES = {
    "pt_closest_hit_wbvh": [_P] * 11 + [_I, _P],
    "pt_occlusion_wbvh": [_P] * 8 + [_I, _P],
    "pt_closest_hit_stream": [_P] * 15 + [_I, _I, _I, _P],
    "pt_occlusion_stream": [_P] * 11 + [_I, _I, _I, _P],
    "pt_closest_hit_blockmajor": [_P] * 14 + [_I] * 5 + [_P],
    "pt_probe_rowprim": [_P] * 3 + [_I, _I, _P],
    "pt_probe_pop": [_I] + [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "pt_stamp": [_P, _P, _I, _I, _I, _I, _P],
    "pt_timer_probe": [_P, _I, _P],
}

KERNELS = (
    "closest_hit_wbvh_kernel", "occlusion_wbvh_kernel",
    "closest_hit_stream_kernel", "occlusion_stream_kernel", "closest_hit_blockmajor_kernel",
    "p1_rowprim_kernel",
    *(f"p2_{v}_kernel" for v in (
        "loop_empty", "while_empty", "loop_and", "loop_only", "loads", "loads4", "aabb", "any1",
        "aabb_any", "push_branchless", "push_packed", "leaf_mt")),
    "stamp_kernel", "timer_probe_kernel",
)

_lock = threading.Lock()
_lib: SimpleNamespace | None = None
_stamp_lib: SimpleNamespace | None = None
_ptxas_log: dict[str, str] = {}
builds = 0  # libraries nvcc compiled in this process
load_ns: tuple[int, int] | None = None  # load_library's first call, perf_counter_ns


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


def _lib_path(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}.so"


def _stale(src: Path) -> bool:
    lib = _lib_path(src)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _compile(srcs: list[Path]) -> None:
    """One nvcc per source, all started together."""
    global builds
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "CUDA kernels need nvcc (not on PATH, $CUDA_HOME/bin or "
            "/usr/local/cuda/bin); the port does not fall back to its plain "
            "PyTorch versions on a CUDA tensor"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        lib = _lib_path(src)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, cmd, proc))
    failures = []
    for src, lib, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        _ptxas_log[src.name] = out + err
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
            builds += 1
    if failures:
        raise RuntimeError("\n".join(failures))


def _load(srcs: list[Path]) -> dict:
    """The C entry points of the libraries of `srcs`, built if missing or
    stale, with argtypes set."""
    stale = [s for s in srcs if _stale(s)]
    if stale:
        _compile(stale)
    fns = {}
    for src in srcs:
        dll = ctypes.CDLL(str(_lib_path(src)))
        for name, argtypes in ARGTYPES.items():
            if hasattr(dll, name):
                fn = getattr(dll, name)
                fn.argtypes, fn.restype = argtypes, _I
                fns[name] = fn
        if hasattr(dll, "pt_error_string"):
            fn = dll.pt_error_string
            fn.argtypes, fn.restype = [_I], ctypes.c_char_p
            fns["pt_error_string"] = fn
    return fns


def load_library() -> SimpleNamespace:
    """The kernels' C entry points, built if missing or stale, with argtypes
    set; one attribute per entry point, plus `pt_error_string`."""
    global _lib, load_ns
    with _lock:
        if _lib is None:
            t0 = time.perf_counter_ns()
            fns = _load(_sources())
            missing = sorted((set(ARGTYPES) | {"pt_error_string"}) - set(fns))
            if missing:
                raise RuntimeError(f"kernel libraries lack entry points {missing}")
            _lib = SimpleNamespace(**fns)
            load_ns = (t0, time.perf_counter_ns())
        return _lib


def load_stamps() -> SimpleNamespace:
    """The stamp kernel's entry points (`pt_stamp`, `pt_timer_probe`,
    `pt_error_string`): `load_library`'s if it is loaded, else
    csrc/stamp.cu's library alone, built if missing or stale."""
    global _stamp_lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stamp_lib is None:
            fns = _load([CSRC / "stamp.cu"])
            missing = sorted({"pt_stamp", "pt_timer_probe", "pt_error_string"} - set(fns))
            if missing:
                raise RuntimeError(f"the stamp library lacks entry points {missing}")
            _stamp_lib = SimpleNamespace(**fns)
        return _stamp_lib


def ptxas_report() -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes of each kernel that this
    process compiled (empty when the libraries were already built)."""
    report: dict[str, dict[str, int]] = {}
    for text in _ptxas_log.values():
        fn = None
        for line in text.splitlines():
            if m := re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line):
                fn = next((k for k in KERNELS if k in m.group(1)), None)
            elif fn and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line
            )):
                report.setdefault(fn, {}).update(
                    stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                    spill_load_bytes=int(m.group(3)))
            elif fn and (m := re.search(r"Used (\d+) registers", line)):
                report.setdefault(fn, {})["registers"] = int(m.group(1))
    return report


# SASS opcodes counted per kernel: 16-byte and other global loads, 16-byte
# shared-memory loads, local (stack, spill) loads and stores, NaN-propagating
# min/max, and the convergence regions (BSSY) that divergent branches open
SASS_OPCODES = ("LDG.E.128", "LDG", "LDS.128", "LDL", "STL", "FMNMX.NAN", "FMNMX", "BSSY", "BRA")


def sass_census() -> dict[str, dict[str, int]]:
    """Per kernel, how many operations of each `SASS_OPCODES` entry its
    machine code holds (an opcode counts under every entry it starts with:
    LDG.E.128 also under LDG).  Needs the built libraries and `cuobjdump`
    beside nvcc."""
    load_library()
    nvcc = find_nvcc()
    cuobjdump = Path(nvcc).with_name("cuobjdump") if nvcc else None
    if cuobjdump is None or not cuobjdump.is_file():
        raise RuntimeError("cuobjdump not found beside nvcc")
    census: dict[str, dict[str, int]] = {}
    for src in _sources():
        text = subprocess.run([str(cuobjdump), "-sass", str(_lib_path(src))],
                              capture_output=True, text=True, check=True).stdout
        fn = None
        for line in text.splitlines():
            if m := re.search(r"Function : (\S+)", line):
                fn = next((k for k in KERNELS if k in m.group(1)), None)
                if fn:
                    census[fn] = dict.fromkeys(SASS_OPCODES, 0)
            elif fn and (m := re.search(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z][\w.]*)", line)):
                for op in SASS_OPCODES:
                    if m.group(1) == op or m.group(1).startswith(op + "."):
                        census[fn][op] += 1
    return census


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = (_lib or _stamp_lib or load_library()).pt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
