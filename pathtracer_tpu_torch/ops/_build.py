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

Every kernel is launched through `launch`, which also counts it: the
launch table `LAUNCHES` gives each counted entry point its tag (K1-K5 the
triangle walks, S1/S2 the analytic sweep, M1/M2 the material lobes, L1/L2
the light side of NEE, P1/P2 the probes), and `launches` holds the
launches by tag in this process (integrator/graphs.py adds a graph's at
each of its replays).  The argument checks that the kernels' wrappers
share sit beside it.
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

import torch

from pathtracer_tpu_torch.utils import rng

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_M32 = 0xFFFFFFFF
# csrc/lights.cu Lights: light_geom, light_tri, rows, num, fl, inv_l, geom_type, geom_mat,
# light_geoms, num_geoms, mat, mat_s, xf, inv, tri, tri_s
_LIGHT_TABLES = [_P, _P, _I, _I, ctypes.c_float, ctypes.c_float, _P, _P, _P, _I, _P, _I,
                 _P, _P, _P, _I]
# C entry point -> argtypes: c_void_p for every pointer and the stream
ARGTYPES = {
    "pt_closest_hit_wbvh": [_P] * 11 + [_I, _P],
    "pt_occlusion_wbvh": [_P] * 8 + [_I, _P],
    "pt_closest_hit_stream": [_P] * 15 + [_I, _I, _I, _P],
    "pt_occlusion_stream": [_P] * 11 + [_I, _I, _I, _P],
    "pt_closest_hit_blockmajor": [_P] * 14 + [_I] * 5 + [_P],
    "pt_sweep_closest": [_P] * 4 + [_I] + [_P] * 6 + [_I, _P],
    "pt_sweep_occluded": [_P] * 3 + [_I] + [_P] * 4 + [_I, _P],
    # csrc/shade.cu: (pointer, stride) a column, the key and pixel0 words,
    # (pointer, stride, immediate) a counter field
    "pt_scatter_lobes": [_P, _I] * 9 + [_U] * 3 + [_P, _I, _U] * 2 + [_P] * 3 + [_I, _P],
    "pt_eval_lobes": [_P, _I] * 7 + [_P] * 2 + [_I, _P],
    "pt_scatter_draw": [_P, _I] + [_U] * 3 + [_P, _I, _U] * 2 + [_P, _I, _P],
    # csrc/lights.cu: columns and the draw as in shade.cu, then the scene's tables
    "pt_sample_lights": [_P, _I] * 3 + [_U] * 3 + [_P, _I, _U] * 2 + _LIGHT_TABLES + [_P] * 7
    + [_I, _P],
    "pt_light_pdf": [_P, _I] * 5 + _LIGHT_TABLES + [_P, _I, _P],
    "pt_probe_rowprim": [_P] * 3 + [_I, _I, _P],
    "pt_probe_pop": [_I] + [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "pt_stamp": [_P, _P, _I, _I, _I, _I, _P],
    "pt_timer_probe": [_P, _I, _P],
}

# launch tag -> the C entry point whose launches it counts; the M1 draw
# (pt_scatter_draw), the stamp kernel and the timer probe are not counted
LAUNCHES = {
    "K1": "pt_closest_hit_wbvh", "K2": "pt_occlusion_wbvh", "K3": "pt_closest_hit_stream",
    "K4": "pt_occlusion_stream", "K5": "pt_closest_hit_blockmajor",
    "S1": "pt_sweep_closest", "S2": "pt_sweep_occluded",
    "M1": "pt_scatter_lobes", "M2": "pt_eval_lobes",
    "L1": "pt_sample_lights", "L2": "pt_light_pdf",
    "P1": "pt_probe_rowprim", "P2": "pt_probe_pop",
}
_TAG = {entry: tag for tag, entry in LAUNCHES.items()}
_STAMP_ENTRIES = ("pt_stamp", "pt_timer_probe")  # load_stamps' library
launches = dict.fromkeys(LAUNCHES, 0)  # launches by tag in this process

KERNELS = (
    "closest_hit_wbvh_kernel", "occlusion_wbvh_kernel",
    "closest_hit_stream_kernel", "occlusion_stream_kernel", "closest_hit_blockmajor_kernel",
    "sweep_closest_kernel", "sweep_occluded_kernel",
    "scatter_lobes_kernel", "eval_lobes_kernel", "scatter_draw_kernel",
    "sample_lights_kernel", "light_pdf_kernel",
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


def launch(entry: str, device, *args, what: str | None = None) -> None:
    """Launch C entry point `entry` with `args` (a tensor passes its data
    pointer) and the current stream of card `device`, with that card
    current (the runtime launches on the current card); raise on a CUDA
    error, named `what` (by default the entry point less its `pt_`), and
    add one to the count of the entry point's tag in `launches`."""
    lib = load_stamps() if entry in _STAMP_ENTRIES else load_library()
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(rc, f"{what or entry[3:]} launch")
    if entry in _TAG:
        launches[_TAG[entry]] += 1


# ---------------------------------------------------------------------------
# the wrappers' argument checks


def device_type(t, what: str) -> str:
    """The type of tensor `t`'s device, "cpu" (a kernel's plain version
    runs) or "cuda" (the kernel launches); another device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {t.device}")
    return t.device.type


def lanes(what: str, col, *vecs) -> str:
    """The device type of lanes given by (N,) column `col` and (N, 3)
    direction columns `vecs`, their shapes checked; `what` names the
    kernels in the message."""
    if col.dim() != 1:
        raise ValueError(f"a lane column must be (N,): {tuple(col.shape)}")
    for v in vecs:
        if v.shape != (col.shape[0], 3):
            raise ValueError(f"directions must be (N, 3) for {col.shape[0]} lanes: "
                             f"{tuple(v.shape)}")
    return device_type(col, what)


def column(t, name: str, n: int, width: int, dtype, device) -> tuple:
    """(pointer, stride between lanes in elements) of an (n,) or (n, 3)
    input column, checked: its card, dtype and shape, and a row's three
    values adjacent."""
    want = (n,) if width == 1 else (n, width)
    if tuple(t.shape) != want:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if width > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must hold a lane's {width} values adjacent")
    return t.data_ptr(), t.stride(0)


def counter(x, name: str, n: int, device) -> tuple:
    """(pointer, stride, immediate) of an RNG counter field: an int is an
    immediate (null pointer); a 0-d or one-element int32 tensor is one word
    on the card (stride 0); an (n,) int32 tensor is one word a lane."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & _M32
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.int32")
    if x.dim() <= 1 and x.numel() == 1:
        return x.data_ptr(), 0, 0
    if tuple(x.shape) == (n,):
        return x.data_ptr(), x.stride(0), 0
    raise ValueError(f"{name} must be an int, a one-word tensor or (N,): {tuple(x.shape)}")


def draw_args(key, iteration, depth, lane, pixel0: int) -> tuple:
    """The draw's arguments of the C entry points, from the lane column on."""
    n, dev = lane.shape[0], lane.device
    if not isinstance(depth, torch.Tensor) and int(depth) > rng.MAX_DEPTH:
        raise ValueError(f"depth {depth} does not fit the counter's 8 depth bits")
    k0, k1 = (int(k) & _M32 for k in key)
    return (*column(lane, "lane", n, 1, torch.int32, dev), int(pixel0) & _M32, k0, k1,
            *counter(iteration, "iteration", n, dev), *counter(depth, "depth", n, dev))


def check_rays(o, d) -> None:
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays must be (N, 3): o {tuple(o.shape)}, d {tuple(d.shape)}")


def check_cuda_args(tensors: dict, dtypes: dict) -> None:
    """Every tensor of `tensors` on the first one's device, of its dtype in
    `dtypes` and contiguous."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_aligned(**tensors) -> None:
    """The kernels read these tables in 16-byte loads."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's vector loads")
