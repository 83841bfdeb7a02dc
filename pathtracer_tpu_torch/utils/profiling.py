"""Profiling and observability.

Port of `pathtracer_tpu/utils/profiling.py`: wall-clock stage timers that
synchronize the card before reading the clock, a rays/s meter, and a device
trace over torch.profiler written as a Chrome trace, with a reader of that
trace's device events (the raw events: `key_averages()` takes about a
minute per 100k events).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

# Chrome-trace categories of the card's own work: kernels, copies, fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync(x) -> None:
    """Wait for the card that tensor (or device) `x` lives on."""
    import torch

    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Accumulating per-stage wall-clock timer (device-synchronized)."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass `sync=tensor` (or a device) to wait for its
        card before the clock is read."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t*1000:9.2f} ms total  {t/c*1000:8.2f} ms/call x{c}")
        return "\n".join(lines)


class RaysPerSecond:
    """Sliding throughput meter (the FPS counter of the headless renderer)."""

    def __init__(self, window: int = 16):
        self.window = window
        self.samples: list[tuple[float, int]] = []

    def add(self, wall_seconds: float, rays: int):
        self.samples.append((wall_seconds, rays))
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def mrays_per_sec(self) -> float:
        t = sum(s for s, _ in self.samples)
        r = sum(r for _, r in self.samples)
        return r / t / 1e6 if t > 0 else 0.0


@contextlib.contextmanager
def device_trace(out_dir: str | None = None):
    """Capture a torch.profiler trace of the block (the CPU, and the card
    when there is one) and write it to `out_dir` (default: pathtracer_trace
    in the temporary directory) as a Chrome trace, trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(out_dir or os.path.join(tempfile.gettempdir(), "pathtracer_trace"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"profiler trace written to {out}")


def top_ops_from_trace(trace_dir: str, top: int = 20) -> list[tuple[float, str]]:
    """Parse a `device_trace` dir -> [(total_ms, op_name)] hottest first,
    over the device's events: the card's kernels, copies and fills, or, in
    a trace that holds none (a CPU-only run), the CPU's ops."""
    import collections
    import glob
    import gzip
    import json

    files = sorted(glob.glob(f"{trace_dir}/**/*.json*", recursive=True), key=os.path.getmtime)
    if not files:
        return []
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e
             and not e.get("name", "").startswith("$")]
    cats = DEVICE_CATEGORIES if any(e.get("cat") in DEVICE_CATEGORIES for e in spans) else ("cpu_op",)
    dur = collections.Counter()
    for e in spans:
        if e.get("cat") in cats:
            dur[e["name"]] += e["dur"]
    return [(d / 1000.0, name) for name, d in dur.most_common(top)]
