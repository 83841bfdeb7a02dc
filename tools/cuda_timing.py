"""CUDA-event timing and SM-clock sampling for the port's measurement
scripts: chip_smoke.py, tools/kernel_microbench_torch.py and
tools/rowprim_probe_torch.py.  Needs CUDA (and nvidia-smi for the clock).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import threading
import time


def median_ms(fn, runs: int = 5, warmup: bool = True) -> float:
    """Median milliseconds of fn() on the card over `runs` runs, each timed
    with CUDA events, after one warm-up (unless the caller has just run it)."""
    import torch

    if warmup:
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def sm_clock(period_ms: int = 20, start_timeout_s: float = 5.0):
    """Samples the card's SM clock (MHz) with `nvidia-smi` every `period_ms`
    while the block runs.  Yields a list that holds the samples once the
    block has ended.  The block starts after the first sample has arrived
    (or after `start_timeout_s`, if nvidia-smi is slow to report), so a
    short block is not missed while nvidia-smi starts."""
    samples: list[float] = []
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def read():
        for line in proc.stdout:
            if line.strip().isdigit():
                samples.append(float(line))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    t_end = time.monotonic() + start_timeout_s
    while not samples and time.monotonic() < t_end and proc.poll() is None:
        time.sleep(0.01)
    skip = len(samples)  # taken before the block began
    block: list[float] = []
    try:
        yield block
    finally:
        proc.terminate()
        proc.wait()
        reader.join(timeout=5.0)
        block.extend(samples[skip:])


def describe_clock(samples: list[float]) -> str:
    """One line: the samples' median, range and count."""
    if not samples:
        return "SM clock not sampled"
    return (f"SM clock {statistics.median(samples):.0f} MHz (median of {len(samples)} samples, "
            f"{min(samples):.0f}-{max(samples):.0f})")
