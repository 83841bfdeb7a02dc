"""Trace arithmetic: what a torch.profiler session says about the device and
the host.

The event reading is frozen from `tools/profile_torch_port.py profile_step`
at commit ac61a2f8 (the profiler's raw events, read directly: `key_averages`
takes minutes for a few hundred thousand events): device ops are the
kernels, copies and fills that ran on a card (a replayed CUDA graph's
kernels each count), host launches the CUDA runtime calls that put work on
a card (kernel and graph launches, copies, fills).  Added here: device-busy
time as the union of each card's op intervals, and the idle gaps between
them charged to the host call in flight.

`summarize` works on plain tuples, so the arithmetic is tested without a
card (benchmark/tests).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

# host calls that put work on the device: kernels, graphs, copies and fills
HOST_LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
# the traversal kernels by tag, K1-K5
TRAVERSAL = {
    "closest_hit_wbvh_kernel": "K1", "occlusion_wbvh_kernel": "K2",
    "closest_hit_stream_kernel": "K3", "occlusion_stream_kernel": "K4",
    "closest_hit_blockmajor_kernel": "K5",
}
TOP = 10


@dataclass
class Trace:
    """A traced window: `device` holds (name, card, start_ns, end_ns) per
    device op, `host` (name, start_ns, end_ns) per CUDA runtime call."""
    wall_s: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)


def record(fn, sync) -> Trace:
    """Run `fn()` then `sync()` under torch.profiler; its events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    tr = Trace(wall_s=wall)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                tr.device.append((name, e.device_index(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu"):
            tr.host.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return tr


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(tr: Trace) -> dict:
    """Per card: busy seconds (the union of its ops' intervals), device ops,
    the traversal kernels' runs and seconds by tag; over the window: host
    launches, graph launches, the device ops that took most time and the
    idle gaps of the busiest card by the host call in flight."""
    cards = sorted({c for _, c, _, _ in tr.device})
    busy, ops, trav, trav_s, by_name = {}, {}, {}, {}, {}
    for c in cards:
        ivs = [(s, e) for _, cc, s, e in tr.device if cc == c]
        busy[c] = sum(e - s for s, e in _union(ivs)) / 1e9
        ops[c] = len(ivs)
    for name, c, s, e in tr.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        tag = next((t for k, t in TRAVERSAL.items() if k in name), None)
        if tag:
            trav[tag] = trav.get(tag, 0) + 1
            trav_s[tag] = trav_s.get(tag, 0.0) + (e - s) / 1e9
    gaps = {}
    if cards:
        c0 = max(cards, key=lambda c: busy[c])
        merged = _union([(s, e) for _, cc, s, e in tr.device if cc == c0])
        host = sorted(tr.host, key=lambda h: h[1])
        starts = [s for _, s, _ in host]
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) // 2
            k = bisect.bisect_right(starts, mid) - 1
            who = host[k][0] if k >= 0 and host[k][2] >= mid else "python"
            gaps[who] = gaps.get(who, 0.0) + (b - a) / 1e9
    return {
        "wall_s": tr.wall_s, "busy_s": busy, "device_ops": ops,
        "traversal": trav, "traversal_s": trav_s,
        "host_launches": sum(1 for n, _, _ in tr.host if any(w in n for w in HOST_LAUNCH_WORDS)),
        "graph_launches": sum(1 for n, _, _ in tr.host if "GraphLaunch" in n),
        "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
    }
