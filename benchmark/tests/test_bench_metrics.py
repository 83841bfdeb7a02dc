"""The arithmetic of the metrics: the window's rate, and the device's busy
and idle time from a small synthetic trace."""

import pytest

from benchmark.lib import cells
from benchmark.lib.trace import Trace, summarize

MS = 1_000_000  # nanoseconds


def test_msamples_per_s():
    m = {"window_samples": 120, "width": 800, "height": 800, "window_s": 12.0}
    assert cells.reader("msamples_per_s")(m) == pytest.approx(6.4)


def _trace():
    """Two cards over 10 ms: card 0 busy 0-3 and 2-5 ms (overlapping: 5 ms
    busy), then 8-9 ms; card 1 busy 0-4 ms.  The host: a graph launch over
    0-1 ms, a synchronize over 5-8 ms, a copy at 9-9.5 ms."""
    dev = [("k_a", 0, 0, 3 * MS), ("k_b", 0, 2 * MS, 5 * MS), ("k_a", 0, 8 * MS, 9 * MS),
           ("closest_hit_wbvh_kernel", 1, 0, 4 * MS)]
    host = [("cudaGraphLaunch", 0, 1 * MS), ("cudaStreamSynchronize", 5 * MS, 8 * MS),
            ("cudaMemcpyAsync", 9 * MS, int(9.5 * MS)), ("cudaEventQuery", 9 * MS, 9 * MS)]
    return Trace(wall_s=0.010, device=dev, host=host)


def test_summarize():
    s = summarize(_trace())
    assert s["busy_s"] == {0: pytest.approx(0.006), 1: pytest.approx(0.004)}
    assert s["device_ops"] == {0: 3, 1: 1}
    assert s["traversal"] == {"K1": 1}
    assert s["host_launches"] == 2 and s["graph_launches"] == 1
    assert s["idle_gaps"] == [("cudaStreamSynchronize", pytest.approx(0.003))]
    assert s["top_ops"][0] == ("k_a", pytest.approx(0.004))


def test_idle_and_spread():
    s = summarize(_trace())
    # two traced samples alike; the window ran 50 samples in 1 s: 20 ms each
    m = {"traces": [s, s], "window_s": 1.0, "window_samples": 50}
    # mean busy over the cards 5 ms of 20
    assert cells.reader("device_idle_pct")(m) == pytest.approx(75.0)
    # busiest 6 ms against the mean 5
    assert cells.reader("card_busy_spread_pct")(m) == pytest.approx(20.0)
    assert cells.reader("device_ops_per_spp")(m) == 4
    assert cells.reader("host_launches_per_spp")(m) == 2
    assert cells.reader("device_busy_ms_per_spp")(m) == pytest.approx(5.0)


def test_nothing_to_read():
    m = {"traces": [], "walk": None, "lap_pools": [], "samples_booked": 0}
    for name in ("device_idle_pct", "device_busy_ms_per_spp", "card_busy_spread_pct", "walk_roofline_pct",
                 "lap_lanes_per_sample", "rays_per_sample", "host_launches_per_spp"):
        assert cells.reader(name)(m) is None
