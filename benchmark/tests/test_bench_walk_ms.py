"""`walk_ms_per_spp` on synthetic trace summaries: the traced K1-K5 time a
sample a card, and nothing to read without a trace or a walk kernel."""

import pytest

from benchmark.lib import cells
from benchmark.lib.trace import Trace, summarize

MS = 1_000_000  # nanoseconds


def _summary(cards, k3_ms, k4_ms):
    """One traced iteration on `cards` cards, each running K3 for `k3_ms` and
    K4 for `k4_ms` among other kernels."""
    dev = []
    for c in range(cards):
        dev += [("void closest_hit_stream_kernel<8>", c, 0, int(k3_ms * MS)),
                ("occlusion_stream_kernel", c, 10 * MS, 10 * MS + int(k4_ms * MS)),
                ("elementwise_kernel", c, 20 * MS, 25 * MS)]
    return summarize(Trace(wall_s=0.03, device=dev))


def test_one_card():
    read = cells.reader("walk_ms_per_spp")
    # two traced samples: 3 + 1 ms, then 5 + 1 ms: 5 ms a sample
    m = {"traces": [_summary(1, 3.0, 1.0), _summary(1, 5.0, 1.0)]}
    assert read(m) == pytest.approx(5.0)


def test_four_cards_take_the_mean():
    # each card walks 2 + 2 ms of the one sample: the sum over cards over four
    m = {"traces": [_summary(4, 2.0, 2.0)]}
    assert cells.reader("walk_ms_per_spp")(m) == pytest.approx(4.0)


def test_nothing_to_read():
    read = cells.reader("walk_ms_per_spp")
    assert read({"traces": []}) is None
    no_walk = summarize(Trace(wall_s=0.01, device=[("elementwise_kernel", 0, 0, MS)]))
    assert read({"traces": [no_walk]}) is None
