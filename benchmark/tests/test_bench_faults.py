"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at a small film (the
harness's look for a card is the runner's, which these skip), with one
fault planted in the Renderer it measures, and sees `correct` false; the
same run without a fault comes out correct.  The faults a renderer can
have: a step that returns its state unchanged; half of the pixels left out
and the mean taken over the rest; the exchange between cards left out (the
four-card cell's rows of one card never reach the film); an answer altered
where it is produced (one pixel in fifty)."""

import pytest
import torch

from benchmark.lib import harness
from benchmark.run import result_line

RES = (32, 32)
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(name, hooks=()):
    from benchmark.lib import cells

    m = harness.run(name, SEED, 0.2, False, device="cpu", resolution=RES, hooks=hooks)
    m.update(kind="cpu", power_limit=None)
    return result_line(cells.cell(name), m, False)["correct"], m["checks"]


def _on_contrib(r, change):
    """Make every step after the warm-up add `change(img, contrib)` to the
    film in place of the step's own contribution."""
    run = r._run_iteration
    state = {"warm": True}

    def broken(cam, nk=1):
        img = r.img
        rays = run(cam, nk)
        if state.pop("warm", False):
            return rays
        if isinstance(img, list):
            r.img = [a + change(b - a) for a, b in zip(img, r.img)]
        else:
            r.img = img + change(r.img - img)
        return rays

    r._run_iteration = broken


def unchanged(r):
    _on_contrib(r, lambda c: torch.zeros_like(c))


def half_left_out(r):
    def half(c):
        keep = (torch.arange(c.shape[0], device=c.device) % 2 == 0)[:, None]
        return torch.where(keep, 2.0 * c, 0.0)

    _on_contrib(r, half)


def altered(r):
    def alter(c):
        hit = (torch.arange(c.shape[0], device=c.device) % 50 == 7)[:, None]
        return torch.where(hit, c.flip(-1) * 1.5 + 0.01, c)

    _on_contrib(r, alter)


def exchange_left_out(r):
    lane_image = r._lane_image

    def missing():
        full = lane_image()
        n = full.shape[0] // r.devices
        return torch.cat([full[:-n], torch.zeros_like(full[-n:])])

    r._lane_image = missing


@pytest.mark.parametrize("name", ["glasstorus.mis", "cornell_spheres.mis", "cornell_spheres.bsdf"])
@pytest.mark.parametrize("fault", [None, unchanged, half_left_out, altered],
                         ids=["sound", "unchanged", "half_left_out", "altered"])
def test_fault_one_card(name, fault):
    ok, checks = _correct(name, () if fault is None else (fault,))
    assert ok == (fault is None), checks


@pytest.mark.parametrize("fault", [None, unchanged, half_left_out, altered, exchange_left_out],
                         ids=["sound", "unchanged", "half_left_out", "altered", "exchange_left_out"])
def test_fault_four_shards(fault):
    ok, checks = _correct("glasstorus-rows4.mis", () if fault is None else (fault,))
    assert ok == (fault is None), checks
