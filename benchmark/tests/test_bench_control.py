"""The comparison's two readings at a small film on the CPU: the control, the
reference in bfloat16 put in the program's place, fails every cell's
limits; a sound program that rounds otherwise (the reference with its sums
of products rounded once, as FMA contraction rounds them) passes them."""

import pytest

from benchmark.control import control_numbers, rounded_numbers
from benchmark.lib import cells

NAMES = [w["name"] for w in cells.spec()["workloads"]]


@pytest.mark.parametrize("name", NAMES)
def test_control_fails(name):
    got = control_numbers(name, 2**31 + 5, 2, device="cpu", resolution=(32, 16))
    limits = cells.cell(name)["own"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("name", NAMES)
def test_rounded_passes(name):
    got = rounded_numbers(name, 2**31 + 5, 6, device="cpu", resolution=(48, 48))
    limits = cells.cell(name)["own"]["limits"]
    assert all(got[k] <= limits[k] for k in limits), got
    assert got["film_error_pct"] > 0.0, "the variant rounds as the reference does"
