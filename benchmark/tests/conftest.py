"""Tests of the benchmark harness (not collected by the repository's
`pytest tests/`; run them with `python -m pytest benchmark/tests -q`).

Tests marked `card` need a CUDA card: each decides inside itself whether
there is one and skips here on the CPU.  On the card's machine:
`python -m pytest benchmark/tests -q -m card`."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")
