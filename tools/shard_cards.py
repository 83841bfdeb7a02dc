"""The sharded steps on the visible cards: `chip_smoke.py`'s phases 1, 2, 16
and 20 alone.

    python tools/shard_cards.py

Prints the card's name and power limit and builds the kernels (phases 1-2),
writes the 160k-triangle torus OBJ if it is missing, then runs phase 16
(Renderer(devices=N) over the first min(4, count) distinct cards, or the
one card twice, against the one-device graph route, bitwise; s/iteration of
the one-device graphs, the sharded graphs and the eager shards in turn;
each card's capture seconds, memory and device-busy ms; sample sharding)
and phase 20 (the driver entry and `dryrun_multichip` over the same mesh).
Exits 0 when every check of those phases holds.  Run it on a machine with
four cards to measure the cards running their laps together.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs
    from tools.make_torus_obj import ensure_torus_obj

    t0 = time.perf_counter()
    _, smi = cs.phase_device()
    cs.phase_build()
    ensure_torus_obj(*cs.TORUS_160K)
    cs.phase_sharding(card=smi)
    cs.phase_entry(card=smi)
    cs.log(f"shard_cards: phases 16 and 20 passed, {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
