"""What a lap graph's launch costs the host, and whether threads overlap the
launches of several cards.

    python tools/graph_launch_cost.py

On glasstorus (MIS, 800x800, depth 8, `swizzle=False`), with the graph route
of `integrator/graphs.py`, no profiler attached:

- one device: the host milliseconds of `CUDAGraph.replay()` for the lap
  graph ("lap", 0, True) and the milliseconds until the card has run it,
  10 times;
- the pixel-sharded step over the visible cards (the card twice when there
  is one): one lap graph replayed on every shard from one thread, then from
  one thread a shard started together, host milliseconds to issue them all
  and until every card is done, 6 times each;
- whole iterations, 3 each: the sharded step (`graphs.run_lockstep`) and one
  thread a shard, each running its own `StaticIteration.run`; the threads'
  launch counters race, so only their times are read.

Prints the card's name and power limit first.  Needs CUDA.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RES, DEPTH, KEY = 800, 8, ("lap", 0, True)


def ms(pairs: list) -> str:
    """(issue, done) milliseconds: their medians and every pair."""
    return (f"medians {statistics.median(a for a, _ in pairs):.3f} / "
            f"{statistics.median(b for _, b in pairs):.3f} ms ("
            + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in pairs) + ")")


def main() -> int:
    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.parallel import sharding as sh
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    if not torch.cuda.is_available():
        print("graph_launch_cost: needs CUDA", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; {torch.cuda.device_count()} card(s)", flush=True)
    count = torch.cuda.device_count()
    mesh = ([torch.device("cuda", i) for i in range(count)] if count > 1
            else [torch.device("cuda", 0)] * 2)
    cards = list(dict.fromkeys(mesh))

    def sync():
        for dev in cards:
            torch.cuda.synchronize(dev)

    opts = RenderOptions(sample_mode=SampleMode.MIS, swizzle=False)
    r = Renderer(ROOT / "scenes" / "glasstorus.txt", opts, resolution=(RES, RES),
                 trace_depth=DEPTH, device="cuda")
    r.step(2)
    graph = r.graphs._graphs[KEY, False][0]  # the untraced graph
    pairs = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        pairs.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    print(f"one device: lap graph {KEY} ({r.graphs.nodes[KEY]} nodes), replay() on the host / "
          f"until the card has run it: {ms(pairs)}", flush=True)

    step, _, _ = sh.make_sharded_iteration(r.static, opts, RES, RES, mesh)
    cam = r.camera.as_arrays()
    img, _, _ = step(r.flat, cam, sh.zeros_image(RES, RES, mesh), 1, r.key)
    its = step.shards.iterations
    laps = [(it.device, it._graphs[KEY, False][0]) for it in its]

    def replay(dev, g):
        with torch.cuda.device(dev):
            g.replay()

    serial, threaded = [], []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        for dev, g in laps:
            replay(dev, g)
        t1 = time.perf_counter()
        sync()
        serial.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
        start = threading.Barrier(len(laps) + 1)

        def work(dev, g):
            start.wait()
            replay(dev, g)

        threads = [threading.Thread(target=work, args=lap) for lap in laps]
        for t in threads:
            t.start()
        sync()
        t0 = time.perf_counter()
        start.wait()
        for t in threads:
            t.join()
        t1 = time.perf_counter()
        sync()
        threaded.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    what = f"{len(its)} shards on {len(cards)} card(s), one lap graph ({its[0].nodes[KEY]} nodes) each"
    print(f"{what}, one thread, issued / all done: {ms(serial)}", flush=True)
    print(f"{what}, one thread a shard, issued / all done: {ms(threaded)}", flush=True)

    lock, own = [], []
    for trial in range(3):
        sync()
        t0 = time.perf_counter()
        img, _, _ = step(r.flat, cam, img, 2 + trial, r.key)
        sync()
        lock.append((time.perf_counter() - t0) * 1e3)
        errors = []

        def run(it, iteration=2 + trial):
            try:
                it.run(cam, iteration, None)
            except Exception as e:  # reported below: the threads' result
                errors.append(e)

        threads = [threading.Thread(target=run, args=(it,)) for it in its]
        sync()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sync()
        own.append((time.perf_counter() - t0) * 1e3)
        if errors:
            raise errors[0]
    print(f"whole iterations, {len(its)} shards on {len(cards)} card(s): run_lockstep "
          + ", ".join(f"{x:.1f}" for x in lock) + " ms; one thread a shard "
          + ", ".join(f"{x:.1f}" for x in own) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
