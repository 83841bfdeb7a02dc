"""The Renderer's compiled iteration on one CUDA device: the steps of an
iteration captured once as CUDA graphs and replayed, one host read a lap.

Port of the JAX Renderer's jitted iteration (`_iter_fn` and `_batch_fn`,
`pathtracer_tpu/integrator/render.py:214-225`, over the `lax.while_loop` /
`lax.cond` ladder of `_run_loop`, `pathtracer_tpu/integrator/wavefront.py:
650-748`).  The JAX program decides three things on the device: whether to
run another lap, whether to drop to the next ladder level and whether to
sort.  A CUDA graph cannot branch on data through PyTorch's API, so here
the host decides, with `wavefront.lap_plan`, from the one read a lap the
eager loop pays (the live count); everything between two reads is one
graph replay.  Every decision is the eager loop's, so the image, the rays
and the laps are bit for bit `wavefront.render_iteration`'s.

`StaticIteration` runs the whole film, or `local_rows` rows from pixel
`pixel0` on (a shard's pool, as `render_iteration` takes them).  The
sharded steps (parallel/sharding.py) and the step factory
(`wavefront.make_render_iteration`) run one per shard or per first pixel;
`run_lockstep` drives several at once from one host thread, each on its own
card: a round issues every shard's next lap before it reads any live count,
so distinct cards run their laps together.

`StaticIteration` runs the steps of integrator/wavefront.py over fixed
buffers: the camera and the scalars (iteration, regeneration batch size)
in one input buffer the host fills before an iteration, one pool per ladder
level, the running counters (rays, live count, lap index) and the
contributions.  Its steps, one graph each (the key in brackets):

- ("start",): camera rays into level 0's pool (`start_pool`); the rays and
  the lap index zeroed;
- ("lap", level, sort): one `lap_step` on level `level`'s pool, the sort in
  it or not; the next pool written back over it, its rays added, its live
  count stored, the lap index advanced;
- ("down", level) and ("up", level): `level_down` into the next level's
  pool, and `merge_back` out of it;
- ("finish",): `finish` into the contributions.

Every key `schedule` can reach is captured in `prepare` (the Renderer's
warm-up iteration, the JAX package's compile iteration), each after one
eager run of its step that loads what the step launches.  All of a
renderer's graphs share one memory pool; what outlives a step lives in the
buffers, allocated outside it.  Captures use the thread-local error mode,
since the preview server renders in its own thread.  Captures and replays
run with the buffers' card as the current device, on a capture stream of
that card: PyTorch's ops and the kernels' launchers take the current
stream of the card their tensors lie on, so a capture from another card
would record nothing.  A step whose graph holds no node is refused.  A
capture bakes in the options, the key words, the route flags and the film:
`graph_key` names them, and the Renderer drops its graphs when it changes.

The traversal kernels count their launches in Python (ops/traverse_cuda.py,
ops/traverse_stream_cuda.py), which a replay does not run: each graph's
counts are taken at capture and added at every replay.  Each step's
replays are counted by its key (`key_replays`, one dict increment a
replay, tracing or not); `counts()` derives the graph nodes they ran, the
laps, the sorted laps and the ladder's steps.

Tracing (utils/profiling.py).  With tracing on, `run_lockstep` records the
iteration's host spans, and each StaticIteration runs its traced steps:
the same steps with stamps around each and at the lap's stage edges,
written into its stamp table (one row a step, every lap in its own row
from the lap counter on the card), captured as graphs of their own beside
the untraced ones, so the untraced graphs keep their nodes and switching
back captures nothing.  One copy of the table an iteration goes to pinned
memory behind the finish step; the tracer reads it later.  Each capture
is recorded in `setup` (a `graph.capture` span with its `eager` and
`instantiate`), tracing or not.

With `graphs=False` each step runs eagerly on the same buffers: the loop
the CPU tests hold to `render_iteration`.  There is no fallback: a capture
or replay that fails raises `GraphError` naming its key.
"""

from __future__ import annotations

import ctypes
import gc
import time

import numpy as np
import torch

from pathtracer_tpu_torch.integrator.wavefront import (
    CameraArrays,
    _Pool,
    finish,
    lap_budget,
    lap_plan,
    lap_spec,
    lap_step,
    level_down,
    merge_back,
    new_pool,
    start_pool,
)
from pathtracer_tpu_torch.ops import traverse_cuda as tc
from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts
from pathtracer_tpu_torch.ops.traverse import packet_mode
from pathtracer_tpu_torch.scene.flatscene import FlatScene, SceneStatic
from pathtracer_tpu_torch.utils import profiling
from pathtracer_tpu_torch.utils.config import RenderOptions

# the launch counters of K1-K5, bumped by their wrappers
COUNTERS = ((tc, "closest_launches"), (tc, "occlusion_launches"), (ts, "closest_launches"),
            (ts, "occlusion_launches"), (ts, "blockmajor_launches"))
CAM_FLOATS = 14  # position, view, up, right (3 each), pixel_length (2)


class GraphError(RuntimeError):
    """A capture or a replay failed."""


_LIBCUDA = None


def graph_nodes(g: torch.cuda.CUDAGraph) -> int:
    """The nodes of captured graph `g` (made with keep_graph=True), from
    libcuda's cuGraphGetNodes (a CUgraph is the runtime's cudaGraph_t)."""
    global _LIBCUDA
    if _LIBCUDA is None:
        _LIBCUDA = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = _LIBCUDA.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise GraphError(f"cuGraphGetNodes failed with CUresult {rc}")
    return n.value


def graph_route(static: SceneStatic, opts: RenderOptions, device) -> bool:
    """Does an iteration on `device` replay CUDA graphs?  On a CUDA device,
    where the JAX package runs its jitted iteration: not for a triangle
    scene off the kernels (`pallas_traversal=False` or `use_bvh=False`),
    whose MTBVH walk and sweep read the host inside a lap and which the JAX
    package renders staged.  Elsewhere the steps run eagerly."""
    staged = static.num_tris > 0 and not (opts.pallas_traversal and opts.use_bvh)
    return torch.device(device).type == "cuda" and not staged


def graph_key(static: SceneStatic, opts: RenderOptions, key, pixel_xy, regen: bool,
              local_rows: int | None = None, pixel0: int = 0) -> tuple:
    """What a capture bakes in: the scene, the options, the RNG key words,
    the route flags read at call time (`packet_mode`, STREAM_BLOCKMAJOR),
    the film (its size and lane -> pixel map), regeneration and the pool's
    rows (`local_rows` from pixel `pixel0`; None: the whole film)."""
    return (static, opts, tuple(int(k) for k in key), packet_mode(static),
            bool(ts.STREAM_BLOCKMAJOR), static.width, static.height, pixel_xy is not None,
            bool(regen), local_rows, int(pixel0))


def launch_counts() -> tuple:
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def _set_counts(counts) -> None:
    for (mod, name), c in zip(COUNTERS, counts):
        setattr(mod, name, c)


def _copy_pool(dst: _Pool, src: _Pool) -> None:
    for a, b in zip(dst, src):
        if a is not None:
            a.copy_(b)


class StaticIteration:
    """One iteration (or regeneration batch) of a whole film, or of
    `local_rows` rows from pixel `pixel0` on, over fixed buffers on one
    device; with `graphs`, its steps replayed as CUDA graphs."""

    def __init__(self, flat: FlatScene, static: SceneStatic, opts: RenderOptions, key,
                 pixel_xy=None, regen: bool = False, graphs: bool = True,
                 local_rows: int | None = None, pixel0: int = 0):
        dev = flat.device
        if graphs and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        self.key = graph_key(static, opts, key, pixel_xy, regen, local_rows, pixel0)
        self.graphs = graphs
        self.static, self.device = static, dev
        self.n = static.width * (static.height if local_rows is None else local_rows)
        # the inputs: the camera's 14 floats, then the iteration and the
        # batch size as int32 bits, filled by one host copy an iteration
        self.inputs = torch.zeros((CAM_FLOATS + 2,), dtype=torch.float32, device=dev)
        self._host = np.zeros((CAM_FLOATS + 2,), np.float32)
        self.cam = CameraArrays(*self.inputs[:CAM_FLOATS].split((3, 3, 3, 3, 2)))
        scalars = self.inputs[CAM_FLOATS:].view(torch.int32)
        self.iteration, self.nk = scalars[0], scalars[1]
        self.spec = lap_spec(flat, static, opts, self.cam, key, self.n, pixel_xy=pixel_xy,
                             nk=self.nk if regen else None, pixel0=int(pixel0))
        self.sizes = (self.n,) + tuple(size for size, _ in self.spec.sched.shrink)
        self.pools = [new_pool(torch.zeros((m, 3), device=dev), torch.zeros((m, 3), device=dev),
                               regen=regen) for m in self.sizes]
        self.rays = torch.zeros((), dtype=torch.int64, device=dev)
        self.alive_n = torch.zeros((), dtype=torch.int64, device=dev)
        self.depth = torch.zeros((), dtype=torch.int32, device=dev)
        self.contrib = torch.zeros((self.n, 3), device=dev)
        self._graphs = {}        # (key, traced) -> (CUDAGraph, launch counts per replay)
        self._mempool = None     # the graphs' one memory pool
        self.nodes = {}          # key -> the nodes of its graph
        self.traced_nodes = {}   # key -> the nodes of its traced graph, stamps included
        self.capture_seconds = 0.0
        self.key_replays = {}    # key -> its runs, replayed or (without graphs) eager
        self.launches = (0,) * len(COUNTERS)  # K1-K5 launches its replays added
        self.setup = profiling.Tracer(6 * len(self.step_keys()) + 8)  # the captures' spans
        self.stamps = None       # (rows, STAMP_COLS) int64, made at the first traced run
        self._lap_row = 1 + 2 * len(self.sizes)  # the first lap's row of the stamp table

    # -- the steps, over the buffers -------------------------------------
    # Each takes `mark`, None or a function of a stamp column that stamps
    # the step's row (utils/profiling.py), at the lap's stage edges.
    def _start(self, mark=None) -> None:
        _copy_pool(self.pools[0], start_pool(self.spec, self.cam, self.iteration, self.n))
        self.rays.zero_()
        self.depth.zero_()

    def _lap(self, level: int, sort: bool, mark=None) -> None:
        s, r = lap_step(self.spec, self.pools[level], self.iteration, self.depth, sort, mark=mark)
        _copy_pool(self.pools[level], s)
        self.rays.add_(r)
        self.alive_n.copy_(s.alive.sum())
        if mark is not None:
            mark(profiling.STAGES_END)
        self.depth.add_(1)

    def _down(self, level: int, mark=None) -> None:
        full, small = level_down(self.spec.flat, self.static, self.pools[level],
                                 self.sizes[level + 1], mark=mark)
        _copy_pool(self.pools[level], full)
        _copy_pool(self.pools[level + 1], small)

    def _up(self, level: int, mark=None) -> None:
        _copy_pool(self.pools[level], merge_back(self.pools[level + 1], self.pools[level]))

    def _finish(self, mark=None) -> None:
        self.contrib.copy_(finish(self.spec, self.pools[0]))

    def _body(self, key: tuple, traced: bool = False):
        """Step `key` as a function of no argument; `traced`, with the
        stamps of its row: its first and last node, the stage edges inside
        (the start step zeroes the table first, but for its anchor row)."""
        kind, args = key[0], key[1:]
        step = {"start": self._start, "lap": self._lap, "down": self._down, "up": self._up,
                "finish": self._finish}[kind]
        if not traced:
            return lambda: step(*args)
        row = self.stamp_row(key)
        lap = self.depth if kind == "lap" else None

        def mark(col: int) -> None:
            profiling.stamp(self.stamps, col, row, lap)

        def run() -> None:
            if kind == "start":
                self.stamps[1:].zero_()
            mark(profiling.STEP_BEGIN)
            step(*args, mark=mark)
            # a lap has advanced the lap counter: its last stamp goes a row back
            profiling.stamp(self.stamps, profiling.STEP_END, row - (kind == "lap"), lap)

        return run

    def stamp_row(self, key: tuple, lap: int = 0) -> int:
        """The stamp table's row of step `key` (a lap: of lap `lap`, the
        row its lap counter adds to): the anchor 0, start 1, finish 2,
        ladder level l's step down 3 + 2l and back up 4 + 2l, then one row a
        lap, then the spill row, where a lap past the table's last lands."""
        kind = key[0]
        if kind == "lap":
            return min(self._lap_row + lap, self.stamps.shape[0] - 1)
        if kind in ("start", "finish"):
            return 1 + (kind == "finish")
        return 3 + 2 * key[1] + (kind == "up")

    def _new_stamps(self, nk) -> None:
        """The stamp table, with a row for each lap an iteration of `nk`
        samples may run."""
        rows = self._lap_row + lap_budget(self.static, nk) + 1
        self.stamps = torch.zeros((rows, profiling.STAMP_COLS), dtype=torch.int64,
                                  device=self.device)

    def read_stamps(self, card: int, iteration: int, steps: list, reads: list,
                    anchor: list) -> profiling.StampRead:
        """The stamp table of the iteration just issued: on the card a copy
        to pinned memory issued behind it and an event after the copy, on
        the CPU a copy."""
        if self.device.type != "cuda":
            return profiling.StampRead(card, iteration, self.stamps.numpy().copy(), None, steps,
                                       reads, anchor)
        with torch.cuda.device(self.device):
            host = torch.empty(self.stamps.shape, dtype=torch.int64, pin_memory=True)
            host.copy_(self.stamps, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return profiling.StampRead(card, iteration, host, done, steps, reads, anchor)

    def step_keys(self) -> list:
        """Every step `schedule` can reach, in an order that keeps each pool
        a valid one when each runs once: start, each level's laps then its
        step down, the steps back up, finish.  A level's laps sort or not
        (lap 0 and every sort_every-th lap with more than a quarter alive)
        where the schedule sorts."""
        sched = self.spec.sched
        levels = range(len(self.sizes))
        keys = [("start",)]
        for level in levels:
            keys += [("lap", level, False)] + ([("lap", level, True)] if sched.sort_rays else [])
            if level + 1 < len(self.sizes):
                keys.append(("down", level))
        keys += [("up", level) for level in reversed(levels[:-1])]
        return keys + [("finish",)]

    # -- capture and replay ----------------------------------------------
    def set_inputs(self, cam, iteration: int, nk: int | None) -> None:
        """The camera (CameraArrays, or `RenderCamera.as_arrays()`'s numpy
        arrays) and the scalars for the next iteration: one host copy."""
        self._host[:CAM_FLOATS] = np.concatenate(
            [(c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)).ravel()
             for c in cam])
        self._host[CAM_FLOATS:].view(np.int32)[:] = (int(iteration), 1 if nk is None else int(nk))
        self.inputs.copy_(torch.from_numpy(self._host))

    def prepare(self, traced: bool = False, nk=None) -> None:
        """Capture every step's graph (after `set_inputs`), traced or not:
        each step runs once eagerly, then is captured, on the buffers' card;
        the launch counts of the capture are taken back and kept for the
        replays.  `traced` first makes the stamp table, for batches of `nk`
        samples, without graphs too."""
        if traced and self.stamps is None:
            self._new_stamps(nk)
        if not self.graphs or (("start",), traced) in self._graphs:
            return
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            if self._mempool is None:
                self._mempool = torch.cuda.graph_pool_handle()  # one pool for all the steps
            stream = torch.cuda.Stream(self.device)
            for key in self.step_keys():
                cap = self.setup.open("graph.capture.traced" if traced else "graph.capture",
                                      card=self.card, key=key)
                body = self._body(key, traced)
                t = time.perf_counter_ns()
                body()  # loads the library and every kernel the step launches
                torch.cuda.synchronize(self.device)
                self.setup.add("eager", t, time.perf_counter_ns(), card=self.card, key=key)
                before = launch_counts()
                g = torch.cuda.CUDAGraph(keep_graph=True)
                # a collection inside the capture could destroy another graph
                # held by garbage, which a capturing thread may not do
                gc_was = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(g, pool=self._mempool, stream=stream,
                                          capture_error_mode="thread_local"):
                        body()
                    nodes = graph_nodes(g)
                    if not nodes:
                        raise GraphError("the graph holds no node")
                    t = time.perf_counter_ns()
                    g.instantiate()
                    self.setup.add("instantiate", t, time.perf_counter_ns(), card=self.card,
                                   key=key)
                except Exception as e:
                    raise GraphError(f"capture of step {key} on {self.device} failed: {e}") from e
                finally:
                    if gc_was:
                        gc.enable()
                after = launch_counts()
                _set_counts(before)  # a capture launches nothing
                self._graphs[key, traced] = (g, tuple(a - b for a, b in zip(after, before)))
                (self.traced_nodes if traced else self.nodes)[key] = nodes
                self.setup.close(cap)
            torch.cuda.synchronize(self.device)
        if not traced:  # the traced captures' time is in their spans
            self.capture_seconds = time.perf_counter() - t0

    def replay(self, key: tuple) -> None:
        """Run step `key`, traced while tracing is on: its graph's replay on
        the buffers' card, or the step itself without graphs."""
        self.key_replays[key] = self.key_replays.get(key, 0) + 1
        traced = profiling.ON
        if not self.graphs:
            self._body(key, traced)()
            return
        try:
            g, counts = self._graphs[key, traced]
        except KeyError:
            raise GraphError(f"step {key} on {self.device} was not captured") from None
        try:
            with torch.cuda.device(self.device):
                g.replay()
        except Exception as e:
            raise GraphError(f"replay of step {key} on {self.device} failed: {e}") from e
        _set_counts(c + d for c, d in zip(launch_counts(), counts))
        self.launches = tuple(c + d for c, d in zip(self.launches, counts))

    def live(self, key: tuple) -> int:
        """The live count lap step `key` stored: the one host read a lap,
        which waits for this device alone."""
        try:
            return int(self.alive_n)
        except Exception as e:
            raise GraphError(f"step {key} on {self.device} failed: {e}") from e

    @property
    def card(self) -> int:
        """The card's index (-1 off a card), for the spans."""
        return self.device.index if self.device.type == "cuda" else -1

    @property
    def replays(self) -> int:
        """Steps run, replayed or eager, traced or not."""
        return sum(self.key_replays.values())

    def counts(self) -> dict:
        """From the replays by key: the replays, the graph nodes they ran
        (each key's untraced graph's nodes times its replays: the program's
        nodes, not the stamps), the laps, the sorted laps and the ladder's
        steps down and up."""
        k = self.key_replays
        return {"replays": sum(k.values()),
                "nodes": sum(self.nodes.get(key, 0) * n for key, n in k.items()),
                "laps": sum(n for key, n in k.items() if key[0] == "lap"),
                "sorted_laps": sum(n for key, n in k.items() if key[0] == "lap" and key[2]),
                "down": sum(n for key, n in k.items() if key[0] == "down"),
                "up": sum(n for key, n in k.items() if key[0] == "up")}

    @property
    def num_graphs(self) -> int:
        """The untraced steps captured."""
        return sum(1 for _, traced in self._graphs if not traced)

    def run(self, cam, iteration: int, nk: int | None = None):
        """One iteration, samples `iteration` .. `iteration` + nk - 1 under
        regeneration: (contrib in lane order, rays emitted, the pool's
        length at each lap), as `render_iteration` returns them.  contrib
        and rays are the buffers, overwritten by the next run."""
        return run_lockstep([(self, cam, iteration, nk)])[0]


class _Traced:
    """One StaticIteration's iteration with tracing on, driven as
    `run_lockstep` drives a StaticIteration: its host spans (`set_inputs`,
    `replay`, `live_read`, `plan`), its anchor before its first step and,
    after its finish step, its stamp table handed to the tracer with each
    step's row and host clock."""

    def __init__(self, tr: profiling.Tracer, it: StaticIteration, card: int, iteration: int):
        self.tr, self.it, self.card, self.iteration = tr, it, card, iteration
        self.steps, self.reads = [], []  # see profiling.StampRead
        self.laps, self.nk, self.anchored = 0, None, []

    def _span(self, name: str, t0: int, key=None, lap: int = -1) -> int:
        return self.tr.add(name, t0, time.perf_counter_ns(), card=self.card, key=key,
                           iteration=self.iteration, lap=lap)

    def set_inputs(self, cam, iteration: int, nk) -> None:
        t0 = time.perf_counter_ns()
        self.it.set_inputs(cam, iteration, nk)
        self.nk = nk
        self._span("set_inputs", t0)

    def prepare(self) -> None:
        self.it.prepare(traced=True, nk=self.nk)
        self.anchored = profiling.anchor_stamps(self.it.stamps)

    def replay(self, key: tuple) -> None:
        lap = self.laps if key[0] == "lap" else -1
        t0 = time.perf_counter_ns()
        self.it.replay(key)
        sid = self._span("replay", t0, key, lap)
        self.steps.append((key, self.it.stamp_row(key, max(lap, 0)), lap, sid, t0))
        self.laps += lap >= 0
        if key[0] == "finish":
            self.tr.stamp_read(self.it.read_stamps(self.card, self.iteration, self.steps,
                                                   self.reads, self.anchored))

    def live(self, key: tuple) -> int:
        t0 = time.perf_counter_ns()
        n = self.it.live(key)
        lap = self.laps - 1
        self._span("live_read", t0, key, lap)
        self.reads.append((self.it.stamp_row(key, lap), time.perf_counter_ns()))
        return n

    def timed(self, plan):
        """`plan` (a lap_plan) with a `plan` span around each decision."""
        reply = None
        while True:
            t0 = time.perf_counter_ns()
            try:
                step = plan.send(reply)
            except StopIteration as done:
                self._span("plan", t0)
                return done.value
            self._span("plan", t0)
            reply = yield step


def run_lockstep(runs: list) -> list:
    """One iteration on each StaticIteration of `runs`, a list of (the
    StaticIteration, cam, iteration, nk) as `StaticIteration.run` takes
    them, from one host thread.  The graphs of each are captured at its
    first run.  Each round, every iteration whose plan (`lap_plan`) has laps
    left replays its steps up to its next lap, issued on its card without a
    wait; only then is each one's live count read, the first read waiting
    for its own card alone, so distinct cards run the round's laps together.
    Each makes the decisions its own `drive_laps` would.  Returns, in order,
    what `StaticIteration.run` returns for each.

    With tracing on, the iteration is a `step` span (the first run's
    iteration) holding each card's `set_inputs`, `replay` and `plan` spans
    and one `round` a lap of the cards' `replay`, `plan` and `live_read`
    (and a last round, of the steps back up the ladder);
    each StaticIteration runs its traced steps (card: its CUDA device's
    index, else its place in `runs`)."""
    tr = profiling.TRACER if profiling.ON else None
    if tr is None:
        runners = [it for it, *_ in runs]
    else:
        top = tr.open("step", iteration=int(runs[0][2]), root=True)
        runners = [_Traced(tr, it, it.card if it.card >= 0 else i, int(iteration))
                   for i, (it, _, iteration, _) in enumerate(runs)]
    plans = []
    for d, (it, cam, iteration, nk) in zip(runners, runs):
        d.set_inputs(cam, iteration, nk)
        d.prepare()
        d.replay(("start",))
        plan = lap_plan(it.spec.sched, it.n, lap_budget(it.static, nk))
        plans.append(plan if d is it else d.timed(plan))
    replies = [None] * len(runs)
    laps = [None] * len(runs)
    going = list(range(len(runs)))
    while going:
        rnd = tr.open("round") if tr is not None else 0
        lapped = []
        for i in going:
            try:
                step = plans[i].send(replies[i])
                while step[0] != "lap":  # ("down", level) or ("up", level)
                    runners[i].replay(step)
                    step = plans[i].send(None)
            except StopIteration as done:
                laps[i] = done.value
                continue
            key = ("lap", step[1], step[3])
            runners[i].replay(key)
            lapped.append((i, key))
        for i, key in lapped:
            replies[i] = runners[i].live(key)
        if tr is not None:
            tr.close(rnd)
        going = [i for i, _ in lapped]
    out = []
    for d, (it, *_), shard_laps in zip(runners, runs, laps):
        d.replay(("finish",))
        out.append((it.contrib, it.rays, shard_laps))
    if tr is not None:
        tr.close(top)
    return out


def held_iteration(held: dict, slot, flat: FlatScene, static: SceneStatic, opts: RenderOptions,
                   key, **kwargs) -> StaticIteration:
    """`held[slot]` if it was made for `flat`, for the graph_key of these
    arguments and on the route `graph_route` gives for `flat`'s device;
    else a new StaticIteration in its place, the old one and its graphs'
    memory dropped first.  `kwargs`: StaticIteration's pixel_xy, regen,
    local_rows, pixel0."""
    k = graph_key(static, opts, key, kwargs.get("pixel_xy"), kwargs.get("regen", False),
                  kwargs.get("local_rows"), kwargs.get("pixel0", 0))
    graphs = graph_route(static, opts, flat.device)
    it = held.get(slot)
    if it is None or it.key != k or it.spec.flat is not flat or it.graphs != graphs:
        held.pop(slot, None)
        it = held[slot] = StaticIteration(flat, static, opts, key, graphs=graphs, **kwargs)
    return it
