"""Timing probes P1 and P2: Hopper counterparts of the JAX package's TPU
probes `tools/rowprim_probe.py` (P1) and `tools/kernel_microbench.py` (P2).

They compute nothing the renderer uses.  P1 times the primitives a
per-row-stack walk needs (dynamic row reads, broadcasts, per-row any packed
into bits and read back, a row sum); P2 splits one wide-node pop into its
costs, one variant per cost, popping through the node fetch of the
traversal kernels (`csrc/walk_core.cuh fetch_node`).  The CUDA kernels live
in `csrc/probes.cu`, which says how each TPU primitive maps onto the card,
what bounds each probe on one SM and what the design does about it (P1
stages its rows with TMA bulk copies ahead of the lap; P2 fetches and tests
the next pop's node before this pop's accumulator-dependent part).
`chip_smoke.py probe_bound` reckons that bound.  This module holds, for
each probe:

- the wrapper (`rowprim`, `pop`): on a CPU tensor it runs the plain PyTorch
  version; on a CUDA tensor it launches the kernel (building it on first
  use) or raises.  It never falls back.
- the plain PyTorch version (`*_plain`), with the kernel's arithmetic in
  the kernel's order, so the two agree bit for bit;
- its launch, counted under its tag in `ops/_build.py`'s table.

`tools/rowprim_probe_torch.py` and `tools/kernel_microbench_torch.py` print
ns per lap, as the originals do, and the bound on one SM beside it.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.traverse_cuda import moller_trumbore, slab

# P1's sizes (tools/rowprim_probe.py): a (ROWPRIM_M, 128) table, (8, 128) rays
ROWPRIM_M, ROWPRIM_LAPS = 1024, 2000
# P2's sizes (tools/kernel_microbench.py): a 16x128 tile of lanes, M wide
# nodes, NT triangle rows of 12 floats, F pops per measurement
POP_ROWS, POP_LANES = 16, 128
POP_M, POP_NT, POP_F = 311, 10000, 20000
POP_LEAF_K = 8  # triangles per leaf_mt lap (node*8 .. node*8+7, as the probe indexes them)
POP_ACC0 = 1e30  # the probe's accumulator start
# in the order of csrc/probes.cu P2Variant
P2_VARIANTS = (
    "loop_empty", "while_empty", "loop_and", "loop_only", "loads", "loads4", "aabb", "any1",
    "aabb_any", "push_branchless", "push_packed", "leaf_mt",
)
WARP = 32


def rowprim_inputs(device="cpu"):
    """P1's inputs as tools/rowprim_probe.py makes them (numpy, seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    tab = rng.random((ROWPRIM_M, 128), dtype=np.float32)
    rays = rng.random((8, 128), dtype=np.float32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(rays).to(device)


def pop_inputs(device="cpu"):
    """P2's inputs as tools/kernel_microbench.py `run` makes them (numpy,
    seed 0): wf (M*48,) f32, wi (M*24,) i32, tr (NT, 12) f32 and the lanes'
    origins pool (3, 16, 128) f32."""
    import numpy as np

    rng = np.random.default_rng(0)
    wf = rng.uniform(-5, 5, POP_M * 48).astype(np.float32)
    wi = rng.integers(0, 100, POP_M * 24).astype(np.int32)
    tr = rng.uniform(-5, 5, (POP_NT, 12)).astype(np.float32)
    pool = rng.uniform(0.2, 5, (3, POP_ROWS, POP_LANES)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pool, wf, wi, tr))


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _tree_sum(x):
    """Sum of the rows of (R, W), W a power of two, in a shuffle tree's
    order: column j takes column j + W/2, then j + W/4, ..., as lane j of a
    warp takes lane j + 16, then j + 8, ..."""
    x = x.clone()
    off = x.shape[1] // 2
    while off:
        x[:, :off] = x[:, :off] + x[:, off:2 * off]
        off //= 2
    return x[:, 0]


def _row_sum(tab8):
    """The sum of an (8, 128) lap in the kernel's order: one warp per row,
    lanes 4j .. 4j+3 on thread j as (x0 + x1) + (x2 + x3), a shuffle tree
    over the warp's 32 threads, then a tree over the 8 rows."""
    q = tab8.reshape(8, WARP, 4)
    per_thread = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    return _tree_sum(_tree_sum(per_thread)[None])[0]


def rowprim_plain(tab, rays, laps: int = ROWPRIM_LAPS):
    """Plain PyTorch P1: returns (1, 1) f32."""
    m = tab.shape[0]
    rows = torch.arange(8, device=tab.device) * 37
    acc = torch.zeros((), dtype=torch.float32, device=tab.device)
    for i in range(laps):
        tab8 = tab[(i * 8 + rows) % m]  # (8, 128)
        bits = torch.zeros((8,), dtype=torch.int32, device=tab.device)
        for c in range(8):
            active = (rays > tab8[:, c:c + 1]) & (rays < tab8[:, 64 + c:65 + c])
            bits = bits | (active.any(dim=1).to(torch.int32) << c)
        acc = acc + _row_sum(tab8) + bits.sum().to(torch.float32)
    return acc.reshape(1, 1)


def _warp_any(active):
    return active.view(-1, WARP).any(dim=1).repeat_interleave(WARP)


def pop_plain(variant: str, pool, wf, wi, tr, *, F: int = POP_F, leaf_k: int = POP_LEAF_K,
              acc0: float = POP_ACC0):
    """Plain PyTorch P2 for one variant: returns (16, 128) f32.  Each lane
    carries its own accumulator; the any of a box test is over the lane's
    warp (32 consecutive lanes)."""
    if variant not in P2_VARIANTS:
        raise ValueError(f"unknown P2 variant {variant!r}; one of {P2_VARIANTS}")
    dev = pool.device
    m, nt = wf.numel() // 48, tr.shape[0]
    o = pool.reshape(3, -1)
    n = o.shape[1]
    ox, oy, oz = o[0], o[1], o[2]
    cl = torch.tensor(0.1, dtype=torch.float32, device=dev)
    ray = (ox, oy, oz, 1.0 / torch.maximum(ox, cl), 1.0 / torch.maximum(oy, cl),
           1.0 / torch.maximum(oz, cl))
    boxes = wf.view(-1, 8, 6)
    links = wi.view(-1, 3, 8)[:, 0]
    wif = wi.to(torch.float32)
    out_r = torch.zeros((n,), dtype=torch.float32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    tiny = f32(1e-30)

    def box(node, c, cap):
        hit, te = slab(boxes[node, c].expand(n, 6), *ray[:3], *ray[3:])
        return hit & (te <= cap)

    if variant == "while_empty":
        r = f32(0.0)
        for _ in range(F):
            r = r + 1.0
        return (out_r + r).reshape(POP_ROWS, -1)
    acc = torch.full((n,), acc0, dtype=torch.float32, device=dev)
    for i in range(F):
        node = i % m
        if variant == "loop_empty":
            acc = acc + 1.0
        elif variant == "loop_and":
            acc = acc + float(i & 255)
        elif variant == "loop_only":
            acc = acc + float(node)
        elif variant in ("loads", "loads4"):
            s = f32(0.0)
            for nd in ([(i * 4 + j) % m for j in range(4)] if variant == "loads4" else [node]):
                for c in range(8):
                    for k in range(6):
                        s = s + wf[nd * 48 + c * 6 + k]
                    s = s + wif[nd * 24 + c]
            acc = acc + s
        elif variant == "any1":
            acc = acc + _warp_any(box(node, 0, acc)).to(torch.float32)
        elif variant == "aabb":
            for c in range(8):
                active = box(node, c, acc)
                acc = acc + (links[node, c] + active.to(torch.int32)).to(torch.float32) * tiny
        elif variant == "aabb_any":
            n_any = sum(_warp_any(box(node, c, acc)).to(torch.int32) for c in range(8))
            acc = acc + n_any.to(torch.float32) * tiny
        elif variant in ("push_branchless", "push_packed"):
            # the stack's stores are never read: only sp reaches the accumulator
            sp = torch.zeros((n,), dtype=torch.int32, device=dev)
            for c in range(8):
                push = _warp_any(box(node, c, acc)) & (links[node, c] >= 0)
                sp = sp + push.to(torch.int32)
            acc = acc + sp.to(torch.float32) * tiny
        elif variant == "leaf_mt":
            for k in range(leaf_k):
                v = tr[min(node * 8 + k, nt - 1)]
                row = torch.cat([v[0:3], v[3:6] - v[0:3], v[6:9] - v[0:3]])
                th, tt, _, _ = moller_trumbore(row[None], ox, oy, oz, ox, oy, oz)
                out_r = torch.where(th & (tt < acc), tt, out_r)
    return (out_r + acc).reshape(POP_ROWS, -1)


# ---------------------------------------------------------------------------
# wrappers


def rowprim(tab, rays, laps: int = ROWPRIM_LAPS):
    """P1 over `laps` laps; (1, 1) f32.  CPU tensors take the plain version."""
    if tab.dim() != 2 or tab.shape[1] != 128 or tuple(rays.shape) != (8, 128):
        raise ValueError(f"P1 takes a (M, 128) table and (8, 128) rays, not "
                         f"{tuple(tab.shape)} and {tuple(rays.shape)}")
    if _build.device_type(tab, "rowprim") == "cpu":
        return rowprim_plain(tab, rays, laps)
    _build.check_cuda_args(dict(tab=tab, rays=rays), dict(tab=torch.float32, rays=torch.float32))
    _build.check_aligned(tab=tab, rays=rays)  # bulk copies of 512-byte rows, 16-byte loads
    out = torch.empty((1, 1), dtype=torch.float32, device=tab.device)
    _build.launch("pt_probe_rowprim", tab.device, tab, rays, out, tab.shape[0], laps,
                  what="rowprim")
    return out


def pop(variant: str, pool, wf, wi, tr, *, F: int = POP_F, leaf_k: int = POP_LEAF_K,
        acc0: float = POP_ACC0):
    """P2's `variant` over F pops; (16, 128) f32.  CPU tensors take the
    plain version."""
    if variant not in P2_VARIANTS:
        raise ValueError(f"unknown P2 variant {variant!r}; one of {P2_VARIANTS}")
    if (tuple(pool.shape) != (3, POP_ROWS, POP_LANES) or wf.numel() % 48
            or wi.numel() != wf.numel() // 2 or tr.dim() != 2 or tr.shape[1] != 12):
        raise ValueError("P2 takes pool (3, 16, 128), wf (M*48,), wi (M*24,) and tr (NT, 12)")
    if F < 0 or leaf_k < 0:
        raise ValueError(f"P2 takes F >= 0 and leaf_k >= 0, not {F} and {leaf_k}")
    if _build.device_type(pool, "pop") == "cpu":
        return pop_plain(variant, pool, wf, wi, tr, F=F, leaf_k=leaf_k, acc0=acc0)
    _build.check_cuda_args(dict(pool=pool, wf=wf, wi=wi, tr=tr),
                           dict(pool=torch.float32, wf=torch.float32, wi=torch.int32,
                                tr=torch.float32))
    _build.check_aligned(wf=wf, wi=wi, tr=tr)  # the node and triangle rows in 16-byte loads
    out = torch.empty((POP_ROWS, POP_LANES), dtype=torch.float32, device=pool.device)
    _build.launch("pt_probe_pop", pool.device, P2_VARIANTS.index(variant), pool, wf, wi, tr, out,
                  out.numel(), wf.numel() // 48, tr.shape[0], F, leaf_k, acc0,
                  what=f"pop ({variant})")
    return out
