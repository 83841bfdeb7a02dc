"""Two-level (streaming) traversal kernels K3 (closest hit), K4 (shadow
any-hit) and K5 (block-major closest hit), for meshes past the resident
budget.

Port of the streaming Pallas kernels of `pathtracer_tpu/ops/traverse_pallas.py`:
`closest_hit_stream_pallas` (K3), `occlusion_stream_pallas` (K4) and
`closest_hit_blockmajor_pallas` (K5).  The CUDA kernels live in
`csrc/stream_traverse.cu`; this module holds, for each:

- the wrapper (`closest_hit_stream`, `occlusion_stream`): on a CPU tensor it
  runs the plain PyTorch version; on a CUDA tensor it launches the kernel
  (building it on first use) or raises.  It never falls back.
- the plain PyTorch version (`*_plain`): a lockstep, masked walk of the same
  two-level tables, with a top stack and a block stack per ray; K3's and
  K5's in the kernel's per-ray visit order, so kernel and plain version
  agree exactly.

The wrappers launch through `ops/_build.py launch`, which counts K3's, K4's
and K5's launches in its table.

The walk is K1/K2's (`ops/traverse_cuda.py`), nested: the top tree is the
wide tree's upper part, a child link -(2+s) enters block s, which is walked
to its end with block-local node and triangle indices (triangle ids rebased
by `base[s]`).  A leaf cut hanging off a top node is a one-node block and is
tested at once, as K1 tests it, so K3 returns K1's result lane for lane.
K3's and K4's kernels share K1's and K2's walks (`csrc/walk_core.cuh`): they
walk both levels as one tree with one stack (so `closest_hit_stream` and
`occlusion_stream` hold top_depth + sub_depth against it) and read, beside
the stream tables, two tables derived from them once per scene
(`scene/flatscene.py stream_walk_tables`): triangle rows padded to 48 bytes
and a 16-byte row per block.  The plain versions keep the two stacks and the
stream tables alone.  K3 and its plain version visit the same nodes in the
same order.  K4 tests a node's leaf cuts before it pushes its inner children
where its plain version goes in slot order; both cap the box test at min_t,
which a ray never changes, so both reach the same boxes and agree on every
lane.
Sentinels as K1/K2: lanes with t_init < 0 never enter K3 or K5; K4 keeps
`occluded0` lanes blocked and never blocks a lane with min_t < 0.

K5 computes K3's result with the loops swapped: blocks outer, in index
order, each entered by the rays that reach its root box (the top slot that
links it; `FlatScene.str_roots`, built with the scene) under their current
best t, and walked with K3's block steps; the top tree's inner boxes are not
tested.  Its kernel walks a block with K3's closest-hit walk from the
block's root entry, reads K3's derived tables, and culls the root tests by
group: a ray that misses the union box of `STREAM_CULL_GROUP` consecutive
blocks skips their root tests (`str_roots8`, `str_groups`:
scene/flatscene.py stream_cull_tables, which also says why that skips no
block the root test passes).  Its plain version tests every root, or with
`groups=` the group boxes first; either way the result is the same.
The closest hits of a streamed mesh take it instead of K3 when
`STREAM_BLOCKMAJOR` is true (read by `ops/traverse.py walk_route`, as the
JAX package reads its flag of that name).
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.scene.flatscene import STREAM_CULL_GROUP
from pathtracer_tpu_torch.ops.traverse_cuda import moller_trumbore, slab

# the one stack of K3's, K4's and K5's walks (csrc/walk_core.cuh WALK_STACK)
STACK = 64
# closest hits of a streamed mesh go through K5 instead of K3 (the
# counterpart of pathtracer_tpu/ops/traverse_pallas.py STREAM_BLOCKMAJOR)
STREAM_BLOCKMAJOR = False


def _check_block_depth(sub_depth: int) -> None:
    """K5 walks one block at a time from its root entry: up to 7 pending
    siblings per level, 7*sub_depth + 1 entries."""
    if 7 * int(sub_depth) + 1 > STACK:
        raise ValueError(
            f"streaming deepest block depth {sub_depth} needs a stack of "
            f"{7 * sub_depth + 1} entries; the kernel has {STACK}"
        )


def _check_walk_depth(top_depth: int, sub_depth: int) -> None:
    """K3 and K4 walk the two levels as one tree with one stack.  A block's root
    lies at most `top_depth` below the top root and its nodes at most
    `sub_depth` below that; a depth-first walk holds up to 7 pending siblings
    per level, so at most 7*(top_depth + sub_depth) + 1 entries."""
    need = 7 * (int(top_depth) + int(sub_depth)) + 1
    if need > STACK:
        raise ValueError(
            f"streaming depths top {top_depth} + block {sub_depth} need a stack of "
            f"{need} entries; the kernel has {STACK}"
        )


def _check_tables(base, sub_nodes, sub_tris, **tables):
    """The sizes of the stream `tables` given (by their FlatScene names less
    `str_`), for base's block count and topl's top-node count."""
    n_top = tables["topl"].numel() // 8 if "topl" in tables else 0
    n_sub = base.numel()
    want = dict(
        topf=n_top * 48, topl=n_top * 8, topp=n_top * 8, roots=n_sub * 6,
        subf=n_sub * sub_nodes * 48, subi=n_sub * sub_nodes * 24,
        subp=n_sub * sub_nodes * 8, subt=n_sub * sub_tris * 9,
        subt12=n_sub * sub_tris * 12, blocks=n_sub * 4, roots8=n_sub * 8,
        groups=-(-n_sub // STREAM_CULL_GROUP) * 8,
    )
    for name, table in tables.items():
        if table.numel() != want[name]:
            raise ValueError(
                f"{name} has {table.numel()} entries; {n_top} top nodes and "
                f"{n_sub} blocks of {sub_nodes} nodes / {sub_tris} triangles need {want[name]}"
            )


def _check_walk_tables(who, base, sub_nodes, sub_tris, subt12, blocks):
    """K3's, K4's and K5's kernels read the triangles from `subt12` and the
    blocks' bases and wrapped leaf cuts from `blocks`, so on CUDA tensors they need
    both (FlatScene.str_subt12 and str_blocks, derived from subt, subi and
    base once per scene by scene/flatscene.py stream_walk_tables)."""
    if subt12 is None or blocks is None:
        raise ValueError(f"{who} on CUDA tensors needs subt12 and blocks "
                         "(FlatScene.str_subt12, str_blocks)")
    _check_tables(base, sub_nodes, sub_tris, subt12=subt12, blocks=blocks)


def _check_cull_tables(base, sub_nodes, sub_tris, roots8, groups):
    """K5's kernel culls its root tests by group, so on CUDA tensors it needs
    the padded root boxes and the group boxes (FlatScene.str_roots8 and
    str_groups, derived from str_roots once per scene by scene/flatscene.py
    stream_cull_tables)."""
    if roots8 is None or groups is None:
        raise ValueError("closest_hit_blockmajor on CUDA tensors needs roots8 and groups "
                         "(FlatScene.str_roots8, str_groups)")
    _check_tables(base, sub_nodes, sub_tris, roots8=roots8, groups=groups)


# ---------------------------------------------------------------------------
# plain PyTorch versions


class _StreamWalk:
    """Per-ray state of a lockstep two-level walk: a top stack (top nodes and
    block entries -(2+s)), a block stack of block-local nodes, and the block
    each ray is inside.  A ray pops from its block stack while it is not
    empty, else from its top stack.  K5's walk has no top tree: topf and
    topl are None and no lane is live on the top stack."""

    def __init__(self, topf, topl, subf, subi, subt, base, o, d, live, sub_nodes, sub_tris,
                 counts):
        n = o.shape[0]
        dev = o.device
        self.S, self.Tmax = sub_nodes, sub_tris
        if topf is not None:
            self.top_boxes = topf.view(-1, 8, 6)
            self.top_links = topl.view(-1, 8)
        self.sub_boxes = subf.view(-1, 8, 6)  # row s*S + local node
        self.sub_links = subi.view(-1, 3, 8)
        self.sub_tri = subt.view(-1, 9)  # row s*Tmax + local triangle
        self.base = base.long()
        roots = self.sub_links[::sub_nodes]  # (n_sub, 3, 8)
        # a one-node block wrapping a leaf cut: nothing in its root's slot 1
        self.wrapped = (roots[:, 0, 1] < 0) & (roots[:, 2, 1] <= roots[:, 1, 1])
        self.leaf_k = max(int((self.sub_links[:, 2] - self.sub_links[:, 1]).max()), 1)
        self.o, self.d = o, d
        self.inv = 1.0 / d
        # one spare column each: a push stores unconditionally at the live top
        self.tstack = torch.zeros((n, STACK + 1), dtype=torch.int32, device=dev)
        self.tsp = live.to(torch.int64)  # top node 0 is pushed for live lanes
        self.bstack = torch.zeros((n, STACK + 1), dtype=torch.int32, device=dev)
        self.bsp = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.blk = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.counts = counts

    def pop(self):
        """Pop one entry per active lane.  Lanes that pop a block entry step
        into the block (its root goes on the block stack).  Returns
        ((top lanes, top node), (block lanes, block node row)) or None."""
        in_blk = self.bsp > 0
        bl = torch.nonzero(in_blk).squeeze(1)
        tl = torch.nonzero(~in_blk & (self.tsp > 0)).squeeze(1)
        if bl.numel() == 0 and tl.numel() == 0:
            return None
        tsp = self.tsp[tl] - 1
        entry = self.tstack[tl, tsp].long()
        self.tsp[tl] = tsp
        enter = entry < 0
        el = tl[enter]
        self.blk[el] = -(entry[enter] + 2)
        self.bstack[el, 0] = 0
        self.bsp[el] = 1
        tl, tnode = tl[~enter], entry[~enter]
        bsp = self.bsp[bl] - 1
        brow = self.blk[bl] * self.S + self.bstack[bl, bsp].long()
        self.bsp[bl] = bsp
        if self.counts is not None:
            self.counts["box"] += 8 * (tl.numel() + bl.numel())
        return (tl, tnode), (bl, brow)

    def push(self, top: bool, lanes, link, take):
        stack, sp = (self.tstack, self.tsp) if top else (self.bstack, self.bsp)
        stack[lanes, sp[lanes]] = link
        sp[lanes] += take.to(torch.int64)

    def ray_inv(self, lanes):
        o, inv = self.o[lanes], self.inv[lanes]
        return o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2]

    def ray_cols(self, lanes):
        o, d = self.o[lanes], self.d[lanes]
        return tuple(c[:, None] for c in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]))

    def leaf(self, lanes, s, start, end):
        """Möller-Trumbore of `lanes` against block triangles [start, end) of
        blocks `s`: (hit, t, u, v, global id), each (L, leaf_k), in cut order."""
        loc = start[:, None] + torch.arange(self.leaf_k, device=start.device)
        valid = loc < end[:, None]
        rows = self.sub_tri[s[:, None] * self.Tmax + loc.clamp(max=self.Tmax - 1)]
        hit, t, u, v = moller_trumbore(rows, *self.ray_cols(lanes))
        if self.counts is not None:
            self.counts["tri"] += int(valid.sum())
        return hit & valid, t, u, v, self.base[s][:, None] + loc

    def children(self, top: bool, lanes, node, slot, cap):
        """Slab test of child `slot` of each popped node against `cap`.
        Returns (take, link, push, leaf block, leaf start, leaf end): `push`
        marks children that go on the lane's stack; a taken child that is
        not pushed is a leaf cut, tested now."""
        if top:
            hit, te = slab(self.top_boxes[node, slot], *self.ray_inv(lanes))
            link = self.top_links[node, slot]
            s = (-(link + 2)).clamp(min=0).long()
            wrap = (link < -1) & self.wrapped[s]
            push = (link >= 0) | ((link < -1) & ~wrap)
            leaf = wrap
            start = torch.zeros_like(s)
            end = self.sub_links[s * self.S, 2, 0].long()
        else:
            hit, te = slab(self.sub_boxes[node, slot], *self.ray_inv(lanes))
            link = self.sub_links[node, 0, slot]
            push = link >= 0
            leaf = ~push
            s = self.blk[lanes]
            start = self.sub_links[node, 1, slot].long()
            end = self.sub_links[node, 2, slot].long()
        take = hit & (te <= cap)
        return take, link, take & push, take & leaf, s, start, end


class _Closest:
    """Per-ray closest-hit state (t, tri, u, v) and K3's node and leaf
    steps, shared by the plain K3 and K5."""

    def __init__(self, w: _StreamWalk, topp, subp, d, t_init):
        n, dev = d.shape[0], d.device
        self.w = w
        self.perms = {True: topp.view(-1, 8) if topp is not None else None,
                      False: subp.view(-1, 8)}
        self.octant = (d[:, 0] > 0).long() + 2 * (d[:, 1] > 0).long() + 4 * (d[:, 2] > 0).long()
        self.t = t_init.clone()
        self.tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.u = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.v = torch.zeros((n,), dtype=torch.float32, device=dev)

    def leaf(self, li, s, start, end):
        """Test block triangles [start, end) of blocks `s` for lanes `li`,
        in cut order; a hit wins only if strictly closer."""
        th, tt, tu, tv, gid = self.w.leaf(li, s, start, end)
        lt, ltri, lu, lv = self.t[li], self.tri[li], self.u[li], self.v[li]
        for k in range(self.w.leaf_k):
            upd = th[:, k] & (tt[:, k] < lt)
            lt = torch.where(upd, tt[:, k], lt)
            ltri = torch.where(upd, gid[:, k].to(torch.int32), ltri)
            lu = torch.where(upd, tu[:, k], lu)
            lv = torch.where(upd, tv[:, k], lv)
        self.t[li], self.tri[li], self.u[li], self.v[li] = lt, ltri, lu, lv

    def node(self, top: bool, lanes, node):
        """One popped node per lane: its children far -> near in the ray's
        octant order (the nearest is pushed last), leaf cuts tested at once."""
        if lanes.numel() == 0:
            return
        perm = self.perms[top][node, self.octant[lanes]]
        for rank in range(7, -1, -1):
            slot = ((perm >> (3 * rank)) & 7).long()
            take, link, push, leaf, s, start, end = self.w.children(
                top, lanes, node, slot, self.t[lanes])
            self.w.push(top, lanes, link, push)
            lm = torch.nonzero(leaf).squeeze(1)
            if lm.numel():
                self.leaf(lanes[lm], s[lm], start[lm], end[lm])

    def result(self):
        return self.t, self.tri, self.u, self.v


def closest_hit_stream_plain(topf, topl, topp, subf, subi, subp, subt, base, o, d, t_init,
                             *, sub_nodes: int, sub_tris: int, counts: dict | None = None):
    """Plain PyTorch K3 (any device): returns (t, tri, u, v).  `counts`, if
    given, accumulates the box tests ("box", 8 per pop) and triangle tests
    ("tri") of the walk."""
    w = _StreamWalk(topf, topl, subf, subi, subt, base, o, d, t_init >= 0.0,
                    sub_nodes, sub_tris, counts)
    best = _Closest(w, topp, subp, d, t_init)
    while (popped := w.pop()) is not None:
        for top, (lanes, node) in zip((True, False), popped):
            best.node(top, lanes, node)
    return best.result()


def closest_hit_blockmajor_plain(roots, subf, subi, subp, subt, base, o, d, t_init,
                                 *, sub_nodes: int, sub_tris: int, counts: dict | None = None,
                                 groups=None):
    """Plain PyTorch K5 (any device): returns (t, tri, u, v).  `roots` holds
    the blocks' root boxes (FlatScene.str_roots).  Blocks in index order;
    the live lanes that pass block s's root box under their best t test a
    wrapped one-node block's triangles at once, or walk the block to its
    end with K3's block steps.  `groups` (FlatScene.str_groups), if given,
    is the kernel's cull: only lanes that pass the union box of a group of
    STREAM_CULL_GROUP blocks under their best t test its roots (the result
    is the same).  `counts` as K3's, plus one box test per root or group
    test; where it holds the keys "root" and "group", those tests are also
    counted there, and where it holds "visits", a list, each step of the
    block walks appends its (lanes, block node rows) to it."""
    n_sub = base.numel()
    w = _StreamWalk(None, None, subf, subi, subt, base, o, d,
                    torch.zeros_like(t_init, dtype=torch.bool), sub_nodes, sub_tris, counts)
    best = _Closest(w, None, subp, d, t_init)
    roots = roots.view(n_sub, 6)
    live = torch.nonzero(t_init >= 0.0).squeeze(1)

    def passing(lanes, box, what):
        hit, te = slab(box.expand(lanes.numel(), 6), *w.ray_inv(lanes))
        if counts is not None:
            counts["box"] += lanes.numel()
            if what in counts:
                counts[what] += lanes.numel()
        return lanes[hit & (te <= best.t[lanes])]

    for s0 in range(0, n_sub, STREAM_CULL_GROUP):
        tested = live
        if groups is not None:
            tested = passing(live, groups.view(-1, 8)[s0 // STREAM_CULL_GROUP, :6], "group")
        for s in range(s0, min(s0 + STREAM_CULL_GROUP, n_sub)):
            lanes = passing(tested, roots[s], "root")
            if lanes.numel() == 0:
                continue
            sv = torch.full_like(lanes, s)
            if w.wrapped[s]:
                root = w.sub_links[s * sub_nodes]
                best.leaf(lanes, sv, root[1, 0].expand_as(lanes).long(),
                          root[2, 0].expand_as(lanes).long())
                continue
            w.blk[lanes] = s
            w.bstack[lanes, 0] = 0
            w.bsp[lanes] = 1
            while (popped := w.pop()) is not None:
                if counts is not None and "visits" in counts:
                    counts["visits"].append(popped[1])
                best.node(False, *popped[1])
    return best.result()


def occlusion_stream_plain(topf, topl, subf, subi, subt, base, o, d, min_t, occluded0,
                           *, sub_nodes: int, sub_tris: int, counts: dict | None = None):
    """Plain PyTorch K4 (any device): returns (N,) bool."""
    occ = occluded0.clone()
    w = _StreamWalk(topf, topl, subf, subi, subt, base, o, d, ~occluded0 & (min_t >= 0.0),
                    sub_nodes, sub_tris, counts)
    t_far = min_t - 1e-5
    while (popped := w.pop()) is not None:
        for top, (lanes, node) in zip((True, False), popped):
            if lanes.numel() == 0:
                continue
            for slot in range(8):  # any-hit: order-free
                slot_t = torch.full_like(node, slot)
                take, link, push, leaf, s, start, end = w.children(
                    top, lanes, node, slot_t, min_t[lanes])
                blocked = occ[lanes]
                w.push(top, lanes, link, push & ~blocked)
                lm = torch.nonzero(leaf & ~blocked).squeeze(1)
                if lm.numel() == 0:
                    continue
                li = lanes[lm]
                th, tt, _, _, _ = w.leaf(li, s[lm], start[lm], end[lm])
                hits = th & (t_far[li, None] > tt) & (torch.abs(tt - min_t[li, None]) > 1e-4)
                occ[li] = occ[li] | hits.any(dim=1)
        # a blocked ray stops
        w.tsp = torch.where(occ, 0, w.tsp)
        w.bsp = torch.where(occ, 0, w.bsp)
    return occ


# ---------------------------------------------------------------------------
# wrappers


def closest_hit_stream(topf, topl, topp, subf, subi, subp, subt, base, o, d, t_init, *,
                       sub_nodes: int, sub_tris: int, top_depth: int, sub_depth: int,
                       subt12=None, blocks=None):
    """K3: closest hit of N rays against the two-level streaming tables.

    Returns (t, tri, u, v); tri is -1 where nothing beat t_init.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    needs `subt12` and `blocks` (`_check_walk_tables`).
    """
    _check_walk_depth(top_depth, sub_depth)
    _check_tables(base, sub_nodes, sub_tris, topf=topf, topl=topl, topp=topp, subf=subf,
                  subi=subi, subp=subp, subt=subt)
    _build.check_rays(o, d)
    if _build.device_type(o, "closest_hit_stream") == "cpu":
        return closest_hit_stream_plain(topf, topl, topp, subf, subi, subp, subt, base, o, d,
                                        t_init, sub_nodes=sub_nodes, sub_tris=sub_tris)
    _check_walk_tables("closest_hit_stream", base, sub_nodes, sub_tris, subt12, blocks)
    f32, i32 = torch.float32, torch.int32
    _build.check_cuda_args(
        dict(topf=topf, topl=topl, topp=topp, subf=subf, subi=subi, subp=subp, subt12=subt12,
             blocks=blocks, o=o, d=d, t_init=t_init),
        dict(topf=f32, topl=i32, topp=i32, subf=f32, subi=i32, subp=i32, subt12=f32,
             blocks=i32, o=f32, d=f32, t_init=f32),
    )
    _build.check_aligned(topf=topf, topl=topl, subf=subf, subi=subi, subt12=subt12,
                         blocks=blocks)
    n = o.shape[0]
    t = torch.empty((n,), dtype=f32, device=o.device)
    tri = torch.empty((n,), dtype=i32, device=o.device)
    u = torch.empty((n,), dtype=f32, device=o.device)
    v = torch.empty((n,), dtype=f32, device=o.device)
    _build.launch("pt_closest_hit_stream", o.device, topf, topl, topp, subf, subi, subp, subt12,
                  blocks, o, d, t_init, t, tri, u, v, n, sub_nodes, sub_tris)
    return t, tri, u, v


def closest_hit_blockmajor(roots, subf, subi, subp, subt, base, o, d, t_init, *,
                           sub_nodes: int, sub_tris: int, sub_depth: int, subt12=None,
                           blocks=None, roots8=None, groups=None):
    """K5: K3's closest hit with blocks outer and rays inner.  `roots` is
    FlatScene.str_roots, the blocks' root boxes, built once per scene.

    Returns (t, tri, u, v) as K3: t equal to K3's, and tri/u/v too except
    on exact-t ties, where the block of lower index wins.  CPU tensors take
    the plain version; CUDA tensors launch the kernel, which needs K3's
    derived tables `subt12` and `blocks` and its own cull tables `roots8`
    and `groups` (FlatScene.str_subt12, str_blocks, str_roots8, str_groups).
    """
    _check_block_depth(sub_depth)
    _check_tables(base, sub_nodes, sub_tris, roots=roots, subf=subf, subi=subi, subp=subp,
                  subt=subt)
    _build.check_rays(o, d)
    if _build.device_type(o, "closest_hit_blockmajor") == "cpu":
        return closest_hit_blockmajor_plain(roots, subf, subi, subp, subt, base, o, d,
                                            t_init, sub_nodes=sub_nodes, sub_tris=sub_tris)
    _check_walk_tables("closest_hit_blockmajor", base, sub_nodes, sub_tris, subt12, blocks)
    _check_cull_tables(base, sub_nodes, sub_tris, roots8, groups)
    f32, i32 = torch.float32, torch.int32
    _build.check_cuda_args(
        dict(groups=groups, roots8=roots8, subf=subf, subi=subi, subp=subp, subt12=subt12,
             blocks=blocks, o=o, d=d, t_init=t_init),
        dict(groups=f32, roots8=f32, subf=f32, subi=i32, subp=i32, subt12=f32, blocks=i32,
             o=f32, d=f32, t_init=f32),
    )
    _build.check_aligned(groups=groups, roots8=roots8, subf=subf, subi=subi, subt12=subt12,
                         blocks=blocks)
    n = o.shape[0]
    t = torch.empty((n,), dtype=f32, device=o.device)
    tri = torch.empty((n,), dtype=i32, device=o.device)
    u = torch.empty((n,), dtype=f32, device=o.device)
    v = torch.empty((n,), dtype=f32, device=o.device)
    _build.launch("pt_closest_hit_blockmajor", o.device, groups, roots8, subf, subi, subp, subt12,
                  blocks, o, d, t_init, t, tri, u, v, n, base.numel(), STREAM_CULL_GROUP,
                  sub_nodes, sub_tris)
    return t, tri, u, v


def occlusion_stream(topf, topl, subf, subi, subt, base, o, d, min_t, occluded0, *,
                     sub_nodes: int, sub_tris: int, top_depth: int, sub_depth: int,
                     subt12=None, blocks=None):
    """K4: shadow any-hit against the two-level streaming tables; (N,) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    needs `subt12` and `blocks` (`_check_walk_tables`).
    """
    _check_walk_depth(top_depth, sub_depth)
    _check_tables(base, sub_nodes, sub_tris, topf=topf, topl=topl, subf=subf, subi=subi,
                  subt=subt)
    _build.check_rays(o, d)
    if _build.device_type(o, "occlusion_stream") == "cpu":
        return occlusion_stream_plain(topf, topl, subf, subi, subt, base, o, d, min_t,
                                      occluded0, sub_nodes=sub_nodes, sub_tris=sub_tris)
    _check_walk_tables("occlusion_stream", base, sub_nodes, sub_tris, subt12, blocks)
    f32, i32 = torch.float32, torch.int32
    _build.check_cuda_args(
        dict(topf=topf, topl=topl, subf=subf, subi=subi, subt12=subt12, blocks=blocks, o=o, d=d,
             min_t=min_t, occluded0=occluded0),
        dict(topf=f32, topl=i32, subf=f32, subi=i32, subt12=f32, blocks=i32, o=f32, d=f32,
             min_t=f32, occluded0=torch.bool),
    )
    _build.check_aligned(topf=topf, topl=topl, subf=subf, subi=subi, subt12=subt12,
                         blocks=blocks)
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    _build.launch("pt_occlusion_stream", o.device, topf, topl, subf, subi, subt12, blocks, o, d,
                  min_t, occluded0, occ, o.shape[0], sub_nodes, sub_tris)
    return occ
