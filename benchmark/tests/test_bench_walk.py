"""The frozen walk's box and triangle tests on tiny scenes, against a hand
count."""

import numpy as np
import torch

from benchmark.reference import bvh


def _quad(x0, y0):
    """Two triangles covering [x0, x0+1] x [y0, y0+1] at z = 0."""
    a, b, c, d = (x0, y0, 0), (x0 + 1, y0, 0), (x0 + 1, y0 + 1, 0), (x0, y0 + 1, 0)
    return [[a, b, c], [a, c, d]]


def _ray(x, y):
    return torch.tensor([[x, y, 1.0]]), torch.tensor([[0.0, 0.0, -1.0]])


def test_one_leaf():
    tree = bvh.build(np.array(_quad(0, 0) + _quad(5, 0)[:1], np.float32), "cpu")
    assert tree.left.tolist() == [-1]  # three triangles: the root is a leaf
    o, d = _ray(0.25, 0.75)
    c = {"box": 0, "tri": 0}
    t, tri, u, v = bvh.walk_closest(tree, o, d, torch.tensor([1e30]), counts=c)
    assert c == {"box": 1, "tri": 3}
    assert tri.item() == 1 and t.item() == 1.0


def test_two_leaves():
    # two clusters of four triangles, ten units apart: root, two leaves
    tris = np.array(_quad(0, 0) + _quad(0, 1) + _quad(10, 0) + _quad(10, 1), np.float32)
    tree = bvh.build(tris, "cpu")
    assert (tree.left >= 0).sum().item() == 1 and tree.count.tolist().count(4) == 2
    o, d = _ray(0.5, 0.25)
    c = {"box": 0, "tri": 0}
    t, tri, _, _ = bvh.walk_closest(tree, o, d, torch.tensor([1e30]), counts=c)
    # the root box, its two children's boxes, the four triangles of the leaf entered
    assert c == {"box": 3, "tri": 4}
    assert tri.item() in (0, 1) and t.item() == 1.0
    # a shadow ray that stops short of the quads tests the same boxes and
    # triangles and is not blocked; one that passes through them is
    c = {"box": 0, "tri": 0}
    occ = bvh.walk_occluded(tree, o, d, torch.tensor([0.5]), torch.tensor([True]), counts=c)
    assert not occ.item() and c == {"box": 1, "tri": 0}
    c = {"box": 0, "tri": 0}
    occ = bvh.walk_occluded(tree, o, d, torch.tensor([2.0]), torch.tensor([True]), counts=c)
    assert occ.item() and c == {"box": 3, "tri": 4}


def test_level_walk_is_the_stack_walk():
    """The reference's breadth-first walks give the stack walks' answers on
    the glasstorus mesh, for rays from around the box toward it."""
    from benchmark.reference.scene import load

    sc = load("benchmark/configs/scenes/glasstorus.txt")
    tree = bvh.build(sc.tri_v, "cpu")
    g = torch.Generator().manual_seed(5)
    n = 4000
    o = torch.rand((n, 3), generator=g) * torch.tensor([8.0, 8.0, 8.0]) + torch.tensor([-4.0, 0.5, -4.0])
    target = torch.tensor([0.0, 2.2, 0.0]) + torch.randn((n, 3), generator=g) * 1.5
    d = target - o
    d = d / d.norm(dim=1, keepdim=True)
    cap = torch.full((n,), 1e30)
    a = bvh.walk_closest(tree, o, d, cap)
    b = bvh.closest(tree, o, d, cap)
    assert (a[1] >= 0).sum() > n // 4
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    min_t = torch.rand((n,), generator=g) * 12.0
    on = torch.rand((n,), generator=g) < 0.8
    assert torch.equal(bvh.walk_occluded(tree, o, d, min_t, on), bvh.occluded(tree, o, d, min_t, on))
