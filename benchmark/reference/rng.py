"""Counter-based RNG of the renderer under test, restated for the reference.

Frozen copy of `pathtracer_tpu_torch/utils/rng.py` at commit ac61a2f8
(threefry-2x32, 20 rounds, keyed on (pixel, iteration, depth, stage)), so the
reference draws the random numbers the program draws for the same pixel and
sample, and the two images can be compared pixel by pixel.  The random
stream is part of what a seed means, not a table the program builds.
"""

from __future__ import annotations

import torch

STAGE_CAMERA = 0
STAGE_SCATTER = 1
STAGE_LIGHT = 2

_M32 = 0xFFFFFFFF


def base_key(seed: int) -> tuple[int, int]:
    """Key words for `seed`: [0, seed mod 2^32]."""
    return (0, int(seed) & _M32)


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    k2 = (k0 ^ k1 ^ 0x1BD11BDA) & _M32
    ks = (k0, k1, k2)

    def rotl(v, r):
        return ((v << r) & _M32) | (v >> (32 - r))

    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for d in range(5):
        for r in rotations[d % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(d + 1) % 3]) & _M32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & _M32
    return x0, x1


def uniforms(key, iteration, depth, stage: int, counter: torch.Tensor, ncols: int,
             dtype=torch.float32) -> torch.Tensor:
    """(N, ncols) U[0,1) for counters `counter` (int64) at `iteration`
    (an int or an (N,) int64 tensor) and `depth` (an int).  Counter word:
    block in bits 0-1, stage in 2-3, depth in 4-11, iteration in 12-31."""
    k0, k1 = (int(k) & _M32 for k in key)
    pix = counter.to(torch.int64) & _M32
    it = iteration.to(torch.int64) & _M32 if isinstance(iteration, torch.Tensor) else int(iteration) & _M32
    base = ((it << 12) & _M32) | ((int(depth) & _M32) << 4 & _M32) | (int(stage) << 2)
    base = torch.broadcast_to(base, pix.shape) if isinstance(base, torch.Tensor) else torch.full_like(pix, base)
    cols = []
    c = 0
    while len(cols) < ncols:
        x0, x1 = _threefry2x32(k0, k1, pix, base | c)
        cols.append((x0 >> 9).to(torch.float32) * (1.0 / (1 << 23)))
        if len(cols) < ncols:
            cols.append((x1 >> 9).to(torch.float32) * (1.0 / (1 << 23)))
        c += 1
    return torch.stack(cols, dim=-1).to(dtype)
