"""Counter-based RNG: threefry-2x32 keyed on (pixel, iteration, depth, stage).

Port of `pathtracer_tpu/utils/rng.py`.  The bits match the JAX version
exactly, so a port render draws the same random numbers per pixel as the
reference does.  There is no global RNG state: a key is a pair of 32-bit
words made from the seed, and every draw is a pure function of the key and
the counter.

PyTorch's uint32 op coverage is thin, so the 32-bit words ride in int64
tensors and are masked back to 32 bits after every add and shift.
"""

from __future__ import annotations

import torch

# Stage ids: one independent stream per consumer per bounce.
STAGE_CAMERA = 0
STAGE_SCATTER = 1
STAGE_LIGHT = 2

MAX_DEPTH = 255  # depth has 8 bits of the counter word (bits 4-11)

_M32 = 0xFFFFFFFF


def base_key(seed: int = 0) -> tuple[int, int]:
    """Key words for `seed`: `jax.random.key_data(jax.random.PRNGKey(seed))`
    with 64-bit mode off, which is `[0, seed & 0xFFFFFFFF]`."""
    return (0, int(seed) & _M32)


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, over int64 tensors holding uint32 words."""
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


def _u32(x):
    """A counter field as uint32 words in int64, or a Python int (no host
    copy: the field may come from a CUDA graph's buffer or the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def pixel_uniforms(
    key: tuple[int, int], iteration, depth, stage: int,
    pixel_idx: torch.Tensor, ncols: int,
) -> torch.Tensor:
    """U[0,1) block keyed by global pixel index, (N, ncols) float32.

    `iteration` and `depth` may be Python ints, 0-d tensors (a CUDA
    graph's buffers) or per-lane tensors shaped like `pixel_idx`.  Counter
    word: block in bits 0-1, stage in 2-3, depth in 4-11, iteration in
    12-31.  A depth above 255 would overflow into the iteration bits, so it
    raises.
    """
    if not isinstance(depth, torch.Tensor) and int(depth) > MAX_DEPTH:
        raise ValueError(f"depth {depth} does not fit the counter's 8 depth bits")
    k0, k1 = (int(k) & _M32 for k in key)
    pix = pixel_idx.to(torch.int64) & _M32
    base = (
        ((_u32(iteration) << 12) & _M32)
        | ((_u32(depth) << 4) & _M32)
        | (int(stage) << 2)
    )
    base = (torch.broadcast_to(base, pix.shape) if isinstance(base, torch.Tensor)
            else torch.full_like(pix, base))

    def u01(x):
        # uint32 -> U[0,1): the top 23 bits as a mantissa
        return (x >> 9).to(torch.float32) * (1.0 / (1 << 23))

    cols = []
    c = 0
    while len(cols) < ncols:
        x0, x1 = _threefry2x32(k0, k1, pix, base | c)
        cols.append(u01(x0))
        if len(cols) < ncols:
            cols.append(u01(x1))
        c += 1
    return torch.stack(cols, dim=-1)
