"""The port's counter-based RNG must give the JAX package's bits exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.utils import rng as jrng
from pathtracer_tpu_torch.utils import rng as trng


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5, 123456789])
def test_key_data_matches_prng_key(seed):
    # with 64-bit mode off, key_data(PRNGKey(seed)) == [0, seed & 0xFFFFFFFF]
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).tolist()
    assert list(trng.base_key(seed)) == want
    assert want == [0, seed & 0xFFFFFFFF]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def test_threefry_bitwise():
    g = np.random.default_rng(0)
    x0 = g.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    x1 = g.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    for k0, k1 in [(0, 0), (0, 7), (0xDEADBEEF, 0x12345678)]:
        a0, a1 = jrng._threefry2x32(
            jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(x0), jnp.asarray(x1)
        )
        b0, b1 = trng._threefry2x32(
            k0, k1, torch.from_numpy(x0.astype(np.int64)), torch.from_numpy(x1.astype(np.int64))
        )
        np.testing.assert_array_equal(np.asarray(a0), b0.numpy().astype(np.uint32))
        np.testing.assert_array_equal(np.asarray(a1), b1.numpy().astype(np.uint32))


@pytest.mark.parametrize("iteration,depth,stage,ncols", [
    (1, 0, trng.STAGE_CAMERA, 2),
    (5, 3, trng.STAGE_SCATTER, 3),
    (2**19 + 3, 255, trng.STAGE_LIGHT, 4),
    (2**21 + 9, 17, trng.STAGE_LIGHT, 1),  # iteration wraps past 20 bits in both
])
def test_pixel_uniforms_scalar_counters_bitwise(iteration, depth, stage, ncols):
    pix = np.random.default_rng(1).integers(0, 2**31, size=5000).astype(np.int32)
    for seed in (0, 7):
        a = jrng.pixel_uniforms(jrng.base_key(seed), iteration, depth, stage, jnp.asarray(pix), ncols)
        b = trng.pixel_uniforms(trng.base_key(seed), iteration, depth, stage, torch.from_numpy(pix), ncols)
        assert b.dtype == torch.float32 and b.shape == (5000, ncols)
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_pixel_uniforms_per_lane_counters_bitwise():
    g = np.random.default_rng(2)
    pix = g.integers(0, 2**31, size=5000).astype(np.int32)
    it = g.integers(0, 2**20, size=5000).astype(np.int32)
    dp = g.integers(0, 256, size=5000).astype(np.int32)
    a = jrng.pixel_uniforms(jrng.base_key(3), jnp.asarray(it), jnp.asarray(dp), 1, jnp.asarray(pix), 3)
    b = trng.pixel_uniforms(
        trng.base_key(3), torch.from_numpy(it), torch.from_numpy(dp), 1, torch.from_numpy(pix), 3
    )
    np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    # a lane draws the same bits whether its counters are scalars or array entries
    c = trng.pixel_uniforms(trng.base_key(3), int(it[0]), int(dp[0]), 1, torch.from_numpy(pix[:1]), 3)
    np.testing.assert_array_equal(_bits(c.numpy()), _bits(b.numpy()[:1]))


def test_depth_past_counter_bits_raises():
    with pytest.raises(ValueError, match="8 depth bits"):
        trng.pixel_uniforms(trng.base_key(0), 1, 256, 0, torch.arange(4), 2)
