"""The port's counter RNG against the reference: bit-exact Threefry-2x32,
fold, uniforms and the per-row / multi-draw forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng as jrng
from repro_torch.kernels import rng as trng

SEEDS = [(0, 0), (0, 42), (0x12345678, 0x9ABCDEF0), (0xFFFFFFFF, 1)]
N = 65536


def _np(t):
    return np.asarray(t).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bit_exact(seed):
    rng = np.random.default_rng(seed[0] ^ seed[1])
    x0 = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    j0, j1 = jrng.threefry2x32(np.uint32(seed[0]), np.uint32(seed[1]), x0, x1)
    t0, t1 = trng.threefry2x32(seed[0], seed[1], torch.as_tensor(x0.astype(np.int64)),
                               torch.as_tensor(x1.astype(np.int64)))
    np.testing.assert_array_equal(_np(t0.numpy()), _np(j0))
    np.testing.assert_array_equal(_np(t1.numpy()), _np(j1))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_forms_bit_exact(seed):
    js = jnp.asarray(np.array(seed, np.uint32))
    ts = trng.seed_from_key(np.array(seed, np.uint32))
    np.testing.assert_array_equal(_np(ts.numpy()), np.array(seed, np.uint32))
    # fold with a domain tag and a draw index
    for a, b in ((trng.TAG_U, 0), (trng.TAG_GUMBEL, 7), (trng.TAG_SPARSE_MH, 3)):
        np.testing.assert_array_equal(
            _np(trng.fold(ts, a, b).numpy()), _np(jrng.fold(js, a, b))
        )
    rows = np.arange(N, dtype=np.uint32)
    ju = np.asarray(jrng.uniform(js, rows, 5))
    tu = trng.uniform(ts, torch.arange(N), 5).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(
        trng.row_uniforms(ts, 1000, N, draw=2).numpy(),
        np.asarray(jrng.row_uniforms(js, 1000, N, draw=2)),
    )
    np.testing.assert_array_equal(
        trng.multi_row_uniforms(ts, 17, 4096, 4).numpy(),
        np.asarray(jrng.multi_row_uniforms(js, 17, 4096, 4)),
    )


def test_bits_to_uniform_and_key_forms():
    bits = np.array([0, 255, 256, 2**31, 2**32 - 1], np.uint32)
    np.testing.assert_array_equal(
        trng.bits_to_uniform(bits.astype(np.int64)).numpy(),
        np.asarray(jrng.bits_to_uniform(bits)),
    )
    # a raw PRNGKey's data and a single word both become a (2,) pair
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(123)))
    np.testing.assert_array_equal(
        _np(trng.seed_from_key(key).numpy()), _np(jrng.seed_from_key(key))
    )
    np.testing.assert_array_equal(
        _np(trng.seed_from_key(np.uint32(9)).numpy()),
        _np(jrng.seed_from_key(jnp.uint32(9))),
    )
