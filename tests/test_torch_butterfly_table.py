"""The port's butterfly table (repro_torch.kernels.butterfly_table, K1's
plain version on the CPU) against the reference: its Pallas kernel in
interpret mode, its closed-form oracle and ``repro.core``'s table.

Tolerance: integer weights keep every fp32 sum exact, so tables must be
equal bit for bit; bf16 inputs follow the reference's own tolerance
(5e-2) against the fp32 closed form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jb
from repro.kernels.butterfly_table import butterfly_table as j_table
from repro.kernels.butterfly_table.ref import butterfly_table_ref as j_ref
from repro_torch.kernels.butterfly_table import butterfly_table
from repro_torch.kernels.butterfly_table import kernel as K1
from repro_torch.kernels.butterfly_table.ref import butterfly_table_ref

# (W, (B, K)) of the reference's tests/test_kernel_butterfly.py sweep
# whose dims are multiples of W
CASES = [(W, s) for W in (4, 8, 32) for s in ((8, 32), (32, 64), (64, 128))
         if s[0] % W == 0 and s[1] % W == 0]


def _int_weights(seed, B, K, hi=100):
    return np.random.default_rng(seed).integers(1, hi, size=(B, K)).astype(np.float32)


@pytest.mark.parametrize("W,shape", CASES)
def test_table_equals_reference(W, shape):
    B, K = shape
    w = _int_weights(B * K + W, B, K)
    got = butterfly_table(torch.as_tensor(w), W=W).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_table(jnp.asarray(w), W=W)))
    np.testing.assert_array_equal(got, np.asarray(j_ref(jnp.asarray(w), W=W)))
    np.testing.assert_array_equal(got, butterfly_table_ref(torch.as_tensor(w), W).numpy())
    # the (G, nb, W, W) layout is repro.core's table, bit for bit
    blocks = butterfly_table(torch.as_tensor(w), W=W, layout="blocks").numpy()
    core = np.asarray(jax.jit(jb.build_butterfly_table, static_argnums=1)(
        jnp.asarray(w), W))
    np.testing.assert_array_equal(blocks, core)
    np.testing.assert_array_equal(blocks.transpose(0, 2, 1, 3).reshape(B, K), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtype_sweep(dtype):
    w = _int_weights(0, 8, 24, hi=16)
    got = butterfly_table(torch.as_tensor(w).to(dtype), W=8)
    assert got.dtype == torch.float32
    ref = np.asarray(j_ref(jnp.asarray(w), W=8))
    tol = 1e-6 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    jgot = np.asarray(j_table(jnp.asarray(w).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16), W=8))
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_running_row_carry_across_blocks():
    """Row W-1 of each of 7 blocks holds the running block sums."""
    W = 8
    w = _int_weights(1, 8, 8 * 7, hi=9)
    t = butterfly_table(torch.as_tensor(w), W=W).numpy().reshape(8, 7, 8)
    running = np.cumsum(w.reshape(8, 7, 8).sum(-1), axis=1)
    np.testing.assert_array_equal(t[W - 1], running.T)
    np.testing.assert_array_equal(t, np.asarray(j_table(jnp.asarray(w), W=W)).reshape(8, 7, 8))


def test_kernel_limits_and_device_checks():
    with pytest.raises(ValueError, match=r"\[2, 32\]"):
        K1.check_table_w(64)
    with pytest.raises(ValueError, match="power of two"):
        K1.check_table_w(12)
    assert K1.check_table_w(4) == 4
    w = torch.ones(8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_table(w, W=8, impl="cuda")
    with pytest.raises(ValueError, match="multiples"):
        butterfly_table(torch.ones(8, 12), W=8)
    with pytest.raises(ValueError, match="layout"):
        butterfly_table(w, W=8, layout="cols")
