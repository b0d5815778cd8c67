"""CPU models of the redesigned truncated-draw kernels against the
reference and the port's plain versions, on the same numpy inputs.

* ``ref.radix_topk_tau_torch`` — K9's radix select of the top-k
  threshold (four 8-bit digit histograms of the keys) — equals the
  reference's ``thresholds_from_params`` (JAX on the CPU: 32 bisection
  steps over the bit patterns) and the port's ``_topk_tau`` bit for bit:
  a count is exact in any order, and 32 steps find the exact boundary.
* ``ref.masked_blocksums_warp_order_torch`` — K11's sums in the card's
  order — equals ``masked_blocksums_torch`` bit for bit on integer
  weights (every fp32 sum exact) and within ``(W + nb) * 2**-23`` of the
  largest running sum on real weights (the tolerance the card checks
  use: two orders of W + nb fp32 additions each)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sampling import transforms as jtr
from repro_torch.kernels.butterfly_sample import kernel as KB
from repro_torch.kernels.butterfly_sample.ref import (masked_blocksums_warp_order_torch,
                                                      radix_topk_tau_torch)
from repro_torch.sampling import transforms as ttr

LIST_CAP = KB._TRUNC_LIST_CAP


def _softmax(rng, B, K):
    z = rng.normal(0.0, 4.0, (B, K)).astype(np.float32)
    return np.exp(z - z.max(axis=1, keepdims=True))


def _rows(name):
    """(w, k) for one kind of row; every row set has 4 rows."""
    rng = np.random.default_rng(ROWS.index(name))
    K = 3000
    w = _softmax(rng, 4, K)
    k = np.array([64.0, 64.0, 64.0, 64.0], np.float32)
    if name == "topk_0":
        k[:] = 0.0
        k[1] = -3.0
    elif name == "topk_1":
        k[:] = 1.0
    elif name == "topk_64":
        pass
    elif name == "topk_over_V":
        k[:] = [K + 1, 10 * K, 1e30, K]
    elif name == "non_integer_k":
        k[:] = [0.5, 2.5, 63.01, 1.0001]
    elif name == "all_equal":
        w[:] = 0.25
        w[1] = 1.0
        w[2] = 0.0
    elif name == "single_live_token":
        w[:] = 0.0
        w[np.arange(4), [0, 17, 1499, K - 1]] = [1.0, 3e-38, 0.5, 2e-38]
        k[:] = [1, 2, 64, 1]
    elif name == "neg_inf_logits":
        z = rng.normal(0.0, 4.0, (4, K)).astype(np.float32)
        z[rng.random((4, K)) < 0.7] = -np.inf
        z[3, 100:] = -np.inf
        w = np.exp(z - z.max(axis=1, keepdims=True))
        k[:] = [64, 1000, 2000, 200]
    elif name == "negative_zero":
        w[rng.random((4, K)) < 0.5] = -0.0
        w[1] = -0.0
        w[2, :10] = 1.0
        w[2, 10:] = -0.0
        k[:] = [64, 5, 30, 2999]
    elif name == "ties_over_capacity":
        w[:, : LIST_CAP + 500] = 1.0
        w[1, :] = np.where(np.arange(K) % 2 == 0, 0.5, w[1])
        k[:] = [64, 64, LIST_CAP + 100, 1]
    return w.astype(np.float32), k


ROWS = ["topk_0", "topk_1", "topk_64", "topk_over_V", "non_integer_k", "all_equal",
        "single_live_token", "neg_inf_logits", "negative_zero", "ties_over_capacity"]


def _reference_tau(w, k):
    prm = np.stack([k, np.ones_like(k), np.zeros_like(k)], axis=1)
    return np.asarray(jtr.thresholds_from_params(jnp.asarray(w), jnp.asarray(prm)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ROWS)
def test_radix_topk_tau_equals_bisection(name, dtype):
    w, k = _rows(name)
    wt = torch.as_tensor(w).to(getattr(torch, dtype))
    wf = wt.float()  # the bf16 row as the kernel reads it
    got = radix_topk_tau_torch(wt, torch.as_tensor(k))
    port = ttr._topk_tau(wf, torch.as_tensor(k), torch.zeros(4), ttr.SEARCH_ITERS)
    want = _reference_tau(wf.numpy(), k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(want))


def test_radix_topk_tau_on_subnormal_weights():
    """Subnormal weights have keys like any others.  XLA on the CPU flushes
    them to zero, so here the port's own bisection (IEEE, as the card) is
    the reference."""
    w = np.zeros((3, 500), np.float32)
    w[0, -1] = 1e-45
    w[1, ::7] = np.float32(1e-40)
    w[1, 3] = 1e-39
    w[2] = np.linspace(0, 1e-38, 500, dtype=np.float32)
    k = torch.tensor([1.0, 3.0, 100.0])
    got = radix_topk_tau_torch(torch.as_tensor(w), k)
    want = ttr._topk_tau(torch.as_tensor(w), k, torch.zeros(3), ttr.SEARCH_ITERS)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    assert _bits(got.numpy())[0] == 1


def test_radix_topk_tau_is_the_kth_largest():
    """On rows of distinct positive values, tau is the ceil(k)-th largest
    value (the sorted oracle), and the count of survivors is ceil(k)."""
    rng = np.random.default_rng(3)
    w = rng.permutation(np.linspace(1e-6, 1.0, 5000, dtype=np.float32))[None].repeat(6, 0)
    k = np.array([1, 2, 64, 999.5, 4999, 5000], np.float32)
    got = radix_topk_tau_torch(torch.as_tensor(w), torch.as_tensor(k)).numpy()
    kth = -np.sort(-w, axis=1)[np.arange(6), np.ceil(k).astype(int) - 1]
    np.testing.assert_array_equal(_bits(got), _bits(kth))
    np.testing.assert_array_equal((w >= got[:, None]).sum(1), np.ceil(k))


@pytest.mark.parametrize("W", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("B,K", [(1, 300), (8, 5000), (5, 70001)])
def test_masked_blocksums_warp_order(B, K, W):
    rng = np.random.default_rng(B * K + W)
    nb = KB.num_blocks(K, W)
    wi = torch.as_tensor(rng.integers(1, 100, (B, K)).astype(np.float32))
    tau_i = torch.as_tensor(rng.integers(0, 80, B).astype(np.float32))
    got = masked_blocksums_warp_order_torch(wi, tau_i, W, nb)
    assert got.shape == (B, nb)
    assert torch.equal(got, KB.masked_blocksums_torch(wi, tau_i, W, nb))
    ws = torch.as_tensor(_softmax(rng, B, K))
    prm = torch.tensor([[64.0, 0.95, 0.0]]).repeat(B, 1)
    tau = ttr.thresholds_from_params(ws, prm)
    for t in (tau, torch.zeros(B)):
        got = masked_blocksums_warp_order_torch(ws, t, W, nb)
        want = KB.masked_blocksums_torch(ws, t, W, nb)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=(W + nb) * 2.0 ** -23 * float(want.abs().max()))


def test_threshold_body_names_are_checked():
    w, u = torch.ones(4, 40), torch.full((4,), 0.5)
    prm = torch.tensor([[2.0, 0.9, 0.0]]).repeat(4, 1)
    with pytest.raises(ValueError, match="threshold"):
        KB._fused_trunc_draw(w, u, prm, 8, 32, None, threshold="sort")
    with pytest.raises(ValueError, match="CUDA"):
        KB._fused_trunc_draw(w, u, prm, 8, 32, None, threshold="bisect")
    # K9's scratch holds the survivor list: rows up to 56,000 columns stage
    assert KB.trunc_row_staged(56000, 438, 128)
    assert not KB.trunc_row_staged(56001, 438, 128)
