"""The port's truncation transforms (repro_torch.sampling.transforms) and
sorted oracle (repro_torch.sampling.reference) against the reference's, on
the same numpy inputs.

Tolerance: the top-k and min-p thresholds are equal bit for bit (a count
and a product, exact in any order).  A top-p threshold compares a float32
masked sum with p * total; PyTorch and XLA sum in different orders, so a
row may differ only where both taus lie in the float64 oracle's range of
the taus that fp32 rounding of those sums allows (``trunc_tau64``).  Those
rows are counted and expected to be 0 at these seeds.  Masks follow from
the thresholds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.sampling import reference as jref
from repro.sampling import transforms as jtr
from repro_torch.kernels.butterfly_sample.ref import (cuda_sum_depth, trunc_boundary_ties,
                                                      trunc_tau64)
from repro_torch.sampling import reference as tref
from repro_torch.sampling import transforms as ttr

KS = (8, 257, 4096)


def _grid(K):
    return [
        ("topk", dict(top_k=max(2, K // 3))),
        ("topp", dict(top_p=0.7)),
        ("minp", dict(min_p=0.05)),
        ("kpm", dict(top_k=max(4, K // 2), top_p=0.9, min_p=0.01)),
    ]


def _params(kw, B):
    return np.stack([np.full(B, kw.get("top_k", 0), np.float32),
                     np.full(B, kw.get("top_p", 1.0), np.float32),
                     np.full(B, kw.get("min_p", 0.0), np.float32)], axis=1)


def _tau_ties(w, prm, got, want):
    """Rows whose taus differ, and which of them are float64-confirmed
    top-p boundary ties: both taus in the oracle's range."""
    _, lo, hi = trunc_tau64(w, prm)
    lo, hi = lo.numpy(), hi.numpy()
    diff = got != want
    tie = diff & (lo <= got) & (got <= hi) & (lo <= want) & (want <= hi)
    return diff, tie


def _check_tau(w, kw, got, want):
    """Equal taus, except float64-confirmed top-p boundary rows."""
    diff, tie = _tau_ties(w, _params(kw, w.shape[0]), got, want)
    assert not (diff & ~tie).any(), np.nonzero(diff)
    assert int(diff.sum()) == 0, f"{int(diff.sum())} top-p boundary ties"


@pytest.mark.parametrize("K", KS)
def test_thresholds_and_masks_match_reference(K):
    rng = np.random.default_rng(K)
    w = rng.uniform(0.01, 1.0, (24, K)).astype(np.float32)
    for name, kw in _grid(K):
        got = ttr.thresholds(torch.as_tensor(w), ttr.chain(**kw)).numpy()
        want = np.asarray(jtr.thresholds(jnp.asarray(w), jtr.chain(**kw)))
        _check_tau(w, kw, got, want)
        mask = ttr.apply(torch.as_tensor(w), ttr.chain(**kw)).numpy() > 0
        np.testing.assert_array_equal(mask, np.asarray(jtr.apply(jnp.asarray(w),
                                                                 jtr.chain(**kw))) > 0)
        oracle = tref.sorted_mask(torch.as_tensor(w), ttr.chain(**kw)).numpy()
        np.testing.assert_array_equal(oracle, np.asarray(
            jref.sorted_mask(jnp.asarray(w), jtr.chain(**kw))), err_msg=name)
        np.testing.assert_array_equal(mask, oracle, err_msg=name)


def test_peaked_softmax_weights():
    """Twelve orders of magnitude of dynamic range (the reference's
    peaked-softmax case), weights made once by the reference."""
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 4.0, (16, 4096)).astype(np.float32)
    w = np.asarray(jsampling.logits_to_weights(jnp.asarray(logits), 0.7))
    for name, kw in _grid(4096):
        got = ttr.thresholds(torch.as_tensor(w), ttr.chain(**kw)).numpy()
        want = np.asarray(jtr.thresholds(jnp.asarray(w), jtr.chain(**kw)))
        _check_tau(w, kw, got, want)
        np.testing.assert_array_equal(
            tref.sorted_mask(torch.as_tensor(w), ttr.chain(**kw)).numpy(),
            ttr.apply(torch.as_tensor(w), ttr.chain(**kw)).numpy() > 0, err_msg=name)


def test_per_row_params_from_params_block():
    """Heterogeneous (k, p, min_p) rows, with rows that disable a stage,
    through thresholds_from_params (the two-pass route's tau)."""
    rng = np.random.default_rng(11)
    B, K = 48, 256
    w = np.asarray(jsampling.logits_to_weights(
        jnp.asarray(rng.normal(0, 2.0, (B, K)).astype(np.float32))))
    prm = np.stack([rng.integers(1, 30, B), rng.uniform(0.5, 1.0, B),
                    rng.uniform(0.0, 0.05, B)], axis=1).astype(np.float32)
    prm[0::4, 0] = 0.0
    prm[1::4, 1] = 1.0
    prm[2::4, 2] = 0.0
    got = ttr.thresholds_from_params(torch.as_tensor(w), torch.as_tensor(prm)).numpy()
    want = np.asarray(jtr.thresholds_from_params(jnp.asarray(w), jnp.asarray(prm)))
    diff, tie = _tau_ties(w, prm, got, want)
    assert not (diff & ~tie).any() and int(diff.sum()) == 0
    chain = ttr.chain(top_k=torch.as_tensor(prm[:, 0]), top_p=torch.as_tensor(prm[:, 1]),
                      min_p=torch.as_tensor(prm[:, 2]))
    np.testing.assert_array_equal(ttr.thresholds(torch.as_tensor(w), chain).numpy(), got)
    kept = ttr.apply(torch.as_tensor(w), chain).numpy() > 0
    assert (kept.sum(1)[prm[:, 0] > 0] <= prm[prm[:, 0] > 0, 0]).all()


def test_sequential_composition_and_disabled_stages():
    w = torch.tensor([[0.4, 0.3, 0.2, 0.05, 0.03, 0.02]])
    mask = ttr.apply(w, ttr.chain(top_k=3, top_p=0.5))[0] > 0
    assert mask.tolist() == [True, True, False, False, False, False]
    assert (tref.sorted_mask(w, ttr.chain(top_k=3, top_p=0.5))[0] == mask).all()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.1, 1.0, (6, 33)).astype(np.float32))
    assert ttr.chain(top_k=0, top_p=1.0, min_p=0.0) == ()
    assert torch.equal(ttr.apply(x, ()), x)
    prm = torch.tensor([[0.0, 1.0, 0.0]]).repeat(6, 1)
    assert torch.equal(ttr.thresholds_from_params(x, prm), torch.zeros(6))
    # tensor parameters are kept even when they disable (per-row decides)
    assert len(ttr.chain(top_k=torch.zeros(6), top_p=torch.ones(6))) == 2


def test_signature_canonical_params_and_validation():
    assert ttr.signature(ttr.chain(top_k=5, top_p=0.9, min_p=0.1)) == "kpm"
    assert ttr.signature(ttr.chain(temperature=0.5, top_p=0.9)) == "tp"
    assert ttr.signature(None) == "" == jtr.signature(None)
    kpm = ttr.canonical_params(ttr.chain(top_p=0.9), B=4)
    np.testing.assert_array_equal(
        kpm.numpy(), np.asarray(jtr.canonical_params(jtr.chain(top_p=0.9), B=4)))
    assert ttr.canonical_params((ttr.TopP(0.9), ttr.TopK(5)), B=4) is None
    with pytest.raises(ValueError, match="Temperature"):
        ttr.thresholds(torch.ones(2, 8), (ttr.Temperature(0.5),))
    with pytest.raises(ValueError, match="unknown transform"):
        ttr.validate(("top_k",))
    with pytest.raises(ValueError, match="per-row"):
        ttr.thresholds(torch.ones(2, 8), (ttr.TopK(torch.ones(3)),))
    # a non-canonical chain still truncates sequentially
    rng = np.random.default_rng(1)
    w = rng.uniform(0.01, 1.0, (8, 64)).astype(np.float32)
    got = ttr.apply(torch.as_tensor(w), (ttr.TopP(0.9), ttr.TopK(5))).numpy() > 0
    want = np.asarray(jtr.apply(jnp.asarray(w), (jtr.TopP(0.9), jtr.TopK(5)))) > 0
    np.testing.assert_array_equal(got, want)


def test_temperature_and_apply_to_logits():
    rng = np.random.default_rng(3)
    B, K = 12, 300
    logits = rng.normal(0, 3.0, (B, K)).astype(np.float32)
    temps = rng.uniform(0.5, 1.5, B).astype(np.float32)
    chain = ttr.chain(temperature=torch.as_tensor(temps), top_k=40, top_p=0.8)
    jchain = jtr.chain(temperature=jnp.asarray(temps), top_k=40, top_p=0.8)
    t = ttr.temperature_of(chain, 2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jtr.temperature_of(jchain, 2.0)))
    assert ttr.temperature_of((), 0.5) == 0.5
    got = ttr.apply_to_logits(chain, torch.as_tensor(logits), 2.0).numpy()
    want = np.asarray(jtr.apply_to_logits(jchain, jnp.asarray(logits), 2.0))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)


def test_sorted_oracle_draws_match_reference():
    rng = np.random.default_rng(5)
    B, K = 16, 200
    w = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    u = rng.uniform(0, 1, B).astype(np.float32)
    chain_kw = dict(top_k=50, top_p=0.8, min_p=0.02)
    np.testing.assert_array_equal(
        tref.truncate_sorted(torch.as_tensor(w), ttr.chain(**chain_kw)).numpy(),
        np.asarray(jref.truncate_sorted(jnp.asarray(w), jtr.chain(**chain_kw))))
    np.testing.assert_allclose(
        tref.truncated_probs(torch.as_tensor(w), ttr.chain(**chain_kw)).numpy(),
        np.asarray(jref.truncated_probs(jnp.asarray(w), jtr.chain(**chain_kw))),
        rtol=K * 2.0 ** -23)
    got = tref.draw_truncated_sorted(torch.as_tensor(w), torch.as_tensor(u),
                                     ttr.chain(**chain_kw)).numpy()
    want = np.asarray(jref.draw_truncated_sorted(jnp.asarray(w), jnp.asarray(u),
                                                 jtr.chain(**chain_kw)))
    np.testing.assert_array_equal(got, want)


def test_tau_oracle_range_is_tight():
    """The float64 oracle's tau range (sums as deep as on the card) holds
    the exact tau and the port's, spans few values of a long real-weight
    row (the sequential-sum bound of K additions spans about 300 there),
    is one tau on integer rows, and a draw made with a wrong top-p tau is
    a fault, not a tie."""
    rng = np.random.default_rng(5)
    B, K = 4, 65536
    z = rng.normal(0, 4.0, (B, K))
    w = np.exp(z - z.max(axis=1, keepdims=True)).astype(np.float32)
    prm = np.tile(np.float32([0.0, 0.95, 0.0]), (B, 1))
    tau, lo, hi = trunc_tau64(w, prm, depth=cuda_sum_depth(K))
    got = ttr.thresholds_from_params(torch.as_tensor(w), torch.as_tensor(prm)).double()
    assert ((lo <= tau) & (tau <= hi) & (lo <= got) & (got <= hi)).all()
    wt = torch.as_tensor(w)
    span = ((wt.double() >= lo[:, None]) & (wt.double() <= hi[:, None])).sum(1)
    assert (span <= 16).all(), span
    # top-p 0.5 in place of 0.95: the same u draws from a shorter row
    u = torch.full((B,), 0.9)
    good = tref.draw_truncated_sorted(wt, u, ttr.chain(top_p=0.95))
    bad = tref.draw_truncated_sorted(wt, u, ttr.chain(top_p=0.5))
    res = trunc_boundary_ties(bad, good, w, u, prm, depth=cuda_sum_depth(K))
    assert res["mismatches"] > 0 and res["faults"] == res["mismatches"], res
    wi = rng.integers(1, 100, (B, 512)).astype(np.float32)
    tau_i, lo_i, hi_i = trunc_tau64(wi, np.tile(np.float32([10.0, 0.7, 0.0]), (B, 1)))
    assert torch.equal(lo_i, tau_i) and torch.equal(hi_i, tau_i)
