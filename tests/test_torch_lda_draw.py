"""The port's factored LDA draw (repro_torch.kernels.lda_draw) against the
reference on the CPU: the reference's Pallas kernels in interpret mode and
its XLA twin, on the same numpy inputs.

Tolerance: on integer weights every fp32 sum is exact, so indices must be
equal.  On real (Dirichlet) weights the two sum in different orders, so a
mismatch is allowed only where it is a float64-checked boundary tie
(``ref.boundary_ties``, band ``tie_tolerance(K) * total``).  bf16 inputs
may move an index by at most 1 against the fp32 oracle, as in the
reference's ``test_dtype_sweep``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.butterfly_sample import kernel as jtile
from repro.kernels.lda_draw import ops as jops
from repro.kernels.lda_draw.kernel import lda_draw_docs_pallas
from repro.kernels.lda_draw.ref import lda_draw_ref as jref
from repro_torch.kernels.butterfly_sample import kernel as ttile
from repro_torch.kernels.lda_draw import ops as tops
from repro_torch.kernels.lda_draw.kernel import lda_draw_docs
from repro_torch.kernels.lda_draw.ref import boundary_ties, lda_draw_ref

GRID_W = [8, 16, 32]
GRID_BVK = [(16, 50, 24), (32, 100, 19), (8, 40, 240), (64, 30, 7)]


def _inputs(seed, B, V, K, weights="int", C=None):
    rng = np.random.default_rng(seed)
    C = C or max(1, B // 4)
    if weights == "int":
        theta = rng.integers(1, 100, size=(C, K)).astype(np.float32)
        phi = rng.integers(1, 100, size=(V, K)).astype(np.float32)
    else:
        theta = rng.dirichlet(np.full(K, 0.3), size=C).astype(np.float32)
        phi = rng.dirichlet(np.full(V, 0.3), size=K).T.astype(np.float32).copy()
    docs = rng.integers(0, C, size=B).astype(np.int32)
    words = rng.integers(0, V, size=B).astype(np.int32)
    u = rng.uniform(0, 1, size=B).astype(np.float32)
    return theta, phi, docs, words, u


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


# ---------------------------------------------------------------------------
# Tile steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [8, 16, 32, 64])
def test_tile_steps_match_reference(W):
    rng = np.random.default_rng(W)
    TB, nb = 24, 5
    tile = rng.random((TB, W)).astype(np.float32)
    running = np.cumsum(rng.random((TB, nb)).astype(np.float32), axis=1)
    stop = (running[:, -1] * rng.random(TB).astype(np.float32)).astype(np.float32)
    # exact-match steps: same adds in the same order
    jf = np.asarray(jtile._fenwick_tile(jnp.asarray(tile), W))
    tf = ttile._fenwick_tile(torch.as_tensor(tile), W).numpy()
    np.testing.assert_array_equal(tf, jf)
    jjb, jlo = jtile._select_tile(jnp.asarray(running), jnp.asarray(stop), W)
    tjb, tlo = ttile._select_tile(torch.as_tensor(running), torch.as_tensor(stop), W)
    np.testing.assert_array_equal(tjb.numpy(), np.asarray(jjb))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    bstop = (tf[:, -1] * rng.random(TB).astype(np.float32)).astype(np.float32)
    lo = np.zeros(TB, np.float32)
    jR = np.asarray(jtile._descent_tile(jnp.asarray(jf), jnp.asarray(bstop),
                                        jnp.asarray(lo), W))
    tR = ttile._descent_tile(torch.as_tensor(tf), torch.as_tensor(bstop),
                             torch.as_tensor(lo), W).numpy()
    np.testing.assert_array_equal(tR, jR)
    u = rng.random(TB).astype(np.float32)
    np.testing.assert_array_equal(
        ttile._block_search(torch.as_tensor(running), torch.as_tensor(u)).numpy(),
        np.asarray(jtile._block_search(jnp.asarray(running), jnp.asarray(u))),
    )
    # the whole draw on an integer tile (every sum exact)
    w = rng.integers(0, 50, size=(TB, nb * W)).astype(np.float32)
    np.testing.assert_array_equal(
        ttile._draw_tile(torch.as_tensor(w), torch.as_tensor(u), W).numpy(),
        np.asarray(jtile._draw_tile(jnp.asarray(w), jnp.asarray(u), W)),
    )


# ---------------------------------------------------------------------------
# Draws against the reference's kernels and XLA twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("B,V,K", GRID_BVK)
def test_factored_draws_match_reference(W, B, V, K):
    theta, phi, docs, words, u = _inputs(B + V + K + W, B, V, K)
    jt, jp, jd, jw, ju = _j(theta, phi, docs, words, u)
    tt, tp, td, tw, tu = _t(theta, phi, docs, words, u)
    got = tops.lda_draw_factored(tt, tp, td, tw, tu, W=W).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(lda_draw_docs_pallas(jt, jp, jd, jw, ju, W=W, interpret=True))
    )
    np.testing.assert_array_equal(
        got, np.asarray(jops.lda_draw_factored(jt, jp, jd, jw, ju, W=W, impl="xla"))
    )
    # the legacy one-theta-row-per-sample signature, against both oracles
    th_rows = theta[docs]
    legacy = tops.lda_draw(torch.as_tensor(th_rows), tp, tw, tu, W=W).numpy()
    np.testing.assert_array_equal(
        legacy, np.asarray(jref(jnp.asarray(th_rows), jp, jw, ju))
    )
    np.testing.assert_array_equal(
        legacy, lda_draw_ref(torch.as_tensor(th_rows), tp, tw, tu).numpy()
    )
    # both routes of the port return the same indices
    np.testing.assert_array_equal(
        lda_draw_docs(tt, tp, td, tw, tu, W, route="two_pass").numpy(), got
    )


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("B,V,K", GRID_BVK)
def test_table_in_draws_match_reference(W, B, V, K):
    theta, phi, docs, words, u = _inputs(7 * B + V + K + W, B, V, K)
    S = 3
    us = np.random.default_rng(K).uniform(0, 1, size=(S, B)).astype(np.float32)
    jt, jp, jd, jw, ju, jus = _j(theta, phi, docs, words, u, us)
    tt, tp, td, tw, tu, tus = _t(theta, phi, docs, words, u, us)
    th_, ph_, run = tops.lda_build_running(tt, tp, td, tw, W=W)
    # interpret mode costs ~0.4 s a call: the Pallas form on one W of the grid
    impls = [("xla", {})] + ([("pallas", {"interpret": True})] if W == 16 else [])
    for impl, extra in impls:
        jtp, jpp, jrun = jops.lda_build_running(jt, jp, jd, jw, W=W, impl=impl, **extra)
        np.testing.assert_array_equal(run.numpy(), np.asarray(jrun))
        for uu, tuu in ((ju, tu), (jus, tus)):
            ref = jops.lda_draw_from_running(jtp, jpp, jrun, uu, jd, jw, K=K, W=W,
                                             impl=impl, **extra)
            got = tops.lda_draw_from_running(th_, ph_, run, tuu, td, tw, K=K, W=W)
            assert tuple(got.shape) == tuple(ref.shape)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# each shape of the grid once, W cycling through the grid's widths
@pytest.mark.parametrize("W,B,V,K", [(w, *bvk) for w, bvk in zip([8, 16, 32, 8], GRID_BVK)])
def test_rng_forms_match_reference(W, B, V, K):
    theta, phi, docs, words, _ = _inputs(3 * B + V + K + W, B, V, K)
    seed = np.array([7, B * 1000 + K], np.uint32)
    jt, jp, jd, jw = _j(theta, phi, docs, words)
    tt, tp, td, tw = _t(theta, phi, docs, words)
    got = tops.lda_draw_factored_rng(tt, tp, td, tw, seed, row_offset=5, W=W)
    th_, ph_, run = tops.lda_build_running(tt, tp, td, tw, W=W)
    got4 = tops.lda_draw_from_running_rng(th_, ph_, run, seed, td, tw, K=K, S=4,
                                          row_offset=5, W=W)
    # interpret mode costs ~0.4 s a call: the Pallas form on one W of the grid
    impls = [("xla", {})] + ([("pallas", {"interpret": True})] if K > 20 else [])
    for impl, extra in impls:
        ref = jops.lda_draw_factored_rng(jt, jp, jd, jw, jnp.asarray(seed), 5, W=W,
                                         impl=impl, **extra)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        jtp, jpp, jrun = jops.lda_build_running(jt, jp, jd, jw, W=W, impl=impl, **extra)
        ref4 = jops.lda_draw_from_running_rng(jtp, jpp, jrun, jnp.asarray(seed), jd, jw,
                                              K=K, S=4, row_offset=5, W=W,
                                              impl=impl, **extra)
        np.testing.assert_array_equal(got4.numpy(), np.asarray(ref4))


def test_bf16_within_one_of_fp32_oracle():
    rng = np.random.default_rng(5)
    B, V, K, C = 24, 60, 32, 6
    theta = rng.integers(1, 16, size=(C, K)).astype(np.float32)
    phi = rng.integers(1, 16, size=(V, K)).astype(np.float32)
    docs = rng.integers(0, C, size=B).astype(np.int32)
    words = rng.integers(0, V, size=B).astype(np.int32)
    u = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    tt, tp = (torch.as_tensor(x).to(torch.bfloat16) for x in (theta, phi))
    got = tops.lda_draw_factored(tt, tp, *_t(docs, words, u), W=8).numpy()
    jt, jp = (jnp.asarray(x).astype(jnp.bfloat16) for x in (theta, phi))
    jd, jw, ju = _j(docs, words, u)
    np.testing.assert_array_equal(
        got, np.asarray(lda_draw_docs_pallas(jt, jp, jd, jw, ju, W=8, interpret=True))
    )
    ref = np.asarray(jref(jnp.asarray(theta[docs]), jnp.asarray(phi), jw, ju))
    assert (np.abs(got - ref) <= 1).all()


@pytest.mark.parametrize("W", GRID_W)
def test_real_weights_mismatch_only_at_ties(W):
    """Dirichlet weights at the main path's K: every mismatch against the
    reference must be a float64-checked boundary tie (counted; expected
    to be rare, asserted below 1% of draws)."""
    B, V, K = 4096, 300, 240
    theta, phi, docs, words, u = _inputs(100 + W, B, V, K, weights="dirichlet", C=64)
    jt, jp, jd, jw, ju = _j(theta, phi, docs, words, u)
    tt, tp, td, tw, tu = _t(theta, phi, docs, words, u)
    got = tops.lda_draw_factored(tt, tp, td, tw, tu, W=W)
    ref = np.asarray(jops.lda_draw_factored(jt, jp, jd, jw, ju, W=W, impl="xla"))
    res = boundary_ties(got, ref, tt, tp, td, tw, tu)
    assert res["faults"] == 0, res
    assert res["mismatches"] <= B // 100, res


def test_boundary_ties_flags_a_real_fault():
    theta, phi, docs, words, u = _inputs(1, 64, 30, 24, weights="dirichlet", C=8)
    tt, tp, td, tw, tu = _t(theta, phi, docs, words, u)
    good = tops.lda_draw_factored(tt, tp, td, tw, tu, W=8)
    bad = good.clone()
    bad[3] = (bad[3] + 5) % 24
    assert boundary_ties(good, good, tt, tp, td, tw, tu)["mismatches"] == 0
    assert boundary_ties(good, bad, tt, tp, td, tw, tu)["faults"] == 1


# ---------------------------------------------------------------------------
# Edge cases and the device policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [8, 32])
def test_all_zero_rows_draw_in_range(W):
    theta, phi, docs, words, u = _inputs(11, 32, 40, 19)
    theta[docs[:8]] = 0.0                     # the padded rows of a last chunk
    tt, tp, td, tw, tu = _t(theta, phi, docs, words, u)
    got = tops.lda_draw_factored(tt, tp, td, tw, tu, W=W).numpy()
    assert ((got >= 0) & (got < 19)).all()
    ref = lda_draw_docs_pallas(*_j(theta, phi, docs, words, u), W=W, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    _, _, run = tops.lda_build_running(tt, tp, td, tw, W=W)
    assert torch.isfinite(run).all()


def test_impl_cuda_on_cpu_raises_and_w_is_checked():
    theta, phi, docs, words, u = _t(*_inputs(0, 8, 10, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.lda_draw_factored(theta, phi, docs, words, u, W=8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.lda_build_running(theta, phi, docs, words, W=8, impl="cuda")
    for W in (4, 12, 256):
        with pytest.raises(ValueError, match="power of two"):
            tops.lda_draw_factored(theta, phi, docs, words, u, W=W)


def test_runtime_defaults_match_reference():
    """The port's tile defaults and ``default_w`` are the reference's, so
    ``W=None`` resolves to the same block width (K=240 gives 16)."""
    from repro.autotune import cost_model
    from repro.kernels import runtime as jrt
    from repro_torch.kernels import runtime as trt

    for K in (7, 16, 64, 65, 240, 1000, 4096, 50000):
        assert trt.default_w(K) == cost_model.default_w(K), K
        for W in (8, 16, 32, 128):
            assert trt.default_tk(K, W) == jrt.default_tk(K, W), (K, W)
    for B in (1, 1023, 1024, 27392):
        assert trt.default_tb(B) == jrt.default_tb(B)
    assert trt.default_w(240) == 16
