"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a GPU and nvcc every test here skips with
its reason (decided in the fixture, never at import).  On the H100 run
them with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance: integer weights keep every fp32 sum exact, so kernel and plain
indices and running sums must be equal; on Dirichlet weights a mismatch
must be a float64-checked boundary tie (``ref.boundary_ties``)."""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import runtime
from repro_torch.kernels.lda_draw import kernel as K
from repro_torch.kernels.lda_draw import ops
from repro_torch.kernels.lda_draw.ref import boundary_ties

pytestmark = pytest.mark.cuda

GRID_W = [8, 16, 32, 64, 128]
GRID_BVK = [(16, 50, 24), (32, 100, 19), (8, 40, 240), (64, 30, 7), (4099, 500, 240)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _inputs(dev, seed, B, V, Kc, weights="int", dtype=torch.float32):
    g = np.random.default_rng(seed)
    C = max(1, B // 16)
    if weights == "int":
        th = g.integers(1, 100, size=(C, Kc)).astype(np.float32)
        ph = g.integers(1, 100, size=(V, Kc)).astype(np.float32)
    else:
        th = g.dirichlet(np.full(Kc, 0.3), size=C).astype(np.float32)
        ph = g.dirichlet(np.full(V, 0.3), size=Kc).T.astype(np.float32).copy()
    d = g.integers(0, C, size=B).astype(np.int32)
    w = g.integers(0, V, size=B).astype(np.int32)
    u = g.uniform(0, 1, size=B).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return t(th).to(dtype), t(ph).to(dtype), t(d), t(w), t(u)


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("B,V,Kc", GRID_BVK)
def test_kernels_equal_plain_on_integer_weights(dev, W, B, V, Kc):
    th, ph, d, w, u = _inputs(dev, B + V + Kc + W, B, V, Kc)
    for route in ("fused", "two_pass"):
        got = K.lda_draw_docs(th, ph, d, w, u, W, route=route)
        want = K.lda_draw_docs(th, ph, d, w, u, W, impl="torch")
        torch.cuda.synchronize()
        assert torch.equal(got, want), route
    _, _, run = ops.lda_build_running(th, ph, d, w, W=W)
    _, _, run_p = ops.lda_build_running(th, ph, d, w, W=W, impl="torch")
    assert torch.equal(run, run_p)
    us = torch.rand((4, B), device=dev)
    got = ops.lda_draw_from_running(th, ph, run, us, d, w, K=Kc, W=W)
    want = ops.lda_draw_from_running(th, ph, run_p, us, d, w, K=Kc, W=W, impl="torch")
    assert torch.equal(got, want)


@pytest.mark.parametrize("W", [16, 32])
def test_kernels_ties_only_on_real_weights(dev, W):
    th, ph, d, w, u = _inputs(dev, W, 27392, 37286, 240, weights="dirichlet")
    got = ops.lda_draw_factored(th, ph, d, w, u, W=W)
    want = ops.lda_draw_factored(th, ph, d, w, u, W=W, impl="torch")
    res = boundary_ties(got, want, th, ph, d, w, u)
    assert res["faults"] == 0, res


def test_bf16_and_zero_rows(dev):
    th, ph, d, w, u = _inputs(dev, 3, 1000, 300, 240, dtype=torch.bfloat16)
    th[: th.shape[0] // 2] = 0
    got = ops.lda_draw_factored(th, ph, d, w, u, W=32)
    want = ops.lda_draw_factored(th, ph, d, w, u, W=32, impl="torch")
    assert torch.equal(got, want)
    assert int(got.min()) >= 0 and int(got.max()) < 240


def test_launch_counts_and_checks(dev):
    th, ph, d, w, u = _inputs(dev, 5, 64, 30, 24)
    K.reset_launches()
    ops.lda_draw_factored(th, ph, d, w, u, W=8)
    assert K.LAUNCHES == {"lda_fused_draw": 1, "lda_blocksums": 0, "lda_walk": 0}
    with pytest.raises(ValueError):
        K.lda_fused_draw(th, ph, d.long(), w, u, 8)        # wrong id dtype
    with pytest.raises(ValueError):
        K.lda_fused_draw(th.cpu(), ph.cpu(), d.cpu(), w.cpu(), u.cpu(), 8)
    assert K.LAUNCHES["lda_fused_draw"] == 1


def test_missing_compiler_raises(dev, monkeypatch, tmp_path):
    """A CUDA call whose kernel library cannot be built raises: no fallback."""
    th, ph, d, w, u = _inputs(dev, 6, 64, 30, 24)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_NVCC_FALLBACK", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.lda_draw_factored(th, ph, d, w, u, W=8, impl="cuda")


# ---------------------------------------------------------------------------
# K1 (butterfly table) and K2, K3, K4 (draws on given weights)
# ---------------------------------------------------------------------------

from repro_torch.kernels.butterfly_sample import kernel as KB  # noqa: E402
from repro_torch.kernels.butterfly_sample import ops as bops  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import (  # noqa: E402
    boundary_ties as weight_ties,
)
from repro_torch.kernels.butterfly_table import kernel as KT  # noqa: E402
from repro_torch.kernels.butterfly_table import butterfly_table  # noqa: E402

GRID_BK = [(5, 17), (24, 300), (3, 2000), (1000, 240), (64, 4099)]
_NO_LAUNCHES = {k: 0 for k in KB.LAUNCHES}


def _weights(dev, seed, B, K, kind="int", dtype=torch.float32):
    g = np.random.default_rng(seed)
    if kind == "int":
        w = g.integers(1, 100, size=(B, K)).astype(np.float32)
    else:
        w = g.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)
    u = g.uniform(0, 1, size=B).astype(np.float32)
    return torch.as_tensor(w, device=dev).to(dtype), torch.as_tensor(u, device=dev)


@pytest.mark.parametrize("W", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["rows", "blocks"])
def test_butterfly_table_equals_plain(dev, W, layout):
    """Integer weights: equal bit for bit.  Dirichlet weights: equal except
    the running row, whose carry order may differ from torch.cumsum's."""
    for kind in ("int", "dirichlet"):
        w, _ = _weights(dev, W, 64 * W, 8 * W, kind)
        got = butterfly_table(w, W=W, layout=layout)
        want = butterfly_table(w, W=W, layout=layout, impl="torch")
        torch.cuda.synchronize()
        if kind == "int":
            assert torch.equal(got, want)
        g4, w4 = (t.reshape(-1, W, W) if layout == "blocks" else
                  t.reshape(64, W, 8, W).transpose(1, 2).reshape(-1, W, W)
                  for t in (got, want))
        assert torch.equal(g4[:, : W - 1], w4[:, : W - 1])
        torch.testing.assert_close(g4[:, W - 1], w4[:, W - 1], rtol=8 * 2.0 ** -23, atol=0)
    wb, _ = _weights(dev, W + 1, 64 * W, 8 * W, dtype=torch.bfloat16)
    assert torch.equal(butterfly_table(wb, W=W), butterfly_table(wb, W=W, impl="torch"))
    with pytest.raises(ValueError, match="128"):
        butterfly_table(torch.ones(256, 256, device=dev), W=256)


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("B,K", GRID_BK)
def test_given_weight_kernels_equal_plain_on_integer_weights(dev, W, B, K):
    w, u = _weights(dev, B + K + W, B, K)
    want = bops.butterfly_sample(w, u, W=W, impl="torch")
    for route in ("fused", "two_pass"):
        got = bops.butterfly_sample(w, u, W=W, route=route)
        torch.cuda.synchronize()
        assert torch.equal(got, want), route
    _, run = bops.build_block_sums(w, W=W)
    _, run_p = bops.build_block_sums(w, W=W, impl="torch")
    assert torch.equal(run, run_p)
    us = torch.rand((4, B), device=dev)
    got = bops.butterfly_sample_from_sums(w, run, us, K=K, W=W)
    assert torch.equal(got, bops.butterfly_sample_from_sums(w, run_p, us, K=K, W=W,
                                                            impl="torch"))


@pytest.mark.parametrize("W", [16, 32])
def test_given_weight_kernels_ties_only_on_real_weights(dev, W):
    w, u = _weights(dev, W, 27392, 240, "dirichlet")
    for route in ("fused", "two_pass"):
        got = bops.butterfly_sample(w, u, W=W, route=route)
        want = bops.butterfly_sample(w, u, W=W, impl="torch")
        res = weight_ties(got, want, w, u)
        assert res["faults"] == 0, (route, res)


def test_given_weight_bf16_zero_rows_and_route_switch(dev):
    w, u = _weights(dev, 3, 1000, 300, dtype=torch.bfloat16)
    w[::4] = 0
    for route in ("fused", "two_pass"):
        got = bops.butterfly_sample(w, u, W=32, route=route)
        assert torch.equal(got, bops.butterfly_sample(w, u, W=32, impl="torch"))
        assert (got[::4] == 299).all()
    # K = 32,000 at W = 128: the switch picks the fused kernel (nb + W
    # floats per warp); the forced two-pass route gives the same indices
    w, u = _weights(dev, 4, 64, 32000, "dirichlet")
    assert KB.fused_fits(KB.num_blocks(32000, 128), 128)
    KB.reset_launches()
    fused = bops.butterfly_sample(w, u, W=128)
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_draw": 1}
    assert torch.equal(fused, bops.butterfly_sample(w, u, W=128, route="two_pass"))
    res = weight_ties(fused, bops.butterfly_sample(w, u, W=128, impl="torch"), w, u)
    assert res["faults"] == 0, res


def test_given_weight_launch_counts_and_checks(dev):
    w, u = _weights(dev, 5, 64, 240)
    KB.reset_launches()
    KT.reset_launches()
    bops.butterfly_sample(w, u, W=16)
    wp, run = bops.build_block_sums(w, W=16)
    bops.butterfly_sample_from_sums_rng(wp, run, np.array([1, 2], np.uint32), B=64,
                                        K=240, S=3, W=16)
    butterfly_table(w, W=16)
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "blocksums": 1, "walk": 1, "fused_draw": 1}
    assert KT.LAUNCHES == {"butterfly_table": 1}
    with pytest.raises(ValueError):
        KB.walk(w, run, u, torch.arange(64, device=dev), 16)   # int64 rows
    with pytest.raises(ValueError):
        KB.fused_draw(w.cpu(), u.cpu(), 16)
    assert KB.LAUNCHES["walk"] == 1 and KB.LAUNCHES["fused_draw"] == 1


def test_sweep_methods_launch_once_per_chunk(dev):
    from repro_torch.lda import gibbs, synthesize_corpus

    corpus = synthesize_corpus(seed=0, M=96, V=120, K=8, avg_len=40, max_len=80)
    state = gibbs.init_state(0, corpus, 8, device=dev)
    KB.reset_launches()
    KT.reset_launches()
    state = gibbs.gibbs_step(state, corpus, method="butterfly", W=8, chunk=40)
    state = gibbs.gibbs_step(state, corpus, method="kernel", W=8, chunk=40)
    assert KT.LAUNCHES["butterfly_table"] == 3
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "blocksums": 3, "walk": 3}
    assert 0 <= int(state.z.min()) and int(state.z.max()) < 8



# ---------------------------------------------------------------------------
# K9, K11, K12 (truncated draws), K13 (alias assembly) and the sampling API
# ---------------------------------------------------------------------------

from repro_torch import sampling  # noqa: E402
from repro_torch.core import butterfly as bfly  # noqa: E402
from repro_torch.kernels.alias_build import kernel as KA  # noqa: E402
from repro_torch.kernels.alias_build import ops as aops  # noqa: E402
from repro_torch.kernels.alias_build import ref as alias_ref  # noqa: E402
from repro_torch.kernels.alias_build.ref import prob_tolerance, table_mass  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import (  # noqa: E402
    cuda_sum_depth, masked_blocksums_warp_order_torch, trunc_boundary_ties)
from repro_torch.sampling import transforms as tr  # noqa: E402

TRUNC_BK = [(24, 300), (8, 20000), (8, 100000), (64, 256000)]


def _trunc_inputs(dev, seed, B, K, kind, dtype=torch.float32):
    """Integer or peaked-softmax weights, per-row params with row r % 4
    disabling top-k, top-p, min-p or all three, and u."""
    g = np.random.default_rng(seed)
    if kind == "int":
        w = g.integers(1, 100, (B, K)).astype(np.float32)
    else:
        z = g.normal(0, 4.0, (B, K)).astype(np.float32)
        w = np.exp(z - z.max(axis=1, keepdims=True))
    prm = np.stack([g.integers(1, 200, B), g.uniform(0.5, 1.0, B),
                    g.uniform(0.0, 0.05, B)], axis=1).astype(np.float32)
    r = np.arange(B) % 4
    prm[(r == 0) | (r == 3), 0] = 0.0
    prm[(r == 1) | (r == 3), 1] = 1.0
    prm[(r == 2) | (r == 3), 2] = 0.0
    u = g.uniform(0, 1, B).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return t(w).to(dtype), t(prm), t(u)


@pytest.mark.parametrize("kind", ["int", "softmax"])
@pytest.mark.parametrize("B,K", TRUNC_BK)
def test_truncated_kernels_equal_plain(dev, B, K, kind):
    """K9 (staged and L2-read rows), K11 and K12 (S=1 and S=4) and both
    routes against the plain versions: equal on integer weights, float64
    ties only on real weights."""
    w, prm, u = _trunc_inputs(dev, B + K, B, K, kind)
    W = runtime.default_w(K)
    nb = KB.num_blocks(K, W)
    exact = kind == "int"
    got = KB.fused_trunc_draw(w, u, prm, W)
    want = KB.fused_trunc_draw_torch(w, u, prm, W)
    res = trunc_boundary_ties(got, want, w, u, prm, depth=cuda_sum_depth(K))
    assert res["faults"] == 0 and (not exact or res["mismatches"] == 0), res
    tau = tr.thresholds_from_params(w, prm).contiguous()
    run = KB.masked_blocksums(w, tau, W, nb)
    run_p = KB.masked_blocksums_torch(w, tau, W, nb)
    if exact:
        assert torch.equal(run, run_p)
    torch.testing.assert_close(run, run_p, rtol=(W + nb) * 2.0 ** -23, atol=0)
    wm = torch.where(w >= tau[:, None], w, 0.0)
    for S in (1, 4):
        us = torch.rand((S, B), device=dev)
        rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
        a = KB.walk_trunc(w, run, us.reshape(-1), tau, rows, W)
        b = KB.walk_trunc_torch(w, run, us.reshape(-1), tau, rows, W)
        res = weight_ties(a, b, wm, us.reshape(-1))
        assert res["faults"] == 0 and (not exact or res["mismatches"] == 0), res
        two = bops.butterfly_sample_truncated(w, us, prm, W=W)
        assert two.shape == (S, B)
    fused = bops.butterfly_sample_truncated(w, u, prm, W=W, route="fused")
    two = bops.butterfly_sample_truncated(w, u, prm, W=W, route="two_pass")
    res = trunc_boundary_ties(fused, two, w, u, prm, depth=cuda_sum_depth(K))
    assert res["faults"] == 0 and (not exact or res["mismatches"] == 0), res


def test_truncated_bf16_zero_rows(dev):
    w, prm, u = _trunc_inputs(dev, 9, 16, 50000, "int", torch.bfloat16)
    w[::3] = 0
    for route in ("fused", "two_pass"):
        got = bops.butterfly_sample_truncated(w, u, prm, W=128, route=route)
        want = bops.butterfly_sample_truncated(w, u, prm, W=128, route=route, impl="torch")
        assert torch.equal(got, want), route
        assert (got[::3] == 49999).all()


def test_truncated_launch_counts_and_checks(dev):
    w, prm, u = _trunc_inputs(dev, 5, 8, 3000, "softmax")
    KB.reset_launches()
    bops.butterfly_sample_truncated(w, u, prm, W=64)
    bops.butterfly_sample_truncated(w, torch.rand((3, 8), device=dev), prm, W=64)
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_trunc_draw": 1, "masked_blocksums": 1,
                           "walk_trunc": 1}
    with pytest.raises(ValueError, match="params"):
        KB.fused_trunc_draw(w, u, prm.double(), 64)
    with pytest.raises(ValueError, match="tau"):
        KB.masked_blocksums(w, torch.zeros(8, device=dev, dtype=torch.float64), 64, 47)
    with pytest.raises(ValueError, match="rows"):
        KB.walk_trunc(w, torch.zeros((8, 47), device=dev), u, torch.zeros(8, device=dev),
                      torch.arange(8, device=dev), 64)
    with pytest.raises(ValueError, match="CUDA"):
        KB.fused_trunc_draw(w.cpu(), u.cpu(), prm.cpu(), 64)
    assert KB.LAUNCHES["fused_trunc_draw"] == 1
    # the row staged in shared memory or read from L2: the same draws
    assert torch.equal(KB._fused_trunc_draw(w, u, prm, 64, 32, True),
                       KB._fused_trunc_draw(w, u, prm, 64, 32, False))
    wl, pl, ul = _trunc_inputs(dev, 6, 4, 100000, "softmax")
    with pytest.raises(ValueError, match="shared memory"):
        KB._fused_trunc_draw(wl, ul, pl, 128, 32, True)


def _edge_rows(dev, K):
    """(10, K) edge rows of K9's threshold and their params: all equal; one
    live token; zeros from -inf logits; -0.0 entries; top-k > K;
    non-integer top-k with min-p; top-k off with top-p on; ties at tau_k
    beyond the survivor list; top-k 1; a plain softmax row."""
    g = np.random.default_rng(K)
    z = g.normal(0, 4.0, (10, K)).astype(np.float32)
    w = np.exp(z - z.max(axis=1, keepdims=True))
    w[0] = 0.25
    w[1] = 0.0
    w[1, K // 3] = 1.0
    zi = np.where(g.random(K) < 0.7, -np.inf, z[2]).astype(np.float32)
    zi[0] = 0.0
    w[2] = np.exp(zi - zi.max())
    w[3] = np.where(g.random(K) < 0.5, np.float32(-0.0), w[3])
    w[7, : min(K, KB._TRUNC_LIST_CAP + 500)] = 1.0
    prm = np.array([[64, 0.95, 0], [64, 0.95, 0], [64, 0.9, 0], [64, 0.95, 0],
                    [K + 1, 0.95, 0], [2.5, 0.9, 0.01], [0, 0.9, 0], [64, 0.95, 0],
                    [1, 0.5, 0], [64, 0.95, 0]], np.float32)
    u = g.uniform(0, 1, 10).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return t(w.astype(np.float32)), t(prm), t(u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int", "softmax"])
@pytest.mark.parametrize("B,K", [(8, 256000), (64, 256000), (64, 128256), (24, 300)])
def test_radix_threshold_equals_bisection(dev, B, K, kind, dtype):
    """K9's radix select and survivor list against its bisection body
    (``threshold="bisect"``): equal draws, bit for bit, at the cases of
    chip_smoke's phase 2d, and with iters < 32 (where both bisect top-k)."""
    w, prm, u = _trunc_inputs(dev, B * 7 + K, B, K, kind, dtype)
    W = runtime.default_w(K)
    for iters in (32, 20):
        got = KB._fused_trunc_draw(w, u, prm, W, iters, None, threshold="radix")
        want = KB._fused_trunc_draw(w, u, prm, W, iters, None, threshold="bisect")
        assert torch.equal(got, want), (iters, int((got != want).sum()))
    assert torch.equal(got, KB.fused_trunc_draw(w, u, prm, W, iters=20))


@pytest.mark.parametrize("K", [300, 32000, 56000, 100000])
def test_radix_threshold_edge_rows(dev, K):
    """The edge rows, the survivor list's overflow among them, staged and
    read from L2: both threshold bodies equal, ties only against the plain
    version, K10 equal to K9 on ``rng.row_uniforms``."""
    w, prm, u = _edge_rows(dev, K)
    W = runtime.default_w(K)
    want = KB._fused_trunc_draw(w, u, prm, W, 32, False, threshold="bisect")
    sources = (True, False) if KB.trunc_row_staged(K, KB.num_blocks(K, W), W) else (False,)
    for staged in sources:
        for thr in ("radix", "bisect"):
            got = KB._fused_trunc_draw(w, u, prm, W, 32, staged, threshold=thr)
            assert torch.equal(got, want), (staged, thr)
    res = trunc_boundary_ties(want, KB.fused_trunc_draw_torch(w, u, prm, W), w, u, prm,
                              depth=cuda_sum_depth(K))
    assert res["faults"] == 0, res
    assert want[1] == K // 3 and want[0] < K
    uu = rng.row_uniforms(SEED2.to(dev), 77, 10)
    assert torch.equal(KB.fused_trunc_draw_rng(w, SEED2, 77, prm, W),
                       KB.fused_trunc_draw(w, uu, prm, W))


@pytest.mark.parametrize("W", [32, 64, 128])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_masked_blocksums_equals_warp_order(dev, B, W):
    """K11 (several blocks per row, the last one scanning) against its
    exact-order plain model, bit for bit, on softmax weights; nb is not a
    multiple of a block's run of W-blocks."""
    for K in (100003, 256000):
        w, prm, _ = _trunc_inputs(dev, B + K + W, B, K, "softmax")
        prm[:, 0], prm[:, 1] = 64.0, 0.95
        tau = tr.thresholds_from_params(w, prm).contiguous()
        nb = KB.num_blocks(K, W)
        for t in (tau, torch.zeros_like(tau)):
            got = KB.masked_blocksums(w, t, W, nb)
            assert torch.equal(got, masked_blocksums_warp_order_torch(w, t, W, nb)), (K, W)
        assert torch.equal(KB.masked_blocksums(w.to(torch.bfloat16), tau, W, nb),
                           masked_blocksums_warp_order_torch(w.to(torch.bfloat16), tau, W,
                                                             nb))


@pytest.mark.parametrize("B,K", [(37286, 240), (64, 4096), (4, 70000)])
def test_alias_assembly_equals_plain(dev, B, K):
    """K13 against its plain version on the same partition and ranks:
    alias positions equal, prob within ref.prob_tolerance(Kp); the induced
    mass of the device build equals the weights (the reference's 5e-6)."""
    g = torch.Generator(device=dev).manual_seed(K)
    w = torch._standard_gamma(torch.full((B, K), 0.3, device=dev), generator=g)
    w[1] = 0
    s_sorted, _o, _i, nL = aops._partition(w)
    Kp = aops._next_pow2(K)
    sp = torch.nn.functional.pad(s_sorted, (0, Kp - K), value=1.0).contiguous()
    rank = aops._merged_rank(sp, nL).contiguous()
    KA.reset_launches()
    prob, apos = KA.alias_assemble(sp, nL, rank)
    pp, ap = KA.alias_assemble_torch(sp, nL, rank)
    assert KA.LAUNCHES == {"alias_assemble": 1}
    assert torch.equal(apos, ap)
    torch.testing.assert_close(prob, pp, rtol=0, atol=prob_tolerance(Kp))
    t = aops.build_alias_tables_device(w[:64])
    mass = table_mass(t.prob.cpu().numpy(), t.alias.cpu().numpy())
    wd = w[:64].double().cpu().numpy()
    tot = wd.sum(1, keepdims=True)
    target = np.where(tot > 0, wd / np.where(tot > 0, tot, 1), 1.0 / K)
    assert np.abs(mass - target).max() < 5e-6
    with pytest.raises(ValueError, match="rank"):
        KA.alias_assemble(sp, nL, rank.long())


def _alias_inputs(w):
    """The device build's assembly inputs: partitioned scaled weights padded
    with s = 1 to the next power of two, light counts, merged ranks."""
    s_sorted, _o, _i, nL = aops._partition(w)
    K = w.shape[1]
    Kp = aops._next_pow2(K)
    sp = torch.nn.functional.pad(s_sorted, (0, Kp - K), value=1.0).contiguous()
    return sp, nL, aops._merged_rank(sp, nL).contiguous()


def _alias_case(dev, case):
    """(B, K) Dirichlet-like weights (a zero row among them), the
    vocabulary's softmax rows, or edge rows at a power of two K: a
    Dirichlet row, a zero-weight row, an all-light row (uniform weights,
    nL = Kp) and an all-pad row (s = 1, nL = 0)."""
    kind, B, K = case
    g = torch.Generator(device=dev).manual_seed(B + K)
    if kind == "softmax":
        return _alias_inputs(torch.softmax(4.0 * torch.randn((B, K), generator=g, device=dev),
                                           dim=-1))
    w = torch._standard_gamma(torch.full((B, K), 0.3, device=dev), generator=g)
    w[1] = 0
    if kind == "gamma":
        return _alias_inputs(w)
    w[2] = 1.0
    sp, nL, rank = _alias_inputs(w[:3])
    ones = torch.ones(1, K, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return (torch.cat([sp, ones]).contiguous(), torch.cat([nL, zero]).contiguous(),
            torch.cat([rank, aops._merged_rank(ones, zero)]).contiguous())


ALIAS_CASES = [("gamma", 37286, 240), ("gamma", 64, 4096), ("gamma", 4, 70000),
               ("softmax", 64, 256000), ("edge", 4, 256), ("edge", 4, 4096), ("gamma", 9, 50)]
ALIAS_MODELS = {"block": alias_ref.assemble_block_order_torch,
                "group": alias_ref.assemble_group_order_torch,
                "split": alias_ref.assemble_split_order_torch}


@pytest.mark.parametrize("case", ALIAS_CASES)
def test_alias_layouts_equal_block(dev, case):
    """K13's group and split layouts (where they take the shape) against
    the forced block layout, the first port's kernel: prob and apos equal
    bit for bit."""
    sp, nL, rank = _alias_case(dev, case)
    want = KA._alias_assemble(sp, nL, rank, layout="block")
    others = [lay for lay in KA.fitting_layouts(*sp.shape) if lay != "block"]
    assert others
    for lay in others:
        got = KA._alias_assemble(sp, nL, rank, layout=lay)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), lay


@pytest.mark.parametrize("case", ALIAS_CASES)
def test_alias_layouts_equal_their_models(dev, case):
    """Each layout's kernel against its exact-order CPU model, bit for
    bit."""
    sp, nL, rank = _alias_case(dev, case)
    cpu = [t.cpu() for t in (sp, nL, rank)]
    for lay in KA.fitting_layouts(*sp.shape):
        got = KA._alias_assemble(sp, nL, rank, layout=lay)
        want = ALIAS_MODELS[lay](*cpu)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), lay


@pytest.mark.parametrize("case", ALIAS_CASES)
def test_alias_rule_launches_once(dev, case):
    """The rule's layout: one counted launch (the split's three kernels
    count once), apos equal to the plain version's, prob within
    prob_tolerance(Kp)."""
    sp, nL, rank = _alias_case(dev, case)
    KA.reset_launches()
    prob, apos = KA.alias_assemble(sp, nL, rank)
    assert KA.LAUNCHES == {"alias_assemble": 1}
    pp, ap = KA.alias_assemble_torch(sp, nL, rank)
    assert torch.equal(apos, ap)
    torch.testing.assert_close(prob, pp, rtol=0, atol=prob_tolerance(sp.shape[1]))


def test_alias_device_mass_at_vocabulary_width(dev):
    """build_alias_tables_device at (64, 256000) (the split layout): the
    induced mass equals the weights within the reference's 5e-6."""
    g = torch.Generator(device=dev).manual_seed(1)
    w = torch.softmax(4.0 * torch.randn((64, 256000), generator=g, device=dev), dim=-1)
    assert KA.alias_layout(64, 262144) == "split"
    t = aops.build_alias_tables_device(w)
    p = t.prob.double()
    mass = p.clone().scatter_add_(1, t.alias.long(), 1.0 - p) / w.shape[1]
    target = w.double() / w.double().sum(1, keepdim=True)
    assert float((mass - target).abs().max()) < 5e-6


def test_alias_forced_layouts_reject_what_they_do_not_take(dev):
    sp, nL, rank = _alias_case(dev, ("gamma", 4, 4096))
    with pytest.raises(ValueError, match="group layout does not take"):
        KA._alias_assemble(sp, nL, rank, layout="group")
    s2, n2, r2 = _alias_case(dev, ("gamma", 4, 240))
    with pytest.raises(ValueError, match="split layout does not take"):
        KA._alias_assemble(s2, n2, r2, layout="split")
    off = torch.empty(s2.numel() + 1, device=dev)[1:].view(s2.shape)
    off.copy_(s2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        KA._alias_assemble(off, n2, r2, layout="group")
    # the rule takes the block layout for rows it cannot load 16 bytes at a time
    got = KA.alias_assemble(off, n2, r2)
    want = KA._alias_assemble(s2, n2, r2, layout="block")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_categorical_butterfly_at_vocabulary_width(dev):
    """Categorical(method="butterfly") at (64, 256000): K1 at W=128 builds
    the table; the draws equal those from the plain table under the tie
    rule."""
    g = torch.Generator(device=dev).manual_seed(0)
    logits = 4.0 * torch.randn((64, 256000), generator=g, device=dev)
    w = sampling.logits_to_weights(logits)
    KT.reset_launches()
    d = sampling.Categorical.from_weights(w, method="butterfly")
    assert d.W == 128 and KT.LAUNCHES == {"butterfly_table": 1}
    u = torch.rand(64, generator=g, device=dev)
    wp, _, _ = bfly._prep(w, 128, group_pad=True)
    want = bfly.draw_butterfly_from_table(KT.butterfly_table_torch(wp, 128, "blocks"), u,
                                          W=128, B=64, K=256000)
    res = weight_ties(d.draw(u=u), want, w, u)
    assert res["faults"] == 0, res


def test_sampling_api_on_the_card(dev):
    """Every explicit method through sample_from_logits on CUDA tensors,
    and the decode path's launch counts."""
    from repro_torch.core import api

    g = torch.Generator(device=dev).manual_seed(1)
    logits = 3.0 * torch.randn((16, 5000), generator=g, device=dev)
    for m in api.METHODS[1:]:
        idx = api.sample_from_logits(logits, g, method=m)
        assert idx.device.type == "cuda" and 0 <= int(idx.min()) and int(idx.max()) < 5000
    p = sampling.plan((16, 5000), method="kernel", transforms="kp")
    KB.reset_launches()
    tok = p.sample_logits(logits, g, transforms=(sampling.TopK(20), sampling.TopP(0.9)))
    p.sample_logits(logits, g, num_samples=4, transforms=(sampling.TopK(20),))
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_trunc_draw": 1, "masked_blocksums": 1,
                           "walk_trunc": 1}
    kth = torch.sort(logits, dim=1, descending=True).values[:, 19]
    assert (logits.gather(1, tok[:, None].long())[:, 0] >= kth).all()


# ---------------------------------------------------------------------------
# The seeded draws (K5, K10), the device cipher and the sharded decode
# ---------------------------------------------------------------------------

from repro_torch.kernels import rng  # noqa: E402

SEED2 = rng.fold(rng.seed_from_key(np.array([0x12345678, 0x9ABCDEF0], np.uint32)), rng.TAG_U)


def test_threefry_uniforms_bit_exact(dev):
    """The device cipher of K5 and K10 against rng.row_uniforms over 2**20
    counters, half of them past the 2**32 wrap."""
    n = 1 << 20
    r0 = 2**32 - n // 2
    got = KB.threefry_uniforms(SEED2, r0, n, dev)
    want = rng.row_uniforms(SEED2.to(dev), r0, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["int", "dirichlet"])
@pytest.mark.parametrize("B,K", GRID_BK + [(64, 256000)])
def test_seeded_draw_equals_plain(dev, B, K, kind):
    """K5 against its plain version and against K4 fed rng.row_uniforms,
    at offsets that wrap; both routes of butterfly_sample_rng equal."""
    w, _ = _weights(dev, B + K, B, K, kind)
    W = runtime.default_w(K)
    exact = kind == "int"
    for r0 in (0, 2**32 - B // 2):
        u = rng.row_uniforms(SEED2.to(dev), r0, B)
        if KB.fused_fits(KB.num_blocks(K, W), W):
            got = KB.fused_draw_rng(w, SEED2, r0, W)
            torch.cuda.synchronize()
            assert torch.equal(got, KB.fused_draw(w, u, W))
            res = weight_ties(got, KB.fused_draw_rng_torch(w, SEED2, r0, W), w, u)
            assert res["faults"] == 0 and (not exact or res["mismatches"] == 0), res
        seed = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
        a = bops.butterfly_sample_rng(w, seed, row_offset=r0, W=W)
        b = bops.butterfly_sample_rng(w, seed, row_offset=r0, W=W, route="two_pass")
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["int", "softmax"])
@pytest.mark.parametrize("B,K", TRUNC_BK)
def test_seeded_truncated_draw_equals_plain(dev, B, K, kind):
    """K10 against its plain version and against K9 fed rng.row_uniforms;
    the forced two-pass route (tau, K11, K12) draws the same."""
    w, prm, _ = _trunc_inputs(dev, B * 3 + K, B, K, kind)
    W = runtime.default_w(K)
    exact = kind == "int"
    r0 = 2**32 - B // 2
    u = rng.row_uniforms(SEED2.to(dev), r0, B)
    got = KB.fused_trunc_draw_rng(w, SEED2, r0, prm, W)
    torch.cuda.synchronize()
    assert torch.equal(got, KB.fused_trunc_draw(w, u, prm, W))
    res = trunc_boundary_ties(got, KB.fused_trunc_draw_rng_torch(w, SEED2, r0, prm, W), w, u,
                              prm, depth=cuda_sum_depth(K))
    assert res["faults"] == 0 and (not exact or res["mismatches"] == 0), res
    seed = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    two = bops.butterfly_sample_truncated_rng(w, seed, prm, row_offset=r0, W=W,
                                              route="two_pass")
    res = trunc_boundary_ties(got.clamp(max=K - 1), two, w, u, prm, depth=cuda_sum_depth(K))
    assert res["faults"] == 0 and (not exact or res["mismatches"] == 0), res


def test_seeded_hw_stream_and_launches(dev):
    """hw=True (Philox in the kernel) equals its plain Philox version and
    is fixed for a fixed seed; each seeded wrapper counts its launches."""
    w, _ = _weights(dev, 3, 256, 3000)
    KB.reset_launches()
    a = KB.fused_draw_rng(w, SEED2, 7, 32, hw=True)
    assert torch.equal(a, KB.fused_draw_rng(w, SEED2, 7, 32, hw=True))
    assert torch.equal(a, KB.fused_draw_rng_torch(w, SEED2, 7, 32, hw=True))
    assert not torch.equal(a, KB.fused_draw_rng(w, SEED2, 7, 32))
    prm = torch.tensor([[20.0, 0.9, 0.0]], device=dev).repeat(256, 1)
    KB.fused_trunc_draw_rng(w, SEED2, 7, prm, 32)
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_draw_rng": 3, "fused_trunc_draw_rng": 1}
    with pytest.raises(ValueError, match="hw_rng"):
        bops.butterfly_sample_rng(w, np.array([1, 2], np.uint32), W=32, hw=True,
                                  route="two_pass")


def test_one_rank_nccl_mesh_decode(dev, tmp_path):
    """plan(mesh=...) on a one-rank NCCL group: the sharded decode at
    (64, 256000) with top-k 64 / top-p 0.95 launches K10 once and equals
    the unsharded counter draw; without the chain K5 once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        g = torch.Generator(device=dev).manual_seed(2)
        logits = 4.0 * torch.randn((64, 256000), generator=g, device=dev)
        key = np.array([5, 6], np.uint32)
        chain = (sampling.TopK(64), sampling.TopP(0.95))
        p = sampling.plan((64, 256000), method="kernel", mesh=mesh, transforms="kp")
        KB.reset_launches()
        tok = p.sample_logits(logits, key=key, transforms=chain)
        assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_trunc_draw_rng": 1}
        w = sampling.logits_to_weights(logits)
        prm = tr.canonical_params(chain, 64, device=dev)
        assert torch.equal(tok.to_local(), bops.butterfly_sample_truncated_rng(w, key, prm))
        KB.reset_launches()
        tok = p.sample_logits(logits, key=key)
        assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_draw_rng": 1}
        assert torch.equal(tok.to_local(), bops.butterfly_sample_rng(w, key, W=p.W))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The layouts: K4/K5 split over several blocks per row, K3 by lane groups
# ---------------------------------------------------------------------------

from repro_torch.kernels.butterfly_sample.ref import (  # noqa: E402
    group_walk_order_torch,
    split_running_order_torch,
)

LAYOUT_BKW = [(27392, 240, 16), (1000, 240, 32), (5, 17, 8), (64, 4096, 64),
              (64, 4099, 32), (3, 20011, 8), (64, 32000, 128), (8, 256000, 128),
              (64, 256000, 128)]


@pytest.mark.parametrize("B,K,W", LAYOUT_BKW)
def test_split_layout_equals_warp_layout(dev, B, K, W):
    """K4 and K5 draw the same indices in both layouts, bit for bit, on
    integer, Dirichlet and bf16 weights with all-zero rows, at offsets that
    wrap and with hw=True; K5 equals K4 on rng.row_uniforms, and on
    integer weights both equal the plain version."""
    nb = KB.num_blocks(K, W)
    for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                        ("int", torch.bfloat16)):
        w, u = _weights(dev, B + K + W, B, K, kind, dtype)
        w[::5] = 0
        warp = KB._fused_draw(w, u, W, layout="warp")
        split = KB._fused_draw(w, u, W, layout="split")
        torch.cuda.synchronize()
        assert torch.equal(warp, split), (kind, dtype)
        if kind == "int":
            assert torch.equal(split, KB.fused_draw_torch(w, u, W))
        assert bool((split[::5] == nb * W - 1).all())
        for r0, hw in ((0, False), (2**32 - B // 2, False), (11, True)):
            a = KB._fused_draw_rng(w, SEED2, r0, W, hw=hw, layout="split")
            assert torch.equal(a, KB._fused_draw_rng(w, SEED2, r0, W, hw=hw, layout="warp"))
            if not hw:
                uu = rng.row_uniforms(SEED2.to(dev), r0, B)
                assert torch.equal(a, KB._fused_draw(w, uu, W, layout="warp"))


def test_split_layout_running_sums_and_launches(dev):
    """One launch per call in either layout, the arrival counters left at
    zero for the next launch; K2's running sums in the layout its rule
    picks here (the split) and in the warp layout each equal the
    exact-order model of a row split, whose sums K4/K5's split layout
    walks."""
    w, u = _weights(dev, 1, 64, 256000, "dirichlet")
    KB.reset_launches()
    for layout in KB.LAYOUTS:
        KB._fused_draw(w, u, 128, layout=layout)
        KB._fused_draw_rng(w, SEED2, 0, 128, layout=layout)
    assert KB.LAUNCHES == {**_NO_LAUNCHES, "fused_draw": 2, "fused_draw_rng": 2}
    torch.cuda.synchronize()
    assert int(KB._arrival_counters(64, w.device)[:64].abs().sum()) == 0
    nb = KB.num_blocks(256000, 128)
    want = split_running_order_torch(w.cpu(), 128, nb, 7)
    assert torch.equal(KB.blocksums(w, 128, nb).cpu(), want)
    assert torch.equal(KB._blocksums(w, 128, nb, layout="warp").cpu(), want)
    assert KB.blocksums_layout(64, nb, 128) == "split"
    assert KB.fused_layout(64, nb, 128) == "split"
    with pytest.raises(ValueError, match="layout"):
        KB._fused_draw(w, u, 128, layout="rows")


@pytest.mark.parametrize("W", GRID_W)
def test_group_walk_equals_fused_draw(dev, W):
    """K3 (a group of W / 4 lanes per draw) equals its plain version on the
    same running sums bit for bit, and K4's draw on the same uniforms:
    integer, Dirichlet and bf16 weights, all-zero rows, S = 1 and 4, row
    widths with ncols % 4 != 0 and a misaligned base (four loads a lane)."""
    B = 3000
    for K in (240, 4 * W + 3, 4099, 1000):
        for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                            ("int", torch.bfloat16)):
            w, u = _weights(dev, K + W, B, K, kind, dtype)
            w[::7] = 0
            nb = KB.num_blocks(K, W)
            run = KB.blocksums(w, W, nb)
            rows = torch.arange(B, dtype=torch.int32, device=dev)
            one = KB.walk(w, run, u, rows, W)
            assert torch.equal(one, KB.fused_draw(w, u, W)), (K, kind, dtype)
            u4 = torch.rand(4 * B, device=dev)
            got = KB.walk(w, run, u4, rows.repeat(4), W)
            want = KB.walk_torch(w, run, u4, rows.repeat(4), W)
            assert torch.equal(got, want), (K, kind, dtype)
            assert torch.equal(got.cpu(), group_walk_order_torch(w.cpu(), run.cpu(), u4.cpu(),
                                                                 rows.repeat(4).cpu(), W))
            assert bool((one[::7] == nb * W - 1).all())
    # a base that is not 16-byte aligned takes the four-load instantiation
    w, u = _weights(dev, W, B, 241, "dirichlet")
    shifted = w.reshape(-1)[1:1 + B * 240].view(B, 240)
    assert not KB.walk_vector_loads(shifted)
    nb = KB.num_blocks(240, W)
    run = KB.blocksums(shifted, W, nb)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    assert torch.equal(KB.walk(shifted, run, u, rows, W),
                       KB.walk_torch(shifted, run, u, rows, W))


@pytest.mark.parametrize("W", [8, 16])
def test_masked_blocksums_equals_warp_order_narrow_w(dev, W):
    """K11 after its row split moved to draw_tile.cuh, at the widths below
    those of test_masked_blocksums_equals_warp_order."""
    for B, K in ((8, 100003), (64, 20000)):
        w, prm, _ = _trunc_inputs(dev, B + K + W, B, K, "softmax")
        prm[:, 0], prm[:, 1] = 64.0, 0.95
        tau = tr.thresholds_from_params(w, prm).contiguous()
        nb = KB.num_blocks(K, W)
        for t in (tau, torch.zeros_like(tau)):
            assert torch.equal(KB.masked_blocksums(w, t, W, nb),
                               masked_blocksums_warp_order_torch(w, t, W, nb)), (B, K)


# ---------------------------------------------------------------------------
# The layouts of K2 (a wide row split over several blocks) and K8 (a group
# of W / 4 lanes per factored draw)
# ---------------------------------------------------------------------------

from repro_torch.kernels.butterfly_sample.ref import split_blocks_per_row  # noqa: E402
from repro_torch.kernels.lda_draw.ref import fused_group_order_torch  # noqa: E402

K2_BKW = [(64, 256000, 128), (8, 32000, 128), (64, 4096, 64), (64, 4099, 32),
          (3, 20011, 8), (27392, 240, 16), (1000, 2048, 16)]


@pytest.mark.parametrize("B,K,W", K2_BKW)
def test_blocksums_split_equals_warp(dev, B, K, W):
    """K2's split layout writes the warp layout's running sums bit for bit
    (integer, Dirichlet and bf16 weights, all-zero rows, K % 4 != 0 and a
    misaligned base: the four-load instantiation), equal to the
    exact-order model at the card's P, one launch a call, the arrival
    counters left at zero; K3 on the split's sums draws what K4 draws."""
    nb = KB.num_blocks(K, W)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P = split_blocks_per_row(B, nb, W, sms=sms)
    cases = [("int", torch.float32), ("dirichlet", torch.float32), ("int", torch.bfloat16)]
    for kind, dtype in cases:
        w, u = _weights(dev, B + K + W, B, K, kind, dtype)
        w[::3] = 0
        KB.reset_launches()
        split = KB._blocksums(w, W, nb, layout="split")
        warp = KB._blocksums(w, W, nb, layout="warp")
        assert KB.LAUNCHES == {**_NO_LAUNCHES, "blocksums": 2}
        torch.cuda.synchronize()
        assert torch.equal(split, warp), (kind, dtype)
        assert int(KB._arrival_counters(B, dev)[:B].abs().sum()) == 0
        if B * K <= 64 * 32000:
            assert torch.equal(split.cpu(), split_running_order_torch(
                w.cpu(), W, nb, P, cols_per_lane=4)), (kind, dtype)
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        assert torch.equal(KB.walk(w, split, u, rows, W), KB.fused_draw(w, u, W))
    w, _ = _weights(dev, K, B, K + 1, "dirichlet")
    shifted = w.reshape(-1)[1:1 + B * K].view(B, K)
    assert torch.equal(KB._blocksums(shifted, W, nb, layout="split"),
                       KB._blocksums(shifted, W, nb, layout="warp"))


LDA_GROUP_VK = [(50, 24), (500, 240), (300, 61), (40, 1000), (30, 3000)]


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("V,Kc", LDA_GROUP_VK)
def test_lda_group_layout_equals_warp_layout(dev, W, V, Kc):
    """K8's group layout draws the warp layout's indices bit for bit
    (integer, Dirichlet and bf16 factors, all-zero theta rows, K % 4 != 0
    and a misaligned phi: the four-load instantiation), equal to its
    exact-order model, and K8 equals K6 + K7 on the same uniforms.  Where
    the group's sums do not fit its shared memory, forcing it raises."""
    nb = KB.num_blocks(Kc, W)
    B = 4099
    if not K.group_fits(nb, W):
        th, ph, d, w, u = _inputs(dev, W + Kc, B, V, Kc)
        with pytest.raises(ValueError, match="shared memory"):
            K._lda_fused_draw(th, ph, d, w, u, W, layout="group")
        return
    for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                        ("int", torch.bfloat16)):
        th, ph, d, w, u = _inputs(dev, W + Kc, B, V, Kc, kind, dtype)
        th[::4] = 0
        group = K._lda_fused_draw(th, ph, d, w, u, W, layout="group")
        running = K.lda_blocksums(th, ph, d, w, W, nb)
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        two = K.lda_walk(th, ph, running, u, rows, d, w, W)
        torch.cuda.synchronize()
        assert torch.equal(group, two), (kind, dtype)
        if K.fused_fits(nb, W):
            assert torch.equal(group, K._lda_fused_draw(th, ph, d, w, u, W, layout="warp"))
        assert torch.equal(group.cpu(), fused_group_order_torch(
            th.cpu(), ph.cpu(), d.cpu(), w.cpu(), u.cpu(), W)), (kind, dtype)
        assert bool((group[(d % 4 == 0)] == nb * W - 1).all())
    th, ph, d, w, u = _inputs(dev, Kc, B, V, Kc + 1, "dirichlet")
    shifted = ph.reshape(-1)[1:1 + V * Kc].view(V, Kc)
    th = th[:, :Kc].contiguous()
    running = K.lda_blocksums(th, shifted, d, w, W, nb)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    assert torch.equal(K._lda_fused_draw(th, shifted, d, w, u, W, layout="group"),
                       K.lda_walk(th, shifted, running, u, rows, d, w, W))


def test_lda_layouts_launches_and_rule(dev):
    """One launch a call in either layout; the sweep's chunk (K = 240, W =
    32) takes the group layout; a forced layout that does not fit raises."""
    th, ph, d, w, u = _inputs(dev, 5, 1000, 300, 240, "dirichlet")
    K.reset_launches()
    for layout in K.LAYOUTS:
        K._lda_fused_draw(th, ph, d, w, u, 32, layout=layout)
    assert K.LAUNCHES == {"lda_fused_draw": 2, "lda_blocksums": 0, "lda_walk": 0}
    assert K.lda_fused_layout(KB.num_blocks(240, 32), 32) == "group"
    th, ph, d, w, u = _inputs(dev, 6, 64, 30, 2728, "int")
    with pytest.raises(ValueError, match="shared memory"):
        K._lda_fused_draw(th, ph, d, w, u, 8, layout="group")


# ---------------------------------------------------------------------------
# K1's split schedule (W = 64, 128) and K7's group layout
# ---------------------------------------------------------------------------

from repro_torch.kernels.butterfly_table.ref import table_serial_order_torch  # noqa: E402
from repro_torch.kernels.lda_draw.ref import walk_group_order_torch  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("W", [64, 128])
def test_table_split_equals_serial(dev, W, G, dtype):
    """K1's split schedule builds the serial schedule's table bit for bit
    at (G * W, 256000), Dirichlet weights, in both layouts; the rule picks
    the split there; one launch a call.  At nb = 37 both equal the
    exact-order model."""
    K = 256000
    w, _ = _weights(dev, W + G, G * W, K, "dirichlet", dtype)
    assert KT.table_schedule(G, K // W, W) == "split"
    for layout in KT.LAYOUTS:
        KT.reset_launches()
        split = KT._butterfly_table(w, W, layout, schedule="split")
        serial = KT._butterfly_table(w, W, layout, schedule="serial")
        torch.cuda.synchronize()
        assert KT.LAUNCHES == {"butterfly_table": 2}
        assert torch.equal(split, serial), layout
        assert torch.equal(KT.butterfly_table_cuda(w, W, layout), split), layout
    ws = w[:, :37 * W].contiguous()
    model = table_serial_order_torch(ws.cpu(), W)
    for schedule in KT.SCHEDULES:
        assert torch.equal(KT._butterfly_table(ws, W, "blocks", schedule=schedule).cpu(),
                           model), schedule


def _walk_case(dev, seed, B, V, Kc, kind, dtype, S):
    th, ph, d, w, _ = _inputs(dev, seed, B, V, Kc, kind, dtype)
    th[::4] = 0
    nb = KB.num_blocks(Kc, 32)
    running = K.lda_blocksums(th, ph, d, w, 32, nb)
    u = torch.rand(S * B, device=dev)
    rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
    return th, ph, running, u, rows, d[rows.long()].contiguous(), w[rows.long()].contiguous()


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("V,Kc", [(37286, 240), (500, 239), (300, 61), (30, 3000)])
def test_lda_walk_group_equals_warp(dev, V, Kc, S):
    """K7's group layout draws the warp layout's indices bit for bit at the
    chunk's 27,392 draws a sample (W = 32; integer, Dirichlet and bf16
    factors, all-zero theta rows, K % 4 != 0 and a misaligned phi: the
    four-load instantiation), equal to its exact-order model, and K6 + K7
    equals K8 on the same uniforms."""
    B, W = 27392, 32
    for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                        ("int", torch.bfloat16)):
        th, ph, run, u, rows, dd, ww = _walk_case(dev, V + Kc + S, B, V, Kc, kind, dtype, S)
        group = K._lda_walk(th, ph, run, u, rows, dd, ww, W, layout="group")
        warp = K._lda_walk(th, ph, run, u, rows, dd, ww, W, layout="warp")
        torch.cuda.synchronize()
        assert torch.equal(group, warp), (kind, dtype)
        assert torch.equal(K.lda_walk(th, ph, run, u, rows, dd, ww, W), group)
        assert torch.equal(group.cpu(), walk_group_order_torch(
            th.cpu(), ph.cpu(), run.cpu(), u.cpu(), rows.cpu(), dd.cpu(), ww.cpu(), W))
        if S == 1 and K.group_fits(run.shape[1], W):
            assert torch.equal(group, K.lda_fused_draw(th, ph, dd, ww, u, W))
    th, ph, run, u, rows, dd, ww = _walk_case(dev, Kc, B, V, Kc + 1, "dirichlet",
                                              torch.float32, S)
    shifted = ph.reshape(-1)[1:1 + V * Kc].view(V, Kc)
    th = th[:, :Kc].contiguous()
    run = K.lda_blocksums(th, shifted, dd[:B], ww[:B], W, KB.num_blocks(Kc, W))
    assert torch.equal(K._lda_walk(th, shifted, run, u, rows, dd, ww, W, layout="group"),
                       K._lda_walk(th, shifted, run, u, rows, dd, ww, W, layout="warp"))


def test_lda_walk_layouts_launches_and_rule(dev):
    """One launch a call in either layout; every W takes the group
    layout."""
    th, ph, run, u, rows, dd, ww = _walk_case(dev, 7, 1000, 300, 240, "dirichlet",
                                              torch.float32, 2)
    K.reset_launches()
    for layout in K.LAYOUTS:
        K._lda_walk(th, ph, run, u, rows, dd, ww, 32, layout=layout)
    assert K.LAUNCHES == {"lda_fused_draw": 0, "lda_blocksums": 0, "lda_walk": 2}
    assert all(K.lda_walk_layout(8, W) == "group" for W in GRID_W)


# ---------------------------------------------------------------------------
# K6's and K12's group layouts
# ---------------------------------------------------------------------------

from repro_torch.kernels.butterfly_sample.ref import group_walk_order_torch  # noqa: E402
from repro_torch.kernels.lda_draw.ref import blocksums_group_order_torch  # noqa: E402


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("V,Kc", LDA_GROUP_VK)
def test_lda_blocksums_group_equals_warp(dev, W, V, Kc):
    """K6's group layout writes the warp layout's running sums bit for bit
    (integer, Dirichlet and bf16 factors, all-zero theta rows, K % 4 != 0
    and a misaligned phi: the four-load instantiation), equal to its
    exact-order model, and on integer factors to ``lda_blocksums_torch``.
    Where the group's sums do not fit its shared memory, forcing it
    raises."""
    nb = KB.num_blocks(Kc, W)
    B = 4099
    if not K.group_fits(nb, W):
        th, ph, d, w, _ = _inputs(dev, W + Kc, B, V, Kc)
        with pytest.raises(ValueError, match="shared memory"):
            K._lda_blocksums(th, ph, d, w, W, nb, layout="group")
        return
    for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                        ("int", torch.bfloat16)):
        th, ph, d, w, _ = _inputs(dev, W + Kc, B, V, Kc, kind, dtype)
        th[::4] = 0
        group = K._lda_blocksums(th, ph, d, w, W, nb, layout="group")
        warp = K._lda_blocksums(th, ph, d, w, W, nb, layout="warp")
        torch.cuda.synchronize()
        assert torch.equal(group, warp), (kind, dtype)
        assert torch.equal(K.lda_blocksums(th, ph, d, w, W, nb), group)
        assert torch.equal(group.cpu(), blocksums_group_order_torch(
            th.cpu(), ph.cpu(), d.cpu(), w.cpu(), W)), (kind, dtype)
        if kind == "int":
            assert torch.equal(group, K.lda_blocksums_torch(th, ph, d, w, W, nb))
    th, ph, d, w, _ = _inputs(dev, Kc, B, V, Kc + 1, "dirichlet")
    shifted = ph.reshape(-1)[1:1 + V * Kc].view(V, Kc)
    th = th[:, :Kc].contiguous()
    assert torch.equal(K._lda_blocksums(th, shifted, d, w, W, nb, layout="group"),
                       K._lda_blocksums(th, shifted, d, w, W, nb, layout="warp"))


def test_lda_blocksums_layouts_launches_and_rule(dev):
    """One launch a call in either layout; the sweep's chunk (K = 240, W =
    32) takes the group layout."""
    th, ph, d, w, _ = _inputs(dev, 8, 1000, 300, 240, "dirichlet")
    K.reset_launches()
    for layout in K.LAYOUTS:
        K._lda_blocksums(th, ph, d, w, 32, 8, layout=layout)
    assert K.LAUNCHES == {"lda_fused_draw": 0, "lda_blocksums": 2, "lda_walk": 0}
    assert K.lda_blocksums_layout(KB.num_blocks(240, 32), 32) == "group"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int", "softmax"])
@pytest.mark.parametrize("B,Kc", TRUNC_BK + [(16, 4099)])
def test_walk_trunc_group_equals_warp(dev, B, Kc, kind, dtype):
    """K12's group layout draws the warp layout's indices bit for bit
    (S = 1 and 4; zero rows; Kc = 4,099: four loads a lane), equal to the
    exact-order model on the masked rows; on integer weights both equal
    ``walk_trunc_torch``."""
    w, prm, _ = _trunc_inputs(dev, B + Kc, B, Kc, kind, dtype)
    w[B // 2] = 0
    W = runtime.default_w(Kc)
    nb = KB.num_blocks(Kc, W)
    tau = tr.thresholds_from_params(w, prm).contiguous()
    run = KB.masked_blocksums(w, tau, W, nb)
    for S in (1, 4):
        u = torch.rand(S * B, device=dev)
        rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
        group = KB._walk_trunc(w, run, u, tau, rows, W, layout="group")
        warp = KB._walk_trunc(w, run, u, tau, rows, W, layout="warp")
        torch.cuda.synchronize()
        assert torch.equal(group, warp), S
        assert torch.equal(KB.walk_trunc(w, run, u, tau, rows, W), group)
        masked = KB._mask(w.float(), tau).cpu()
        assert torch.equal(group.cpu(), group_walk_order_torch(
            masked, run.cpu(), u.cpu(), rows.cpu(), W)), S
        if kind == "int":
            assert torch.equal(group, KB.walk_trunc_torch(w, run, u, tau, rows, W)
                               .to(torch.int32))


def test_walk_trunc_layouts_launches_and_rule(dev):
    """One launch a call in either layout; every W takes the group
    layout."""
    w, prm, u = _trunc_inputs(dev, 3, 8, 3000, "softmax")
    tau = tr.thresholds_from_params(w, prm).contiguous()
    run = KB.masked_blocksums(w, tau, 64, KB.num_blocks(3000, 64))
    rows = torch.arange(8, dtype=torch.int32, device=dev)
    KB.reset_launches()
    for layout in KB.WALK_TRUNC_LAYOUTS:
        KB._walk_trunc(w, run, u, tau, rows, 64, layout=layout)
    assert KB.LAUNCHES["walk_trunc"] == 2
    assert sum(KB.LAUNCHES.values()) == 2
    assert all(KB.walk_trunc_layout(8, W) == "group" for W in GRID_W)


# ---------------------------------------------------------------------------
# method="auto" on the card: the backend is the call's device
# ---------------------------------------------------------------------------


@pytest.fixture
def port_autotune(tmp_path, monkeypatch):
    from repro_torch import autotune

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "model")
    autotune.reset()
    yield autotune
    autotune.reset()


def test_auto_cpu_and_card_calls_land_in_different_buckets(dev, port_autotune):
    """One process, one shape: the CPU call resolves in a ``cpu|`` bucket
    over the CPU's candidates, the card call in a ``cuda|`` bucket whose
    candidates include the CUDA kernels; both draw."""
    from repro_torch import sampling
    from repro_torch.core import api

    w = torch.rand((64, 4096), generator=torch.Generator().manual_seed(0)) + 0.1
    u = torch.rand(64, generator=torch.Generator().manual_seed(1))
    a = api.sample_categorical(w, u=u)
    b = api.sample_categorical(w.to(dev), u=u.to(dev))
    assert a.device.type == "cpu" and b.device.type == "cuda"
    keys = [k for k, _ in port_autotune.get_tuner().cache.items()]
    assert keys == ["cpu|B64|K4096|d1|float32|nokey", "cuda|B64|K4096|d1|float32|nokey"]
    p_cpu = sampling.plan(w, has_key=False)
    p_card = sampling.plan(w.to(dev), has_key=False)
    assert (p_cpu.backend, p_card.backend) == ("cpu", "cuda")
    assert "kernel" in port_autotune.candidate_methods(64, 4096, "cuda", False)
    assert "kernel" not in port_autotune.candidate_methods(64, 4096, "cpu", False)


@pytest.mark.parametrize("B,Kc", [(64, 4096), (27392, 240), (64, 32000)])
def test_auto_draws_equal_resolved_method_on_card(dev, port_autotune, B, Kc):
    """Each default draws what the method it resolved to draws, on the
    same uniforms or the same generator."""
    from repro_torch import sampling
    from repro_torch.core import api

    g = torch.Generator(device=dev).manual_seed(B + Kc)
    w = torch.rand((B, Kc), generator=g, device=dev) + 0.05
    u = torch.rand(B, generator=g, device=dev)
    p = sampling.plan(w, has_key=False)
    assert torch.equal(api.sample_categorical(w, u=u),
                       api.sample_categorical(w, u=u, method=p.method, W=p.W))
    x = torch.log(w)
    pk = sampling.plan(x, has_key=True)
    g.manual_seed(7)
    a = api.sample_from_logits(x, g)
    g.manual_seed(7)
    assert torch.equal(a, api.sample_from_logits(x, g, method=pk.method, W=pk.W))
    chain = (sampling.TopK(64), sampling.TopP(0.95))
    pt = sampling.plan(x, transforms="kp")
    pe = sampling.plan(x, method=pt.method, W=pt.W, transforms="kp")
    for S in (1, 4):
        g.manual_seed(S)
        a = pt.sample_logits(x, g, num_samples=S, transforms=chain)
        g.manual_seed(S)
        assert torch.equal(a, pe.sample_logits(x, g, num_samples=S, transforms=chain))


def test_measure_mode_on_card(dev, port_autotune):
    """Measure mode times the card's candidates (the host clock around a
    synchronised call) and persists a measured winner in the cuda bucket."""
    t = port_autotune.Tuner(mode="measure", backend="cuda")
    r = t.resolve_full(64, 4096, transforms="kp")
    assert r.source == "measured"
    assert r.method in port_autotune.candidate_methods(64, 4096, "cuda", True,
                                                       transforms="kp")
    us = port_autotune.measure_method("kernel_trunc", 64, 4096, 64, truncated=True,
                                      device="cuda")
    assert us is not None and us > 0


def test_dist_key_on_card_rebuilds_after_in_place_change(dev, port_autotune):
    from repro_torch import sampling
    from repro_torch.core import api

    g = torch.Generator(device=dev).manual_seed(3)
    phi = torch.rand((500, 240), generator=g, device=dev) + 0.01
    cache = port_autotune.get_table_cache()
    for method in ("alias_device", "fenwick", "radix_forest"):
        cache.clear()
        g.manual_seed(4)
        a = api.sample_categorical(phi, g, method=method, dist_key="phi")
        b = api.sample_categorical(phi, g, method=method, dist_key="phi")
        assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1}
        phi[:, :100].mul_(3.0)
        g.manual_seed(5)
        c = api.sample_categorical(phi, g, method=method, dist_key="phi")
        g.manual_seed(5)
        d = sampling.Categorical.from_weights(phi.clone(), method=method).draw(generator=g)
        assert cache.stats()["misses"] == 2 and torch.equal(c, d)
        assert a.shape == b.shape == (500,)


# ---------------------------------------------------------------------------
# S1: the sparse LDA MH sweep
# ---------------------------------------------------------------------------

from repro_torch.core.alias import build_alias_tables_host  # noqa: E402
from repro_torch.kernels.sparse_mh import kernel as KS  # noqa: E402
from repro_torch.kernels.sparse_mh import ops as sops  # noqa: E402
from repro_torch.kernels.sparse_mh.ref import mh_sweep_torch  # noqa: E402
from repro_torch.lda import corpus as lcorpus  # noqa: E402
from repro_torch.lda import gibbs as lgibbs  # noqa: E402
from repro_torch.lda import sparse as lsp  # noqa: E402


def _mh_inputs(dev, seed, M, L, K, V, cap):
    g = np.random.default_rng(seed)
    theta = g.dirichlet(np.full(K, 0.3), size=M).astype(np.float32)
    phi = np.ascontiguousarray(g.dirichlet(np.full(V, 0.3), size=K).T).astype(np.float32)
    docs = g.integers(0, V, size=(M, L)).astype(np.int32)
    mask = np.arange(L)[None] < g.integers(0, L + 1, size=M)[:, None]
    z = g.integers(0, K, size=(M, L)).astype(np.int32)
    t = [torch.as_tensor(x, device=dev) for x in (z, docs, mask, theta, phi)]
    dt, _ = lsp._counts_scatter(t[0], t[1], t[2], K, V)
    sp = lsp.sparse_counts(dt, cap)
    return t + [sp.ids, sp.cnt]


def _mh_tables(phi, mode):
    if mode == "cdf":
        return lsp._phi_cdf(phi), torch.zeros((1, 1), dtype=torch.int32, device=phi.device)
    t = (build_alias_tables_host(phi) if mode == "alias"
         else aops.build_alias_tables_device(phi))
    return t.prob, t.alias


def _mh_equal(inp, mode, steps, row0, seed2, alpha=0.1):
    """S1 in each layout that takes the shape against its plain version
    (z, both accept counts, the proposal count) and the layouts' z against
    each other; the rule's pick among them."""
    tables = _mh_tables(inp[4], mode)
    args = (*inp, *tables, seed2, row0, alpha)
    zp, wp, dp, props = mh_sweep_torch(*args, steps=steps, cap=inp[5].shape[1],
                                       mode=mode, chunk=64)
    K, cap, L = inp[3].shape[1], inp[5].shape[1], inp[1].shape[1]
    zs = {}
    for layout in (None, *KS.fitting_layouts(K, cap, L)):
        z, wa, da, n = KS._mh_sweep(*args, steps=steps, mode=mode, layout=layout)
        torch.cuda.synchronize()
        assert torch.equal(z, zp), layout
        assert (int(wa), int(da), int(n) * steps) == (int(wp), int(dp), int(props)), layout
        zs[layout] = z
    assert len(zs) == 1 + len(KS.fitting_layouts(K, cap, L))
    return zs[None]


@pytest.mark.parametrize("cap", [8, 64])
@pytest.mark.parametrize("steps", [1, 2, 4])
@pytest.mark.parametrize("mode", ["cdf", "alias", "alias_device"])
def test_sparse_mh_equals_plain(dev, mode, steps, cap):
    """S1's z and accept counts equal its plain version's bit for bit, in
    each layout, on ragged (and empty) documents, truncating and wide
    caps, K = 240 and a row offset whose counters wrap at 2**32."""
    inp = _mh_inputs(dev, steps * 100 + cap, 300, 96, 240, 500, cap)
    seed2 = rng.fold(rng.seed_from_key([steps, cap]), rng.TAG_SPARSE_MH)
    for row0 in (0, 2**32 - 5000):
        _mh_equal(inp, mode, steps, row0, seed2)


@pytest.mark.parametrize("K,cap", [(2, 2), (7, 4), (2048, 64), (300, 300)])
def test_sparse_mh_edge_shapes(dev, K, cap):
    inp = _mh_inputs(dev, K, 64, 40, K, 50, cap)
    seed2 = rng.fold(rng.seed_from_key([K, 1]), rng.TAG_SPARSE_MH)
    for mode in ("cdf", "alias_device"):
        _mh_equal(inp, mode, 3, 17, seed2)


@pytest.mark.parametrize("cap", [1, 240])
@pytest.mark.parametrize("mode", ["cdf", "alias"])
def test_sparse_mh_layouts_cap_one_and_k(dev, mode, cap):
    """cap 1 (one retained topic) and cap = K (every topic, zero tails)."""
    inp = _mh_inputs(dev, cap, 200, 70, 240, 300, cap)
    _mh_equal(inp, mode, 2, 5, rng.fold(rng.seed_from_key([cap, 2]), rng.TAG_SPARSE_MH))


@pytest.mark.parametrize("mode", ["cdf", "alias_device"])
def test_sparse_mh_layouts_long_and_masked_documents(dev, mode):
    """L = 150 (longer than a doc-layout block of 128 threads, not a
    multiple of 32), full documents and fully masked ones; then every
    position masked (z kept, counts 0)."""
    inp = _mh_inputs(dev, 9, 120, 150, 240, 400, 64)
    inp[2][:10] = True
    inp[2][10:30] = False
    seed2 = rng.fold(rng.seed_from_key([9, 9]), rng.TAG_SPARSE_MH)
    _mh_equal(inp, mode, 2, 2**32 - 3000, seed2)
    inp[2][:] = False
    z = _mh_equal(inp, mode, 2, 0, seed2)
    assert torch.equal(z, inp[0])


def _exact_inputs(dev, seed2, kind):
    """A token's doc proposal exactly at K alpha (``"t=Ka"``) or its
    doc-sparse offset exactly on cc[0] (``"x=cc"``), built from the token's
    own uniform u3 = k / 2**24 with K = 16 (as chip_smoke's phase 7a)."""
    M, L, K, V, row0 = 32, 8, 16, 30, 3
    g = np.random.default_rng(len(kind))
    ctr = (row0 + torch.arange(M)[:, None]) * L + torch.arange(L)[None]
    u3 = rng.uniform(rng._u32(seed2), ctr, 3)
    dt = g.integers(0, 5, size=(M, K)).astype(np.float32)
    mask = g.random((M, L)) < 0.7
    if kind == "t=Ka":
        k = int(u3[0, 0].item() * 2**24)
        alpha = k / K
        dt[0] = 0
        dt[0, 5], dt[0, 9] = 2**24 - k - 1000, 1000
        mask[0, 0] = True
    else:
        alpha = 1.0
        first = torch.argmax((u3 >= 0.5 + 2.0**-20).int(), dim=1).numpy()
        x = (u3[torch.arange(M), first] * 2**24).long().numpy() - 16
        dt[:] = 0
        dt[np.arange(M), np.arange(M) % K] = x
        dt[np.arange(M), (np.arange(M) + 3) % K] = 2**24 - 16 - x
        mask[np.arange(M), first] = True
    sp = lsp.sparse_counts(torch.as_tensor(dt, device=dev), 4)
    theta = g.dirichlet(np.full(K, 0.3), size=M).astype(np.float32)
    phi = np.ascontiguousarray(g.dirichlet(np.full(V, 0.3), size=K).T).astype(np.float32)
    t = [torch.as_tensor(x, device=dev) for x in (
        g.integers(0, K, size=(M, L)).astype(np.int32),
        g.integers(0, V, size=(M, L)).astype(np.int32), mask, theta, phi)]
    return t + [sp.ids, sp.cnt], row0, alpha


@pytest.mark.parametrize("kind", ["t=Ka", "x=cc"])
def test_sparse_mh_layouts_exact_boundaries(dev, kind):
    seed2 = rng.fold(rng.seed_from_key([3, 3]), rng.TAG_SPARSE_MH)
    inp, row0, alpha = _exact_inputs(dev, seed2, kind)
    for mode in ("cdf", "alias"):
        _mh_equal(inp, mode, 1, row0, seed2, alpha=alpha)


def test_sparse_mh_rule_takes_position_at_large_k(dev):
    """K = 12,500: one document's map, list and positions exceed a block's
    48 KB, so the rule takes the position layout, which equals the plain
    version; the doc layout refuses the shape."""
    inp = _mh_inputs(dev, 4, 16, 40, 12500, 50, 64)
    assert KS.mh_layout(12500, 64, 40) == "position"
    assert KS.fitting_layouts(12500, 64, 40) == ("position",)
    seed2 = rng.fold(rng.seed_from_key([4, 4]), rng.TAG_SPARSE_MH)
    _mh_equal(inp, "cdf", 2, 0, seed2)
    with pytest.raises(ValueError):
        KS._mh_sweep(*inp, *_mh_tables(inp[4], "cdf"), seed2, 0, 0.1, steps=1,
                     mode="cdf", layout="doc")


def test_sparse_sweeps_launch_s1_and_k13_once_a_sweep(dev, port_autotune):
    """On the card the sparse sweep launches S1 once a sweep, and K13 once
    a sweep with alias_device tables (phi changes every sweep); the plain
    version never runs for CUDA tensors."""
    corpus = lcorpus.synthesize_corpus(seed=0, M=200, V=300, K=8, avg_len=40, max_len=80)
    for wp, k13 in (("cdf", 0), ("alias_device", 3)):
        state = lgibbs.init_state(0, corpus, 64, device=dev)
        cache = lsp.SparseSweepCache()
        KS.reset_launches()
        KA.reset_launches()
        for _ in range(3):
            state = lgibbs.gibbs_step(state, corpus, sparse=True, sparse_cache=cache,
                                      word_proposal=wp)
        torch.cuda.synchronize()
        assert KS.LAUNCHES["sparse_mh"] == 3 and KA.LAUNCHES["alias_assemble"] == k13, wp
        assert state.z.is_cuda and 0.05 < cache.last_stats["doc_accept_rate"] <= 1
    cpu = [x.cpu() for x in _mh_inputs(dev, 1, 8, 8, 16, 20, 8)]
    tables = _mh_tables(cpu[4], "cdf")
    with pytest.raises(ValueError):
        KS.mh_sweep(*cpu, *tables, [1, 2], 0, 0.1, steps=1, mode="cdf")
    with pytest.raises(ValueError):
        sops.mh_sweep(*cpu, *tables, [1, 2], 0, 0.1, steps=1, cap=8, mode="cdf",
                      impl="cuda")
