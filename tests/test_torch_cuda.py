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


def _weights(dev, seed, B, K, kind="int", dtype=torch.float32):
    g = np.random.default_rng(seed)
    if kind == "int":
        w = g.integers(1, 100, size=(B, K)).astype(np.float32)
    else:
        w = g.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)
    u = g.uniform(0, 1, size=B).astype(np.float32)
    return torch.as_tensor(w, device=dev).to(dtype), torch.as_tensor(u, device=dev)


@pytest.mark.parametrize("W", [4, 8, 16, 32])
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
    with pytest.raises(ValueError, match="32"):
        butterfly_table(torch.ones(128, 128, device=dev), W=64)


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
    assert KB.LAUNCHES == {"blocksums": 0, "walk": 0, "fused_draw": 1}
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
    assert KB.LAUNCHES == {"blocksums": 1, "walk": 1, "fused_draw": 1}
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
    assert KB.LAUNCHES == {"blocksums": 3, "walk": 3, "fused_draw": 0}
    assert 0 <= int(state.z.min()) and int(state.z.max()) < 8
