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
from repro_torch.kernels.alias_build.ref import prob_tolerance, table_mass  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import (  # noqa: E402
    cuda_sum_depth, trunc_boundary_ties)
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
