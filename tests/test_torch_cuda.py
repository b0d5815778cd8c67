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
