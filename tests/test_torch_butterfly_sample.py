"""The port's draws on given weights (repro_torch.kernels.butterfly_sample,
the plain versions of K2, K3 and K4 on the CPU) against the reference's
Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: on integer weights every fp32 sum is exact, so indices and
running sums must be equal.  On Dirichlet weights the two sum in
different orders, so a mismatch is allowed only where it is a
float64-checked boundary tie (``ref.boundary_ties``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import butterfly_sample as jbs
from repro.kernels.butterfly_sample.kernel import (
    build_block_sums_pallas,
    butterfly_sample_pallas,
    sample_from_block_sums_pallas,
)
from repro.kernels.butterfly_sample.ref import butterfly_sample_ref as j_ref
from repro_torch.kernels.butterfly_sample import kernel as KB
from repro_torch.kernels.butterfly_sample import ops
from repro_torch.kernels.butterfly_sample.ref import boundary_ties, butterfly_sample_ref
from repro_torch.sampling import distribution as tdist

GRID_W = [8, 16, 32]
GRID_BK = [(5, 17), (24, 300), (3, 2000)]
ROUTES = [None, "fused", "two_pass"]


def _inputs(seed, B, K, weights="int", S=1):
    rng = np.random.default_rng(seed)
    if weights == "int":
        w = rng.integers(1, 1000, size=(B, K)).astype(np.float32)
    else:
        w = rng.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)
    u = rng.uniform(0, 1, size=(S, B) if S > 1 else (B,)).astype(np.float32)
    return w, u


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("B,K", GRID_BK)
def test_sample_equals_reference_on_integer_weights(W, B, K):
    w, u = _inputs(B * 37 + K + W, B, K)
    want = np.asarray(jbs.butterfly_sample(jnp.asarray(w), jnp.asarray(u), W=W,
                                           tb=4, tk=4 * W))
    np.testing.assert_array_equal(want, np.asarray(j_ref(jnp.asarray(w), jnp.asarray(u))))
    for route in ROUTES:
        got = ops.butterfly_sample(torch.as_tensor(w), torch.as_tensor(u), W=W, route=route)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(route))
    np.testing.assert_array_equal(
        butterfly_sample_ref(torch.as_tensor(w), torch.as_tensor(u)).numpy(), want)


@pytest.mark.parametrize("W", GRID_W)
@pytest.mark.parametrize("B,K", GRID_BK)
def test_block_sums_and_draws_from_sums(W, B, K):
    """Pass A's running sums equal the reference's; pass B draws S=1 and
    S=4 equal the reference's, from either package's state."""
    w, _ = _inputs(B + K + W, B, K)
    jwp, jrun = jbs.build_block_sums(jnp.asarray(w), W=W)
    wp, run = ops.build_block_sums(torch.as_tensor(w), W=W)
    nb = -(-K // W)
    assert torch.equal(wp, torch.as_tensor(w)) and run.shape == (B, nb)
    np.testing.assert_array_equal(run.numpy(), np.asarray(jrun)[:B, :nb])
    # the reference pads running with empty blocks past K: they repeat the total
    np.testing.assert_array_equal(np.asarray(jrun)[:B, nb:],
                                  np.repeat(run.numpy()[:, -1:], jrun.shape[1] - nb, 1))
    jstate = tdist.kernel_state_from_numpy(jwp, jrun, device="cpu")
    pwp, prun = tdist.kernel_state_to_numpy({"weights": wp, "running": run}, W)
    for S in (1, 4):
        _, u = _inputs(S * B + K, B, K, S=S)
        want = np.asarray(jbs.butterfly_sample_from_sums(jwp, jrun, jnp.asarray(u), K=K, W=W))
        for state in (jstate, {"weights": wp, "running": run}):
            got = ops.butterfly_sample_from_sums(state["weights"], state["running"],
                                                 torch.as_tensor(u), K=K, W=W)
            assert got.shape == u.shape
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"S={S}")
        # the port's state, drawn from by the reference
        back = np.asarray(jbs.butterfly_sample_from_sums(jnp.asarray(pwp), jnp.asarray(prun),
                                                         jnp.asarray(u), K=K, W=W))
        np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("W", [8, 16])
def test_table_in_matches_fused(W):
    """The reference's test_table_in_matches_fused property, on the port:
    the fused route equals the two-pass route, here on real weights."""
    w, u = _inputs(W, 12, 200, weights="dirichlet")
    tw, tu = torch.as_tensor(w), torch.as_tensor(u)
    fused = ops.butterfly_sample(tw, tu, W=W, route="fused")
    wp, run = ops.build_block_sums(tw, W=W)
    assert torch.equal(fused, ops.butterfly_sample_from_sums(wp, run, tu, K=200, W=W))
    assert torch.equal(fused, ops.butterfly_sample(tw, tu, W=W, route="two_pass"))
    jf = np.asarray(butterfly_sample_pallas(jnp.asarray(w), jnp.asarray(u), W=W, tb=8))
    jwp, jrun = build_block_sums_pallas(jnp.asarray(w), W=W, tb=8)
    jt = np.asarray(sample_from_block_sums_pallas(jwp, jrun, jnp.asarray(u), B=12, K=200,
                                                  W=W, tb=8))
    np.testing.assert_array_equal(jf, jt)
    res = boundary_ties(fused, jf, w, u)
    assert res["faults"] == 0, res


@pytest.mark.parametrize("W", GRID_W)
def test_dirichlet_mismatches_are_ties(W):
    B, K = 96, 300
    w, u = _inputs(W + 1, B, K, weights="dirichlet")
    want = np.asarray(jbs.butterfly_sample(jnp.asarray(w), jnp.asarray(u), W=W))
    got = ops.butterfly_sample(torch.as_tensor(w), torch.as_tensor(u), W=W)
    res = boundary_ties(got, want, w, u)
    assert res["faults"] == 0 and res["ties"] <= 2, res
    _, u4 = _inputs(W + 2, B, K, S=4)
    jwp, jrun = jbs.build_block_sums(jnp.asarray(w), W=W)
    want4 = np.asarray(jbs.butterfly_sample_from_sums(jwp, jrun, jnp.asarray(u4), K=K, W=W))
    wp, run = ops.build_block_sums(torch.as_tensor(w), W=W)
    got4 = ops.butterfly_sample_from_sums(wp, run, torch.as_tensor(u4), K=K, W=W)
    res = boundary_ties(got4, want4, w, u4)
    assert res["faults"] == 0 and res["ties"] <= 4, res


def test_bf16_and_zero_rows():
    """bf16 weights (integers < 256 are exact in bf16) draw as the
    reference's; all-zero rows draw K-1 on both routes, as padded chunk
    rows do."""
    B, K, W = 16, 128, 8
    w, u = _inputs(2, B, K)
    w = np.minimum(w, 255)
    w[::3] = 0
    tw = torch.as_tensor(w).to(torch.bfloat16)
    want = np.asarray(jbs.butterfly_sample(jnp.asarray(w).astype(jnp.bfloat16),
                                           jnp.asarray(u), W=W))
    for route in ROUTES[1:]:
        got = ops.butterfly_sample(tw, torch.as_tensor(u), W=W, route=route)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[::3] == K - 1).all()


def test_from_sums_rng_bit_equal_to_reference():
    B, K, W = 24, 300, 16
    w, _ = _inputs(7, B, K)
    seed = np.array([12345, 678], np.uint32)
    jwp, jrun = jbs.build_block_sums(jnp.asarray(w), W=W)
    wp, run = ops.build_block_sums(torch.as_tensor(w), W=W)
    for S, off in ((1, 0), (3, 1000)):
        want = np.asarray(jbs.butterfly_sample_from_sums_rng(
            jwp, jrun, jnp.asarray(seed), B=B, K=K, S=S, row_offset=off, W=W))
        got = ops.butterfly_sample_from_sums_rng(wp, run, seed, B=B, K=K, S=S,
                                                 row_offset=off, W=W)
        np.testing.assert_array_equal(got.numpy(), want)


def test_checks_and_routes():
    w = torch.ones(4, 40)
    u = torch.full((4,), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.butterfly_sample(w, u, W=8, impl="cuda")
    with pytest.raises(ValueError, match="route"):
        ops.butterfly_sample(w, u, W=8, route="three_pass")
    with pytest.raises(ValueError, match="W"):
        ops.butterfly_sample(w, u, W=12)
    with pytest.raises(ValueError, match="CUDA"):
        KB.blocksums(w, 8, 5)
    # the fused kernel keeps (nb + W) floats per warp in 48 KB
    assert KB.fused_fits(KB.num_blocks(32000, 128), 128)
    assert not KB.fused_fits(3000, 128) and KB.fused_fits(3072 - 32, 32)


# ---------------------------------------------------------------------------
# Truncated draws: K9 (fused) and K11 + K12 (two-pass) plain versions
# ---------------------------------------------------------------------------

from repro.kernels.butterfly_sample.kernel import (  # noqa: E402
    _build_masked_sums_impl,
    _trunc_draw_from_sums_impl,
    butterfly_sample_truncated_pallas,
)
from repro.sampling import transforms as jtr  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import trunc_boundary_ties  # noqa: E402
from repro_torch.sampling import transforms as ttr  # noqa: E402


def _trunc_params(seed, B, kind):
    """(B, 3) [k, p, min_p]: one chain on every row, or per-row values with
    row r % 4 disabling top-k, top-p, min-p, or all three."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return np.tile(np.array([[20.0, 0.8, 0.01]], np.float32), (B, 1))
    prm = np.stack([rng.integers(1, 60, B), rng.uniform(0.5, 1.0, B),
                    rng.uniform(0.0, 0.05, B)], axis=1).astype(np.float32)
    r = np.arange(B) % 4
    prm[(r == 0) | (r == 3), 0] = 0.0
    prm[(r == 1) | (r == 3), 1] = 1.0
    prm[(r == 2) | (r == 3), 2] = 0.0
    return prm


def _softmax_weights(seed, B, K):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 4.0, (B, K)).astype(np.float32)
    return np.exp(z - z.max(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("W", [8, 32])
@pytest.mark.parametrize("B,K,weights,kind", [(24, 300, "int", "hetero"),
                                              (16, 2000, "softmax", "uniform"),
                                              (24, 300, "softmax", "hetero")])
def test_truncated_fused_route_matches_reference(W, B, K, weights, kind):
    """The port's truncated draw, both routes, against the reference's
    fused truncated kernel (K9 in interpret mode) on the same u and params;
    mismatches only where float64 confirms a tie (none on integers)."""
    w = (_inputs(B + K, B, K)[0] if weights == "int" else _softmax_weights(B + K, B, K))
    u = np.random.default_rng(W).uniform(0, 1, B).astype(np.float32)
    prm = _trunc_params(K, B, kind)
    want = np.asarray(butterfly_sample_truncated_pallas(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(prm), W=W, interpret=True))
    for route in ROUTES:
        got = ops.butterfly_sample_truncated(torch.as_tensor(w), torch.as_tensor(u),
                                             torch.as_tensor(prm), W=W, route=route)
        res = trunc_boundary_ties(got, want, w, u, prm)
        # ties are allowed by the rule but expected to be 0 at these seeds
        assert res["faults"] == 0 and res["mismatches"] == 0, (route, res)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("weights", ["int", "softmax"])
def test_truncated_two_pass_matches_reference_kernels(S, weights):
    """Masked pass A (K11) and masked pass B (K12) against the reference's
    masked_blocksums / walk_trunc Pallas kernels (interpret mode), called
    directly since its route switch needs Kp > 131,072; the same tau."""
    B, K, W = 12, 500, 16
    w = (_inputs(7, B, K)[0] if weights == "int" else _softmax_weights(7, B, K))
    prm = _trunc_params(3, B, "hetero")
    tau = np.asarray(jtr.thresholds_from_params(jnp.asarray(w), jnp.asarray(prm)))
    np.testing.assert_array_equal(
        ttr.thresholds_from_params(torch.as_tensor(w), torch.as_tensor(prm)).numpy(), tau)
    jwp, jtaup, jrun = _build_masked_sums_impl(jnp.asarray(w), jnp.asarray(tau), W, 8,
                                               4 * W, True)
    nb = KB.num_blocks(K, W)
    run = KB.masked_blocksums_torch(torch.as_tensor(w), torch.as_tensor(tau), W, nb)
    if weights == "int":
        np.testing.assert_array_equal(run.numpy(), np.asarray(jrun)[:B, :nb])
    else:
        np.testing.assert_allclose(run.numpy(), np.asarray(jrun)[:B, :nb],
                                   rtol=(W + nb) * 2.0 ** -23)
    rng = np.random.default_rng(S)
    u = rng.uniform(0, 1, (S, B) if S > 1 else (B,)).astype(np.float32)
    want = np.asarray(_trunc_draw_from_sums_impl(jwp, jtaup, jrun, jnp.asarray(u), B, K,
                                                 W, 8, True))
    rows = torch.arange(B, dtype=torch.int32).repeat(S)
    got = KB.walk_trunc_torch(torch.as_tensor(w), run, torch.as_tensor(u.reshape(-1)),
                              torch.as_tensor(tau), rows, W).clamp(max=K - 1)
    wm = np.where(w >= tau[:, None], w, 0.0).astype(np.float32)
    res = boundary_ties(got.view(u.shape), want, wm, u)
    assert res["faults"] == 0 and res["mismatches"] == 0, res
    # the entry point's two-pass route takes (S, B) uniforms in one walk
    ent = ops.butterfly_sample_truncated(torch.as_tensor(w), torch.as_tensor(u),
                                         torch.as_tensor(prm), W=W)
    assert ent.shape == u.shape
    np.testing.assert_array_equal(ent.numpy(), got.view(u.shape).numpy())


def test_truncated_bf16_zero_rows_and_disabled():
    """bf16 weights (integers below 256 are exact) draw as the reference's;
    all-zero rows draw K-1; all stages disabled is the plain draw."""
    B, K, W = 16, 128, 8
    w, u = _inputs(2, B, K)
    w = np.minimum(w, 255)
    w[::5] = 0
    prm = _trunc_params(4, B, "hetero")
    tw = torch.as_tensor(w).to(torch.bfloat16)
    want = np.asarray(butterfly_sample_truncated_pallas(
        jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(u), jnp.asarray(prm), W=W,
        interpret=True))
    for route in ROUTES[1:]:
        got = ops.butterfly_sample_truncated(tw, torch.as_tensor(u), torch.as_tensor(prm),
                                             W=W, route=route)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[::5] == K - 1).all()
    off = torch.tensor([[0.0, 1.0, 0.0]]).repeat(B, 1)
    np.testing.assert_array_equal(
        ops.butterfly_sample_truncated(torch.as_tensor(w), torch.as_tensor(u), off,
                                       W=W).numpy(),
        ops.butterfly_sample(torch.as_tensor(w), torch.as_tensor(u), W=W).numpy())


def test_truncated_checks_and_later_slices():
    w, u = torch.ones(4, 40), torch.full((4,), 0.5)
    prm = torch.tensor([[2.0, 0.9, 0.0]]).repeat(4, 1)
    with pytest.raises(ValueError, match="params"):
        ops.butterfly_sample_truncated(w, u, prm[:, :2], W=8)
    with pytest.raises(ValueError, match="route"):
        ops.butterfly_sample_truncated(w, u, prm, W=8, route="sorted")
    with pytest.raises(ValueError, match="two-pass"):
        ops.butterfly_sample_truncated(w, torch.rand(3, 4), prm, W=8, route="fused")
    with pytest.raises(ValueError, match="CUDA"):
        KB.fused_trunc_draw(w, u, prm, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.butterfly_sample_truncated(w, u, prm, W=8, impl="cuda")
    # the seeded draws (K5, K10; ported with the sharded sampler) take the
    # same checks
    seed = np.array([1, 2], np.uint32)
    with pytest.raises(ValueError, match="params"):
        ops.butterfly_sample_truncated_rng(w, seed, prm[:, :2], W=8)
    with pytest.raises(ValueError, match="route"):
        ops.butterfly_sample_rng(w, seed, W=8, route="sorted")
    with pytest.raises(ValueError, match="CUDA"):
        ops.butterfly_sample_truncated_rng(w, seed, prm, W=8, impl="cuda")
    assert ops.butterfly_sample_rng(w, seed, W=8).shape == (4,)
    # K9 stages a row in shared memory while it fits its 227 KB
    assert KB.trunc_row_staged(32000, 250, 128)
    assert not KB.trunc_row_staged(256000, 2000, 128)
