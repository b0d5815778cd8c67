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
