"""The layouts of the draws on given weights, on the CPU: K3's walk by a
group of W / 4 lanes and K4/K5's row split over several thread blocks,
each as an exact-order model of the card's arithmetic, held against the
plain versions bit for bit, and the group walk against the reference's
Pallas pass B (interpret mode) on the same numpy inputs.  The layout rule
and the private ``layout=`` argument are pure Python and are checked here
too; the kernels themselves are held against these models on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: none.  The models make the same fp32 adds in the same order as
the plain versions (the walk) or as the warp-order model of K11 (the
sums), so every index and every sum must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.butterfly_sample.kernel import (
    build_block_sums_pallas,
    sample_from_block_sums_pallas,
)
from repro_torch.kernels.butterfly_sample import kernel as KB
from repro_torch.kernels.butterfly_sample import ref

GRID_W = [8, 16, 32, 64, 128]


def _weights(seed, B, K, kind="int"):
    g = np.random.default_rng(seed)
    if kind == "int":
        w = g.integers(1, 1000, size=(B, K)).astype(np.float32)
    else:
        w = g.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)
    return w


def _uniforms(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, size=n).astype(np.float32)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("W", GRID_W)
def test_group_walk_model_equals_walk_torch(W, S):
    """The group walk's exact-order model equals ``walk_torch`` bit for
    bit: integer and Dirichlet weights, bf16, all-zero rows, and row widths
    with ncols % 4 != 0 (the card's scalar-load instantiation) and a
    padded last block."""
    B = 40
    for K in (240, 4 * W + 3, 1000, 2001):
        for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                            ("int", torch.bfloat16)):
            w = torch.as_tensor(_weights(K + W + S, B, K, kind)).to(dtype)
            w[::7] = 0  # all-zero rows draw the last block
            nb = KB.num_blocks(K, W)
            run = KB.blocksums_torch(w, W, nb)
            u = torch.as_tensor(_uniforms(K * S + W, S * B))
            rows = torch.arange(B, dtype=torch.int32).repeat(S)
            got = ref.group_walk_order_torch(w, run, u, rows, W)
            want = KB.walk_torch(w, run, u, rows, W)
            assert got.dtype == torch.int32
            assert torch.equal(got, want), (K, kind, dtype)
            assert bool((got[:B][::7] == nb * W - 1).all())


@pytest.mark.parametrize("W", GRID_W)
def test_group_walk_model_equals_reference_pass_b(W):
    """On integer weights (every fp32 sum exact) the model draws what the
    reference's pass B draws from its own block sums, S = 1 and 4."""
    B, K = 16, 8 * W + 5
    w = _weights(W, B, K)
    jwp, jrun = build_block_sums_pallas(jnp.asarray(w), W=W, tb=8)
    nb = KB.num_blocks(K, W)
    run = torch.as_tensor(np.array(jrun)[:B, :nb])
    for S in (1, 4):
        u = _uniforms(W + S, S * B)
        uj = u.reshape(S, B) if S > 1 else u
        want = np.asarray(sample_from_block_sums_pallas(jwp, jrun, jnp.asarray(uj), B=B, K=K,
                                                        W=W, tb=8))
        rows = torch.arange(B, dtype=torch.int32).repeat(S)
        got = ref.group_walk_order_torch(torch.as_tensor(w), run, torch.as_tensor(u), rows, W)
        np.testing.assert_array_equal(got.clamp(max=K - 1).numpy(), want.reshape(-1))


@pytest.mark.parametrize("W", GRID_W)
def test_split_running_model_equals_warp_order(W):
    """The split layout's running sums, for several blocks per row and
    several scan chunks, equal K11's warp-order model with nothing masked
    bit for bit: splitting a row changes no add."""
    B = 6
    for K in (240, 5000, 20011):
        for kind in ("int", "dirichlet"):
            w = torch.as_tensor(_weights(K + W, B, K, kind))
            nb = KB.num_blocks(K, W)
            want = ref.masked_blocksums_warp_order_torch(
                w, torch.full((B,), -float("inf")), W, nb)
            nt = -(-nb * W // ref.TILE)
            for P in sorted({1, 2, 3, 7, nt}):
                for chunk in (32, 96, 4096):
                    got = ref.split_running_order_torch(w, W, nb, P, chunk)
                    assert torch.equal(got, want), (K, kind, P, chunk)


def test_split_running_model_equals_plain_on_integer_weights():
    w = torch.as_tensor(_weights(3, 4, 3001))
    for W in GRID_W:
        nb = KB.num_blocks(3001, W)
        assert torch.equal(ref.split_running_order_torch(w, W, nb, 5, 64),
                           KB.blocksums_torch(w, W, nb))


@pytest.mark.parametrize("B,nb,W,layout", [
    (27392, 15, 16, "warp"),    # the sweep's chunk: K = 240
    (27392, 8, 32, "warp"),
    (64, 2000, 128, "split"),   # a 256,000-token vocabulary
    (8, 2000, 128, "split"),
    (64, 250, 128, "split"),    # 32,000 tokens
])
def test_fused_layout_rule(B, nb, W, layout):
    assert KB.fused_layout(B, nb, W) == layout
    assert KB.fused_layout(B, nb, W) in KB.LAYOUTS


def test_private_layout_argument_rejects_unknown_names():
    w = torch.ones((4, 240))
    u = torch.full((4,), 0.5)
    seed2 = torch.tensor([1, 2], dtype=torch.int64)
    for bad in ("rows", "blocks", "", "Split"):
        with pytest.raises(ValueError, match="layout"):
            KB._fused_draw(w, u, 16, layout=bad)
        with pytest.raises(ValueError, match="layout"):
            KB._fused_draw_rng(w, seed2, 0, 16, layout=bad)
    # a known layout gets past the name check to the device check
    for layout in KB.LAYOUTS:
        with pytest.raises(ValueError, match="CUDA"):
            KB._fused_draw(w, u, 16, layout=layout)


def test_walk_vector_loads_rule():
    """One 16-byte load per lane needs every row start aligned: a row width
    that is a multiple of 4 on an aligned base."""
    base = torch.zeros((8, 244))
    assert KB.walk_vector_loads(base)
    assert not KB.walk_vector_loads(torch.zeros((8, 243)))
    assert not KB.walk_vector_loads(base.view(-1)[1:1 + 8 * 240].view(8, 240))
    assert KB.walk_vector_loads(torch.zeros((8, 240), dtype=torch.bfloat16))
    assert not KB.walk_vector_loads(torch.zeros((8, 242), dtype=torch.bfloat16))


def _trunc_case(seed, B, K, W, kind, S):
    """Weights, per-row tau, K11's plain running sums of the masked rows and
    S draws per row: rows that tie at tau, rows with one survivor, all-zero
    rows, and (K % W != 0) a last block that ends mid-block."""
    g = np.random.default_rng(seed)
    if kind == "int":
        w = torch.as_tensor(g.integers(1, 50, size=(B, K)).astype(np.float32))
    else:
        w = torch.as_tensor(g.dirichlet(np.full(K, 0.3), size=B).astype(np.float32))
    w[1] = w[1, 0]                      # every weight tied at tau
    w[2, K // 2] = w[2].max() * 2       # one survivor of tau = its weight
    w[3] = 0                            # all zero: draws the last block
    tau = torch.quantile(w, 0.9, dim=1).to(torch.float32)
    tau[0] = 0.0                        # nothing masked
    tau[2] = w[2, K // 2]
    tau[4] = w[4].max()                 # ties at the row max only
    nb = KB.num_blocks(K, W)
    run = KB.masked_blocksums_torch(w, tau, W, nb)
    u = torch.as_tensor(_uniforms(seed + S, S * B))
    rows = torch.arange(B, dtype=torch.int32).repeat(S)
    return w, tau, run, u, rows


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("W", GRID_W)
def test_walk_trunc_group_model_equals_walk_trunc_torch(W, S):
    """K12's group layout is K3's group walk on the masked rows
    (``ref.group_walk_order_torch`` of w * [w >= tau]): equal to
    ``walk_trunc_torch`` bit for bit on integer and Dirichlet weights,
    bf16, tied and all-masked-but-one rows, zero rows and rows whose last
    block ends mid-block (K % 4 != 0 included)."""
    B = 24
    for K in (240, 4 * W + 3, 1000, 2001):
        for kind, dtype in (("int", torch.float32), ("dirichlet", torch.float32),
                            ("int", torch.bfloat16)):
            w, tau, run, u, rows = _trunc_case(K + W + S, B, K, W, kind, S)
            w = w.to(dtype)
            masked = KB._mask(w.float(), tau)
            got = ref.group_walk_order_torch(masked, run, u, rows, W)
            want = KB.walk_trunc_torch(w, run, u, tau, rows, W)
            assert got.dtype == torch.int32
            assert torch.equal(got, want.to(torch.int32)), (K, kind, dtype)
            assert bool((got[3::B] == KB.num_blocks(K, W) * W - 1).all())
            assert bool((got[2::B] == K // 2).all())


@pytest.mark.parametrize("nb", [1, 8, 250, 2000])
@pytest.mark.parametrize("W", GRID_W)
def test_walk_trunc_layout_rule(nb, W):
    """K12 takes its group layout at every W and nb: it needs no shared
    memory."""
    assert KB.walk_trunc_layout(nb, W) == "group"
    assert KB.walk_trunc_layout(nb, W) in KB.WALK_TRUNC_LAYOUTS


def test_private_walk_trunc_layout_argument_rejects_unknown_names():
    w = torch.ones((4, 240))
    run = torch.ones((4, 2))
    tau = torch.zeros(4)
    u = torch.full((4,), 0.5)
    rows = torch.zeros((4,), dtype=torch.int32)
    for bad in ("split", "warps", "", "Group"):
        with pytest.raises(ValueError, match="layout"):
            KB._walk_trunc(w, run, u, tau, rows, 128, layout=bad)
    for layout in KB.WALK_TRUNC_LAYOUTS:  # a known layout gets past the name check
        with pytest.raises(ValueError, match="CUDA"):
            KB._walk_trunc(w, run, u, tau, rows, 128, layout=layout)
    with pytest.raises(ValueError, match="power of two"):
        KB.walk_trunc_layout(8, 4)
