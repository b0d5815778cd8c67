"""The redesigned layouts of K8 and K7 (a group of W / 4 lanes per
factored draw) and K2 (a wide row split over several thread blocks, four
columns a lane),
on the CPU, as exact-order models of the card's arithmetic: the two
layouts of each held against each other bit for bit, and on integer
factors against the plain version and the reference's Pallas kernel
(interpret mode) on the same numpy inputs.  The layout rules and the
private ``layout=`` arguments are pure Python and are checked here too;
the kernels themselves are held against these models on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: none.  The models of one kernel's layouts make the same fp32
adds in the same order, so every index and every sum must be equal; on
integer factors every fp32 sum is exact, so the reference draws the same
indices too."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lda_draw import ops as jops
from repro.kernels.lda_draw.kernel import lda_draw_docs_pallas
from repro_torch.kernels.butterfly_sample import kernel as KB
from repro_torch.kernels.butterfly_sample import ref as bref
from repro_torch.kernels.lda_draw import kernel as KL
from repro_torch.kernels.lda_draw import ref as lref

GRID_W = [8, 16, 32, 64, 128]
GRID_K = [16, 61, 240, 1000]


def _factors(seed, K, kind, C=12, V=40, B=96):
    g = np.random.default_rng(seed)
    if kind == "int":
        th = g.integers(1, 100, size=(C, K)).astype(np.float32)
        ph = g.integers(1, 100, size=(V, K)).astype(np.float32)
    else:
        th = g.dirichlet(np.full(K, 0.3), size=C).astype(np.float32)
        ph = g.dirichlet(np.full(V, 0.3), size=K).T.astype(np.float32).copy()
    th[::5] = 0  # all-zero theta rows draw the last block
    d = g.integers(0, C, size=B).astype(np.int32)
    w = g.integers(0, V, size=B).astype(np.int32)
    u = g.uniform(0, 1, size=B).astype(np.float32)
    return th, ph, d, w, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", GRID_K)
@pytest.mark.parametrize("W", GRID_W)
def test_group_model_equals_warp_model(W, K, dtype):
    """K8's group layout (four columns a lane, G = W / 4 lanes a draw)
    makes the warp layout's adds: equal draws bit for bit on Dirichlet
    factors, all-zero rows included (they draw the last column)."""
    th, ph, d, w, u = _factors(W + K, K, "dirichlet")
    tt, tp = (torch.as_tensor(x).to(dtype) for x in (th, ph))
    td, tw, tu = (torch.as_tensor(x) for x in (d, w, u))
    warp = lref.fused_warp_order_torch(tt, tp, td, tw, tu, W)
    group = lref.fused_group_order_torch(tt, tp, td, tw, tu, W)
    assert group.dtype == torch.int32
    assert torch.equal(group, warp)
    zero = torch.as_tensor(d % 5 == 0)
    assert bool((group[zero] == KB.num_blocks(K, W) * W - 1).all())


@pytest.mark.parametrize("K", GRID_K)
@pytest.mark.parametrize("W", GRID_W)
def test_layout_models_equal_plain_and_reference_on_integer_factors(W, K):
    """On integer factors (every fp32 sum exact) both layouts' models draw
    what ``lda_fused_draw_torch`` draws and what the reference's fused
    Pallas kernel draws (interpret mode), clipped to K - 1 as the entry
    points clip."""
    th, ph, d, w, u = _factors(3 * W + K, K, "int")
    tt, tp, td, tw, tu = (torch.as_tensor(x) for x in (th, ph, d, w, u))
    plain = KL.lda_fused_draw_torch(tt, tp, td, tw, tu, W)
    warp = lref.fused_warp_order_torch(tt, tp, td, tw, tu, W)
    group = lref.fused_group_order_torch(tt, tp, td, tw, tu, W)
    assert torch.equal(warp, plain)
    assert torch.equal(group, plain)
    want = np.asarray(lda_draw_docs_pallas(*(jnp.asarray(x) for x in (th, ph, d, w, u)),
                                           W=W, interpret=True))
    np.testing.assert_array_equal(group.clamp(max=K - 1).numpy(), want)


@pytest.mark.parametrize("W", GRID_W)
def test_four_column_block_sums_equal_warp_order(W):
    """A block summed by lanes of four columns (K2's split, K8's group)
    equals the block summed by lanes of one column (``warp_block_sums``,
    ``tile_block_sums``) bit for bit."""
    g = np.random.default_rng(W)
    x = torch.as_tensor(g.dirichlet(np.full(64 * W, 0.3), size=8).astype(np.float32))
    one = bref.masked_blocksums_warp_order_torch(x, torch.full((8,), -float("inf")), W, 64)
    four = bref.warp_running_order_torch(bref.block_sums4_order_torch(x, W))
    assert torch.equal(four, one)


@pytest.mark.parametrize("B,K,W", [(64, 256000, 128), (8, 32000, 128), (64, 4096, 64),
                                   (8, 256000, 128), (3, 20011, 8), (64, 4099, 32)])
def test_k2_split_model_equals_warp_order(B, K, W):
    """K2's split layout at the H100's P (``split_blocks_per_row`` with 132
    SMs): runs of 128-column tiles summed four columns a lane, the last
    block's scan in chunks of 4,096, equal to the warp layout's sums bit
    for bit; on integer weights also to ``blocksums_torch``."""
    nb = KB.num_blocks(K, W)
    P = bref.split_blocks_per_row(B, nb, W)
    assert 1 <= P <= -(-nb * W // bref.TILE)
    for kind in ("dirichlet", "int"):
        g = np.random.default_rng(B + K + W)
        if kind == "int":
            # below 2**24 at every partial sum: exact in fp32
            w = torch.as_tensor(g.integers(0, 64, size=(B, K)).astype(np.float32))
        else:
            w = torch.as_tensor(g.gamma(0.3, size=(B, K)).astype(np.float32))
        w[::3] = 0
        got = bref.split_running_order_torch(w, W, nb, P, cols_per_lane=4)
        want = bref.masked_blocksums_warp_order_torch(w, torch.full((B,), -float("inf")),
                                                      W, nb)
        assert torch.equal(got, want), kind
        if kind == "int":
            assert torch.equal(got, KB.blocksums_torch(w, W, nb))


@pytest.mark.parametrize("name,cuda_name", [("TILE", "kTile"),
                                             ("SUM_BLOCKS_PER_SM", "kSumBlocksPerSM"),
                                             ("MIN_BLOCKS_PER_RUN", "kMinBlocksPerRun"),
                                             ("SCAN_CHUNK", "kScanChunk")])
def test_split_constants_mirror_draw_tile(name, cuda_name):
    """The split row's sizing constants of the CPU models are those that
    ``draw_tile.cuh`` compiles into K2, K4/K5 and K11."""
    src = (Path(KB.__file__).parents[1] / "csrc" / "draw_tile.cuh").read_text()
    found = re.search(rf"constexpr int {cuda_name} = (\d+);", src)
    assert found is not None, cuda_name
    assert getattr(bref, name) == int(found.group(1))


@pytest.mark.parametrize("B,nb,W,P", [(64, 2000, 128, 17), (8, 2000, 128, 61),
                                      (64, 250, 128, 7), (27392, 15, 16, 1),
                                      (64, 64, 64, 2), (2000, 100000, 8, 25)])
def test_split_blocks_per_row_mirrors_the_card(B, nb, W, P):
    """The CPU mirror of ``split_tiles_per_block`` at 132 SMs: enough
    blocks to fill the card, at least 32 W-blocks each, at most about
    4,096."""
    assert bref.split_blocks_per_row(B, nb, W) == P


@pytest.mark.parametrize("nb,W,layout", [
    (8, 32, "group"),      # the sweep's chunk: K = 240
    (15, 16, "group"),
    (94, 32, "group"),     # K = 3,000
    (341, 8, "warp"),      # W = 8 keeps 64 draws a block: 87 KB of sums
    (192, 8, "group"),
    (24, 128, "group"),
])
def test_lda_fused_layout_rule(nb, W, layout):
    assert KL.lda_fused_layout(nb, W) == layout
    assert KL.lda_fused_layout(nb, W) in KL.LAYOUTS
    assert KL.group_fits(nb, W) == (layout == "group")


@pytest.mark.parametrize("B,nb,W,layout", [
    (27392, 15, 16, "warp"),    # the chunk keeps one warp per row
    (64, 2000, 128, "split"),   # a 256,000-token vocabulary
    (8, 2000, 128, "split"),
    (64, 250, 128, "split"),
    (27392, 32, 64, "split"),   # 2,048 columns: the split at any B
    (27392, 32, 16, "warp"),    # 512 columns, many rows
    (1024, 32, 16, "warp"),     # 512 columns, few rows
    (64, 8, 64, "warp"),
    (1025, 16, 32, "warp"),
    (64, 15, 16, "warp"),       # below 512 columns
])
def test_blocksums_layout_rule(B, nb, W, layout):
    """K2's rule is K4/K5's: the split from 2,048 columns at any B, so that
    the two-pass route (K2 + K3) and the fused one (K4) of a shape run
    the same layout."""
    assert KB.blocksums_layout(B, nb, W) == layout
    assert layout in KB.LAYOUTS
    assert KB.fused_layout(B, nb, W) == layout


def test_private_layout_arguments_reject_unknown_names():
    th = torch.ones((4, 240))
    ph = torch.ones((9, 240))
    ids = torch.zeros((4,), dtype=torch.int32)
    u = torch.full((4,), 0.5)
    for bad in ("split", "warps", "", "Group"):
        with pytest.raises(ValueError, match="layout"):
            KL._lda_fused_draw(th, ph, ids, ids, u, 32, layout=bad)
    for bad in ("group", "rows", "", "Split"):
        with pytest.raises(ValueError, match="layout"):
            KB._blocksums(th, 16, 15, layout=bad)
    # a known layout gets past the name check to the device check
    for layout in KL.LAYOUTS:
        with pytest.raises(ValueError, match="CUDA"):
            KL._lda_fused_draw(th, ph, ids, ids, u, 32, layout=layout)
    for layout in KB.LAYOUTS:
        with pytest.raises(ValueError, match="CUDA"):
            KB._blocksums(th, 16, 15, layout=layout)


def test_group_layout_checks_its_own_shared_memory():
    """The group layout fits rows that the warp layout does not (and the
    other way round at W = 8); the fused / two-pass route takes K8 where
    either fits (``test_lda_draw_docs_route_switch``)."""
    assert KL.group_fits(94, 32) and not KL.fused_fits(94, 32)
    assert KL.fused_fits(341, 8) and not KL.group_fits(341, 8)
    assert KL.fused_fits(8, 32) and KL.group_fits(8, 32)


def _walk_inputs(th, ph, d, w, u, W, S, dtype=torch.float32):
    """K7's inputs for S draws per sample: factors in ``dtype``, the plain
    running sums of each sample, and draw s * B + i on running row i."""
    tt, tp = (torch.as_tensor(x).to(dtype) for x in (th, ph))
    td, tw = torch.as_tensor(d), torch.as_tensor(w)
    B = td.shape[0]
    run = KL.lda_blocksums_torch(tt, tp, td, tw, W, KB.num_blocks(th.shape[1], W))
    uu = torch.as_tensor(np.random.default_rng(S + W).uniform(0, 1, size=S * B)
                         .astype(np.float32)) if S > 1 else torch.as_tensor(u)
    rows = torch.arange(B, dtype=torch.int32).repeat(S)
    return tt, tp, run, uu, rows, td[rows.long()], tw[rows.long()]


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("K,dtype", [(240, torch.float32), (239, torch.float32),
                                     (240, torch.bfloat16), (61, torch.float32)])
@pytest.mark.parametrize("W", GRID_W)
def test_walk_group_model_equals_plain_walk(W, K, dtype, S):
    """K7's group layout (four columns a lane, G = W / 4 lanes a draw)
    makes ``lda_walk_torch``'s adds: equal draws bit for bit on Dirichlet
    factors, S draws per sample through ``rows``, K = 239 (ncols % 4 !=
    0), bf16 and all-zero theta rows (which draw the last column)."""
    th, ph, d, w, u = _factors(W + K + S, K, "dirichlet")
    tt, tp, run, uu, rows, dd, ww = _walk_inputs(th, ph, d, w, u, W, S, dtype)
    plain = KL.lda_walk_torch(tt, tp, run, uu, rows, dd, ww, W)
    group = lref.walk_group_order_torch(tt, tp, run, uu, rows, dd, ww, W)
    assert group.dtype == torch.int32
    assert torch.equal(group, plain.to(torch.int32))
    zero = torch.as_tensor(d % 5 == 0).repeat(S)
    assert bool((group[zero] == KB.num_blocks(K, W) * W - 1).all())


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("W,K", [(8, 61), (16, 240), (32, 239)])
def test_walk_group_model_equals_reference_on_integer_factors(W, K, S):
    """On integer factors (every fp32 sum exact) K7's group model draws
    what the reference's table-in Pallas walk (``lda_walk_pallas``,
    interpret mode) draws from the reference's own running sums, clipped
    to K - 1 as the entry points clip."""
    th, ph, d, w, u = _factors(5 * W + K + S, K, "int")
    tt, tp, run, uu, rows, dd, ww = _walk_inputs(th, ph, d, w, u, W, S)
    jtp, jpp, jrun = jops.lda_build_running(*(jnp.asarray(x) for x in (th, ph, d, w)),
                                            W=W, impl="xla")
    np.testing.assert_array_equal(run.numpy(), np.asarray(jrun))
    ju = jnp.asarray(uu.numpy().reshape(S, -1) if S > 1 else uu.numpy())
    want = jops.lda_draw_from_running(jtp, jpp, jrun, ju, jnp.asarray(d), jnp.asarray(w),
                                      K=K, W=W, impl="pallas", interpret=True)
    group = lref.walk_group_order_torch(tt, tp, run, uu, rows, dd, ww, W)
    np.testing.assert_array_equal(group.clamp(max=K - 1).numpy(),
                                  np.asarray(want).reshape(-1))


@pytest.mark.parametrize("nb", [1, 8, 94, 2000])
@pytest.mark.parametrize("W", GRID_W)
def test_lda_walk_layout_rule(nb, W):
    """K7 takes its group layout at every W and nb: it needs no shared
    memory."""
    assert KL.lda_walk_layout(nb, W) == "group"
    assert KL.lda_walk_layout(nb, W) in KL.LAYOUTS


def test_private_walk_layout_argument_rejects_unknown_names():
    th = torch.ones((4, 240))
    ph = torch.ones((9, 240))
    ids = torch.zeros((4,), dtype=torch.int32)
    u = torch.full((4,), 0.5)
    run = torch.ones((4, 8))
    for bad in ("split", "warps", "", "Group"):
        with pytest.raises(ValueError, match="layout"):
            KL._lda_walk(th, ph, run, u, ids, ids, ids, 32, layout=bad)
    for layout in KL.LAYOUTS:  # a known layout gets past the name check
        with pytest.raises(ValueError, match="CUDA"):
            KL._lda_walk(th, ph, run, u, ids, ids, ids, 32, layout=layout)
    with pytest.raises(ValueError, match="power of two"):
        KL.lda_walk_layout(8, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [240, 1000, 3000])
@pytest.mark.parametrize("W", GRID_W)
def test_blocksums_group_model_equals_warp_model(W, K, dtype):
    """K6's group layout (four columns a lane, G = W / 4 lanes a sample)
    forms the warp layout's running sums bit for bit on Dirichlet factors,
    all-zero theta rows included; on integer factors both equal
    ``lda_blocksums_torch``."""
    for kind in ("dirichlet", "int"):
        th, ph, d, w, _ = _factors(7 * W + K, K, kind, B=512)
        tt, tp = (torch.as_tensor(x).to(dtype) for x in (th, ph))
        td, tw = torch.as_tensor(d), torch.as_tensor(w)
        warp = lref.blocksums_warp_order_torch(tt, tp, td, tw, W)
        group = lref.blocksums_group_order_torch(tt, tp, td, tw, W)
        assert group.dtype == torch.float32
        assert group.shape == (512, KB.num_blocks(K, W))
        assert torch.equal(group, warp), kind
        if kind == "int":
            plain = KL.lda_blocksums_torch(tt, tp, td, tw, W, KB.num_blocks(K, W))
            assert torch.equal(group, plain)


@pytest.mark.parametrize("nb,W", [(8, 32), (15, 16), (94, 32), (341, 8), (192, 8),
                                  (24, 128), (375, 8)])
def test_lda_blocksums_layout_rule(nb, W):
    """K6 takes K8's rule: its group layout where the nb sums of every
    sample of a block fit shared memory, else the warp layout."""
    want = "group" if KL.group_fits(nb, W) else "warp"
    assert KL.lda_blocksums_layout(nb, W) == want == KL.lda_fused_layout(nb, W)
    assert want in KL.LAYOUTS


def test_private_blocksums_layout_argument_rejects_unknown_names():
    th = torch.ones((4, 240))
    ph = torch.ones((9, 240))
    ids = torch.zeros((4,), dtype=torch.int32)
    for bad in ("split", "warps", "", "Group"):
        with pytest.raises(ValueError, match="layout"):
            KL._lda_blocksums(th, ph, ids, ids, 32, 8, layout=bad)
    for layout in KL.LAYOUTS:  # a known layout gets past the name check
        with pytest.raises(ValueError, match="CUDA"):
            KL._lda_blocksums(th, ph, ids, ids, 32, 8, layout=layout)


@pytest.mark.parametrize("K,W,route", [(240, 32, "fused"), (3000, 32, "fused"),
                                       (3000, 8, "two_pass"), (2728, 8, "fused"),
                                       (400000, 128, "two_pass")])
def test_lda_draw_docs_route_switch(monkeypatch, K, W, route):
    """``lda_draw_docs`` takes the fused kernel (K8) where it fits in
    either layout, K6 + K7 beyond: K = 3,000 at W = 32 fits K8's group
    layout only, K = 2,728 at W = 8 its warp layout only."""
    nb = KB.num_blocks(K, W)
    assert (route == "fused") == (KL.group_fits(nb, W) or KL.fused_fits(nb, W))
    taken = []
    monkeypatch.setattr(KL.runtime, "resolve_impl", lambda impl, like: "cuda")
    monkeypatch.setattr(KL, "lda_fused_draw", lambda *a: taken.append("fused") or a[4])
    monkeypatch.setattr(KL, "lda_blocksums", lambda *a: taken.append("two_pass"))
    monkeypatch.setattr(KL, "lda_walk", lambda *a: a[3])
    th = torch.ones((2, K))
    ids = torch.zeros((3,), dtype=torch.int32)
    KL.lda_draw_docs(th, th, ids, ids, torch.zeros(3), W)
    assert taken == [route]
