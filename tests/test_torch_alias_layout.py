"""K13's three layouts as exact-order CPU models
(``alias_build.ref.assemble_{block,group,split}_order_torch``), held bit
for bit against each other before the card holds the kernels to them, the
block model against the reference's ``_assemble`` (its XLA twin, on the
CPU), and K13's layout rule.

Tolerances: the models make the same fp32 adds in the same order, so prob
and apos are equal (``torch.equal``).  Against the reference, apos is
equal and prob within ``ref.prob_tolerance(Kp)``: prob is a difference of
prefix sums of magnitude up to Kp, and XLA's cumsum adds in another order
than the kernel's chunked scan.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.alias_build import kernel as jk
from repro.kernels.alias_build import ops as jops
from repro_torch.kernels.alias_build import kernel as KA
from repro_torch.kernels.alias_build import ops as aops
from repro_torch.kernels.alias_build import ref

CU = Path(KA.__file__).parent / "csrc" / "alias_build.cu"


def _padded(w: torch.Tensor):
    """The device build's assembly inputs: partitioned scaled weights
    padded with s = 1 to the next power of two, light counts, ranks."""
    s, _o, _i, nL = aops._partition(w)
    K = w.shape[1]
    Kp = aops._next_pow2(K)
    sp = torch.nn.functional.pad(s, (0, Kp - K), value=1.0).contiguous()
    return sp, nL, aops._merged_rank(sp, nL)


def _dirichlet(seed, B, K):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.dirichlet(np.full(K, 0.3), size=B).astype(np.float32))


def _edge_rows(K: int):
    """K a power of two: a Dirichlet row, a zero-weight row, an all-light
    row (uniform weights: every s = 1, nL = Kp) and an all-pad row (s = 1,
    nL = 0: every entry a pseudo-heavy)."""
    w = _dirichlet(K, 4, K)
    w[1] = 0.0
    w[2] = 1.0
    sp, nL, rank = _padded(w[:3])
    ones = torch.ones(1, K)
    zero = torch.zeros(1, dtype=torch.int32)
    sp = torch.cat([sp, ones])
    nL = torch.cat([nL, zero])
    rank = torch.cat([rank, aops._merged_rank(ones, zero)])
    assert nL.tolist()[1:] == [K, K, 0]
    return sp, nL, rank


CASES = {
    "phi-like (257, 240)": lambda: _padded(_dirichlet(0, 257, 240)),
    "(5, 4096)": lambda: _padded(_dirichlet(1, 5, 4096)),
    "(3, 70000) Kp=131072": lambda: _padded(_dirichlet(2, 3, 70000)),
    "(2, 256000) Kp=262144": lambda: _padded(_dirichlet(3, 2, 256000)),
    "edge rows Kp=256": lambda: _edge_rows(256),
    "edge rows Kp=4096": lambda: _edge_rows(4096),
    "Kp=64 (16 lanes a group)": lambda: _padded(_dirichlet(4, 9, 50)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_layout_models_bit_equal(case):
    """The block model against the group model (Kp <= 1,024) or the split
    model (wider rows), and both against the plain version's apos."""
    sp, nL, rank = CASES[case]()
    Kp = sp.shape[1]
    pb, ab = ref.assemble_block_order_torch(sp, nL, rank)
    other = (ref.assemble_group_order_torch if Kp <= KA.GROUP_MAX_KP
             else ref.assemble_split_order_torch)
    po, ao = other(sp, nL, rank)
    assert torch.equal(pb, po) and torch.equal(ab, ao)
    pp, ap = KA.alias_assemble_torch(sp, nL, rank)
    assert torch.equal(ab, ap)
    torch.testing.assert_close(pb, pp, rtol=0, atol=ref.prob_tolerance(Kp))


@pytest.mark.parametrize("case", list(CASES))
def test_block_model_matches_reference(case):
    """The block model against the reference's ``_assemble`` (the XLA twin
    of its Pallas kernel) on the same inputs."""
    sp, nL, rank = CASES[case]()
    Kp = sp.shape[1]
    pb, ab = ref.assemble_block_order_torch(sp, nL, rank)
    jp, ja = jk._assemble(jnp.asarray(sp.numpy()), jnp.asarray(nL.numpy()),
                          jnp.asarray(rank.numpy()), jops._gather_rows_xla)
    np.testing.assert_array_equal(ab.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jp), rtol=0,
                               atol=ref.prob_tolerance(Kp))


@pytest.mark.parametrize("Kp", [4, 8, 16, 32, 128, 512, 1024])
def test_group_model_every_group_width(Kp):
    """Every group width the kernel instantiates (L = Kp / 4 lanes, 1 ..
    256), with a zero-weight and an all-light row, against the block
    model."""
    w = _dirichlet(Kp, 6, Kp)
    w[1] = 0.0
    w[2] = 1.0
    sp, nL, rank = _padded(w)
    pb, ab = ref.assemble_block_order_torch(sp, nL, rank)
    pg, ag = ref.assemble_group_order_torch(sp, nL, rank)
    assert torch.equal(pb, pg) and torch.equal(ab, ag)


def test_models_reject_shapes_outside_their_layout():
    s, nL, rank = _padded(_dirichlet(5, 2, 3000))
    with pytest.raises(ValueError, match="group"):
        ref.assemble_group_order_torch(s, nL, rank)
    s, nL, rank = _padded(_dirichlet(6, 2, 600))
    with pytest.raises(ValueError, match="split"):
        ref.assemble_split_order_torch(s, nL, rank)


@pytest.mark.parametrize("B,Kp,want", [
    (37286, 256, "group"), (1, 4, "group"), (64, 1024, "group"),
    (64, 262144, "split"), (4, 131072, "split"), (1, KA.SPLIT_MIN_KP, "split"),
    (32768, 32768, "split"), (65535, 262144, "split"), (65536, 262144, "block"),
    (64, KA.SPLIT_MIN_KP - 1024, "block"), (64, 4096, "block"), (3, 2, "block"),
    (3, 1, "block"), (8, 300, "block"), (8, KA.SPLIT_MIN_KP + 1000, "block"),
])
def test_alias_layout_rule(B, Kp, want):
    assert KA.alias_layout(B, Kp) == want


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper sizes the split's scratch and reads the chunk width from
    constants of alias_build.cu; they must agree."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))

    assert const("kThreads") * const("kItems") == KA.CHUNK
    assert const("kTStride") == KA._T_STRIDE
    assert const("kThreads") // 32 == KA._WARPS
    # the split's scratch: a term per slot and chunk, the terms and the
    # carry per chunk, a light sum per warp slot
    assert KA._split_work_floats(64, 262144) == 64 * (65536 + 17 * 256 + 8)


def test_wrapper_rejects_unknown_layouts_and_cpu_tensors():
    s, nL, rank = _padded(_dirichlet(7, 2, 240))
    with pytest.raises(ValueError, match="layout must be one of"):
        KA._alias_assemble(s, nL, rank, layout="rows")
    with pytest.raises(ValueError, match="CUDA tensor"):
        KA._alias_assemble(s, nL, rank, layout="group")
