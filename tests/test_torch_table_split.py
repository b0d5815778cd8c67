"""K1's split schedule at W = 64 and 128 (a group's W-blocks built by
several thread blocks with no carry, then the running row added in the
serial order), on the CPU, as an exact-order model of the card's
arithmetic: held bit for bit against the serial schedule's model for
several P, and against the reference's Pallas table (interpret mode) on
the same numpy inputs.  The schedule rule, the split's sizing and the
private ``schedule=`` argument are pure Python and are checked here too;
the kernels themselves are held against these models on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: none between the two models, which make the same fp32 adds in
the same order, and none on integer weights, where every fp32 sum is
exact.  Against the reference on Dirichlet weights the running row may
differ by nb fp32 roundings (relative nb * 2**-24): XLA is free to order
its adds; rows 0 .. W-2 must be equal."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.butterfly_table.kernel import butterfly_table_pallas
from repro_torch.kernels.butterfly_table import kernel as KT
from repro_torch.kernels.butterfly_table import ref as tref


def _weights(seed, B, K, kind):
    g = np.random.default_rng(seed)
    if kind == "int":
        return g.integers(1, 100, size=(B, K)).astype(np.float32)
    return g.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)


def _rows(t):
    """(G, nb, W, W) -> the reference's (B, K) layout."""
    G, nb, W, _ = t.shape
    return t.transpose(1, 2).reshape(G * W, nb * W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,B,nb", [(64, 64, 23), (64, 128, 9), (128, 128, 17),
                                    (128, 256, 5)])
def test_split_model_equals_serial_model(W, B, nb, dtype):
    """The split schedule's model equals the serial schedule's bit for bit
    for P in {1, 2, 3, 7, nb} (nb not a multiple of P: runs end mid-row),
    on Dirichlet weights and in bf16."""
    w = torch.as_tensor(_weights(W + B + nb, B, nb * W, "dirichlet")).to(dtype)
    serial = tref.table_serial_order_torch(w, W)
    assert serial.shape == (B // W, nb, W, W) and serial.dtype == torch.float32
    for P in (1, 2, 3, 7, nb):
        assert torch.equal(tref.table_split_order_torch(w, W, P), serial), P


@pytest.mark.parametrize("W,B,nb", [(64, 64, 5), (128, 128, 3), (128, 256, 2)])
def test_split_model_equals_reference_and_plain(W, B, nb):
    """On integer weights the split model equals the reference's Pallas
    table (interpret mode) and the port's plain version exactly; on
    Dirichlet weights rows 0 .. W-2 are equal and the running row within
    nb fp32 roundings."""
    for kind in ("int", "dirichlet"):
        w = _weights(3 * W + nb, B, nb * W, kind)
        got = tref.table_split_order_torch(torch.as_tensor(w), W, P=2)
        want = np.asarray(butterfly_table_pallas(jnp.asarray(w), W=W, interpret=True))
        rows = _rows(got).numpy()
        if kind == "int":
            np.testing.assert_array_equal(rows, want)
            plain = KT.butterfly_table_torch(torch.as_tensor(w), W, "blocks")
            assert torch.equal(got, plain)
        else:
            g = got.numpy()
            wb = want.reshape(B // W, W, nb, W).transpose(0, 2, 1, 3)
            np.testing.assert_array_equal(g[..., : W - 1, :], wb[..., : W - 1, :])
            np.testing.assert_allclose(g[..., W - 1, :], wb[..., W - 1, :],
                                       rtol=nb * 2.0 ** -24, atol=0)


def test_running_row_is_a_float32_loop():
    """The models add the running row one float32 add at a time: on the
    CPU ``torch.cumsum`` of float32 accumulates in double, and differs."""
    x = torch.as_tensor(np.random.default_rng(0).gamma(0.3, size=1000).astype(np.float32))
    loop = torch.empty_like(x)
    c = torch.zeros((), dtype=torch.float32)
    for i in range(x.numel()):
        c = c + x[i]
        loop[i] = c
    assert torch.equal(torch.cumsum(x.double(), 0).float(), torch.cumsum(x, 0))
    assert not torch.equal(torch.cumsum(x, 0), loop)
    w = torch.zeros((64, 1000 * 64))
    w[0, ::64] = x  # sample 0's block totals are x
    t = tref.table_split_order_torch(w, 64, P=7)
    assert torch.equal(t[0, :, 63, 0], loop)


@pytest.mark.parametrize("G,nb,W,P", [(1, 2000, 128, 334), (1, 2000, 64, 667),
                                      (3, 2000, 128, 125), (1, 5, 128, 5),
                                      (396, 2000, 128, 1), (200, 500, 64, 4),
                                      (1712, 15, 64, 1)])
def test_split_blocks_mirror_the_card(G, nb, W, P):
    """The CPU mirror of ``split_run`` at 132 SMs: 384 / W blocks on every
    SM, at most one per W-block, runs of ceil(nb / P) blocks."""
    assert tref.table_split_blocks(G, nb, W) == P


def test_split_constant_mirrors_butterfly_table_cu():
    """The split's sizing constant of the CPU mirror is the one that
    ``butterfly_table.cu`` compiles into K1 (its launch bounds too)."""
    src = (Path(KT.__file__).parent / "csrc" / "butterfly_table.cu").read_text()
    found = re.search(r"constexpr int kSplitThreadsPerSM = (\d+);", src)
    assert found is not None
    assert tref.SPLIT_THREADS_PER_SM == int(found.group(1))
    assert "__launch_bounds__(W, kSplitThreadsPerSM / W)" in src


@pytest.mark.parametrize("G,nb,W,schedule", [
    (1, 2000, 128, "split"),   # the butterfly state of 64 rows at V = 256,000
    (1712, 15, 16, "serial"),  # the sweep's chunk: W = 16
    (3, 2000, 64, "split"),
    (128, 500, 64, "split"),   # 8,192 rows: the split won on the H100
    (64, 250, 128, "split"),
    (256, 500, 64, "serial"),  # 16,384 rows: the serial schedule won
    (128, 2000, 128, "serial"),
    (1, 1, 128, "serial"),     # one W-block: nothing to split
    (1, 4, 32, "serial"),
])
def test_table_schedule_rule(G, nb, W, schedule):
    assert KT.table_schedule(G, nb, W) == schedule
    assert KT.table_schedule(G, nb, W) in KT.SCHEDULES


def test_private_schedule_argument_rejects_unknown_names():
    """An unknown schedule, or the split below W = 64, raises before any
    device check."""
    w = torch.ones(64, 128)
    with pytest.raises(ValueError, match="schedule must be one of"):
        KT._butterfly_table(w, 64, schedule="tiled")
    with pytest.raises(ValueError, match="split schedule takes W = 64 or 128"):
        KT._butterfly_table(torch.ones(32, 64), 32, schedule="split")
    with pytest.raises(ValueError, match="CUDA"):
        KT._butterfly_table(w, 64, schedule="split")
