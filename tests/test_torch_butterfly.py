"""The port's paper-faithful core (repro_torch.core.butterfly / reference)
against the reference's JAX modules.  Integer weights make every fp32 sum
exact, so tables must match bit for bit and indices exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jb
from repro.core import reference as jr
from repro_torch.core import butterfly as tb
from repro_torch.core import reference as tr
from repro_torch.sampling import distribution as tdist

# the reference's table builders and searches are not jitted; eager JAX
# dispatches op by op, so jit them here (same arithmetic, one dispatch)
_J = {
    n: jax.jit(getattr(jb, n), static_argnums=2 if "search" in n else 1)
    for n in ("build_butterfly_table", "closed_form_table", "butterfly_search",
              "build_fenwick_table", "fenwick_search")
}


def _weights(seed, B, K, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 64, size=(B, K)).astype(np.float32)
    w[rng.random((B, K)) < zero_frac] = 0.0
    u = rng.uniform(0, 1, size=B).astype(np.float32)
    return w, u


@pytest.mark.parametrize("W", [8, 16, 32])
def test_butterfly_table_bit_exact(W):
    w, _ = _weights(W, 2 * W, 3 * W)
    jt = np.asarray(_J["build_butterfly_table"](jnp.asarray(w), W))
    tt = tb.build_butterfly_table(torch.as_tensor(w), W).numpy()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(
        tb.closed_form_table(torch.as_tensor(w), W).numpy(),
        np.asarray(_J["closed_form_table"](jnp.asarray(w), W)),
    )
    np.testing.assert_array_equal(tt, tb.closed_form_table(torch.as_tensor(w), W).numpy())


def test_figure2_w8_example():
    """Paper Figure 2: after the three replacement sets, entry (i, j) of a
    W=8 block holds the segment sum u_v^w of the closed form; rows 0, 3, 5
    and 7 are the ones the figure spells out."""
    W = 8
    w = np.random.default_rng(0).integers(1, 9, size=(8, 8)).astype(np.float32)
    t = tb.butterfly_rounds(torch.as_tensor(w)[None, None], W).numpy()[0, 0]
    np.testing.assert_array_equal(
        t, np.asarray(jax.jit(jb.butterfly_rounds, static_argnums=1)(
            jnp.asarray(w)[None, None], W))[0, 0]
    )

    def seg(u, lo, hi):
        return w[u, lo:hi + 1].sum()

    for j in range(W):
        assert t[0, j] == seg(j & 1, j, j)              # single products
        lo = 0 if j < 4 else 4
        assert t[3, j] == seg(j, lo, lo + 3)            # j_0^3 / j_4^7
        assert t[7, j] == seg(j, 0, 7)                  # block totals
    row5 = [(4, 0, 1), (5, 0, 1), (6, 2, 3), (7, 2, 3),
            (4, 4, 5), (5, 4, 5), (6, 6, 7), (7, 6, 7)]
    for j, (u, lo, hi) in enumerate(row5):
        assert t[5, j] == seg(u, lo, hi), j


@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("B,K", [(37, 100), (64, 256), (5, 19)])
def test_draws_match_reference(W, B, K):
    w, u = _weights(B * K + W, B, K, zero_frac=0.2)
    jw, ju = jnp.asarray(w), jnp.asarray(u)
    tw, tu = torch.as_tensor(w), torch.as_tensor(u)
    want = np.asarray(jr.draw_prefix(jw, ju))
    np.testing.assert_array_equal(tr.draw_prefix(tw, tu).numpy(), want)
    np.testing.assert_array_equal(tr.draw_linear_np(w, u), want)
    for name in ("draw_butterfly", "draw_fenwick", "draw_two_level"):
        got = getattr(tb, name)(tw, tu, W=W).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jb, name)(jw, ju, W=W)))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("W", [8, 16, 32])
def test_search_and_fenwick_table_match(W):
    w, u = _weights(3 * W, 2 * W, 4 * W)
    jt = _J["build_butterfly_table"](jnp.asarray(w), W)
    tt = tb.build_butterfly_table(torch.as_tensor(w), W)
    stop = (np.asarray(jt)[:, -1, W - 1, :] * u.reshape(2, W)).astype(np.float32)
    np.testing.assert_array_equal(
        tb.butterfly_search(tt, torch.as_tensor(stop), W).numpy(),
        np.asarray(_J["butterfly_search"](jt, jnp.asarray(stop), W)),
    )
    jf = _J["build_fenwick_table"](jnp.asarray(w), W)
    tf = tb.build_fenwick_table(torch.as_tensor(w), W)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    fstop = (np.asarray(jf).reshape(2 * W, -1, W)[:, -1, W - 1] * u).astype(np.float32)
    np.testing.assert_array_equal(
        tb.fenwick_search(tf, torch.as_tensor(fstop), W).numpy(),
        np.asarray(_J["fenwick_search"](jf, jnp.asarray(fstop), W)),
    )


@pytest.mark.parametrize("method", ["prefix", "butterfly", "fenwick", "two_level"])
def test_distribution_state_draws_match_core(method):
    """The sampling layer's built state + u-driven draw give the core's
    indices (padding: 0.5 uniforms on padded groups, clip to K-1)."""
    B, K, W = 45, 70, 16
    w, u = _weights(9, B, K, zero_frac=0.3)
    tw, tu = torch.as_tensor(w), torch.as_tensor(u)
    state = tdist._build_state(method, tw, W)
    got = tdist._draw_with_u(method, state, tu, (B, K), W).numpy()
    np.testing.assert_array_equal(got, np.asarray(jr.draw_prefix(w, u)))
    with pytest.raises(ValueError, match="factored"):
        tdist._build_state("lda_kernel", tw, W)
