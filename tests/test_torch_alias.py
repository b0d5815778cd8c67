"""The port's alias, radix-forest and Gumbel strategies (repro_torch.core)
and the on-device alias build (repro_torch.kernels.alias_build, the plain
version of K13 on the CPU) against the reference's, on the same numpy
inputs.

Tolerances, stated per check:
* Vose builders: ``alias`` equal; the scaled weights ``w * (K / sum)`` of
  PyTorch and XLA may differ in the last place (XLA compiles the scale
  its own way, even where the row total is exact), which moves each
  leftover by at most K * 2**-23 (the scale error times the sum of the
  scaled weights it subtracts), so ``prob`` within 2 * K * 2**-23.
* K13's plain version on the reference's own inputs: ``apos`` equal,
  ``prob`` within ``ref.prob_tolerance(Kp)`` (32 units in the last place
  of Kp): prob is a difference of prefix sums of magnitude up to Kp, and
  torch.cumsum adds in another order than XLA's scan.  The reference's
  own atol of 5e-6 (Pallas against its XLA twin, which share XLA's sums)
  is below one unit in the last place of those sums at its shape
  (10, 53), Kp = 64 (7.6e-6), so it cannot hold across frameworks.
* The induced mass of a device-built table equals the weights within the
  reference's 5e-6.
* The radix draw is exact on shared uniforms; Gumbel and generator-driven
  alias draws are compared by chi-squared (the uniforms cannot be shared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alias as jalias
from repro.core import radix as jradix
from repro.kernels.alias_build import kernel as jk
from repro.kernels.alias_build import ops as jops
from repro.kernels.alias_build.ref import table_mass as j_table_mass
from repro_torch.core import alias as talias
from repro_torch.core import gumbel as tgumbel
from repro_torch.core import radix as tradix
from repro_torch.kernels.alias_build import kernel as tk
from repro_torch.kernels.alias_build import ops as tops
from repro_torch.kernels.alias_build.ref import (
    build_alias_tables_ref,
    prob_tolerance,
    table_mass,
)


def chi2_crit_999(dof: int) -> float:
    """99.9th percentile of chi-squared (Wilson-Hilferty)."""
    z = 3.0902
    return dof * (1.0 - 2.0 / (9.0 * dof) + z * np.sqrt(2.0 / (9.0 * dof))) ** 3


def _chi2(idx, probs):
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=probs.size).astype(float)
    exp = probs * counts.sum()
    m = exp > 5
    return float(((counts[m] - exp[m]) ** 2 / exp[m]).sum()), int(m.sum()) - 1


def _weights(seed, B, K, kind):
    rng = np.random.default_rng(seed)
    if kind == "int":
        w = rng.integers(1, 50, (B, K)).astype(np.float32)
    else:
        w = rng.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)
    w[1] = 0.0
    return w


def _edge_weights():
    rng = np.random.default_rng(7)
    return {
        "uniform": np.ones((3, 16), np.float32),
        "random_nonpow2": rng.uniform(0.01, 1.0, (4, 37)).astype(np.float32),
        "zero_categories": np.where(rng.uniform(size=(4, 23)) < 0.4, 0.0,
                                    rng.uniform(0.1, 1.0, (4, 23))).astype(np.float32),
        "single_category": np.eye(5, 11, dtype=np.float32),
        "K1": np.ones((3, 1), np.float32),
        "zero_row": np.zeros((2, 9), np.float32),
        "denormal_huge": np.stack([
            np.asarray([1e-38, 1.0, 1e30, 1e-30, 2.0, 1e-38, 3e20, 1.0], np.float32),
            np.asarray([1e30, 1e30, 1e-38, 1e-38, 1e-38, 1e-38, 1e-38, 1e-38],
                       np.float32)]),
        "skewed_zipf": (1.0 / np.arange(1, 101, dtype=np.float32) ** 1.3)[None].repeat(2, 0),
    }.items()


def _target(w):
    w = np.asarray(w, np.float64)
    tot = w.sum(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(tot > 0, w / np.where(tot > 0, tot, 1.0), 1.0 / w.shape[-1])


@pytest.mark.parametrize("kind", ["int", "dirichlet"])
def test_vose_builders_match_reference(kind):
    B, K = 6, 240
    w = _weights(3, B, K, kind)
    jt = jalias.build_alias_tables(jnp.asarray(w))
    tt = talias.build_alias_tables(torch.as_tensor(w))
    np.testing.assert_array_equal(tt.alias.numpy(), np.asarray(jt.alias))
    np.testing.assert_allclose(tt.prob.numpy(), np.asarray(jt.prob), rtol=0,
                               atol=2 * K * 2.0 ** -23)
    jh = jalias.build_alias_tables_host(jnp.asarray(w))
    th = talias.build_alias_tables_host(torch.as_tensor(w))
    np.testing.assert_array_equal(th.alias.numpy(), np.asarray(jh.alias))
    # float64 in both; the cast to float32 absorbs the sum order
    np.testing.assert_allclose(th.prob.numpy(), np.asarray(jh.prob), rtol=2.0 ** -23, atol=0)
    one = talias.build_alias_table(torch.as_tensor(w[0]))
    np.testing.assert_array_equal(one.alias.numpy(), tt.alias[0].numpy())
    for t in (tt, th):
        err = np.abs(table_mass(t.prob.numpy(), t.alias.numpy()) - _target(w))[[0, 2, 3]]
        assert err.max() < 5e-6


def test_partition_and_merged_rank_match_reference():
    w = _weights(5, 8, 240, "dirichlet")
    js, jorder, jinv, jnl = jops._partition(jnp.asarray(w))
    ts, order, inv, nl = tops._partition(torch.as_tensor(w))
    for a, b in ((order, jorder), (inv, jinv), (nl, jnl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -22)
    # the rank on the reference's own partition: integers, equal
    s = torch.as_tensor(np.array(js))
    np.testing.assert_array_equal(
        tops._merged_rank(s, torch.as_tensor(np.array(jnl))).numpy(),
        np.asarray(jops._merged_rank(js, jnl)))


@pytest.mark.parametrize("B,K", [(10, 53), (8, 240)])
def test_assembly_plain_version_matches_reference(B, K):
    """K13's plain version against alias_assemble_pallas (interpret mode)
    and the XLA twin (_assemble), on the reference's padded inputs."""
    rng = np.random.default_rng(11)
    w = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    w *= rng.uniform(size=(B, K)) > 0.3
    js, _, _, jnl = jops._partition(jnp.asarray(w))
    Kp = jops._next_pow2(K)
    sp = jnp.pad(js, ((0, 0), (0, Kp - K)), constant_values=1.0)
    rank = jops._merged_rank(sp, jnl)
    jp, ja = jk.alias_assemble_pallas(sp, jnl, rank, tb=2, interpret=True)
    xp, xa = jk._assemble(sp, jnl, rank, jops._gather_rows_xla)
    tp, ta = tk.alias_assemble_torch(*(torch.as_tensor(np.array(x)) for x in (sp, jnl, rank)))
    for p_, a_ in ((jp, ja), (xp, xa)):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(a_))
        np.testing.assert_allclose(tp.numpy(), np.asarray(p_), rtol=0,
                                   atol=prob_tolerance(Kp))


def test_device_build_matches_reference_distribution():
    """The port's device build (plain K13) against the reference's: the
    same induced distribution.  The tables themselves may differ where a
    light's key b and a heavy's key A tie within the last place of the
    scaled weights, which the two frameworks round apart; with the
    reference's own partition the assembly is equal (the test above)."""
    w = _weights(9, 8, 240, "int")
    jt = jops.build_alias_tables_device(jnp.asarray(w), impl="xla")
    tt = tops.build_alias_tables_device(torch.as_tensor(w))
    assert (tt.alias.numpy() == np.asarray(jt.alias)).mean() > 0.99
    np.testing.assert_allclose(table_mass(tt.prob.numpy(), tt.alias.numpy()),
                               j_table_mass(np.asarray(jt.prob), np.asarray(jt.alias)),
                               rtol=0, atol=5e-6)
    one = tops.build_alias_tables_device(torch.as_tensor(w[0]))
    assert one.prob.shape == (240,)


@pytest.mark.parametrize("name,w", _edge_weights())
def test_device_build_mass_exact(name, w):
    t = tops.build_alias_tables_device(torch.as_tensor(w))
    err = float(np.abs(table_mass(t.prob.numpy(), t.alias.numpy()) - _target(w)).max())
    assert err < 5e-6, f"{name}: mass err {err:.2e}"
    assert ((t.prob >= 0) & (t.prob <= 1.0 + 1e-6)).all() and (t.alias < w.shape[-1]).all()
    rp, ra = build_alias_tables_ref(w)
    assert np.abs(table_mass(rp, ra) - table_mass(t.prob.numpy(), t.alias.numpy())).max() < 5e-6


def test_alias_draws_from_shared_uniforms_match_reference():
    """draw_alias_batch with the reference key's column and coin as
    explicit uniforms gives the reference's draws."""
    w = _weights(2, 64, 50, "dirichlet")
    jt = jalias.build_alias_tables(jnp.asarray(w))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jalias.draw_alias_batch(jt, key))
    k_key, u_key = jax.random.split(key)
    k = np.asarray(jax.random.randint(k_key, (64,), 0, 50))
    coin = np.asarray(jax.random.uniform(u_key, (64,)))
    tt = talias.AliasTable(prob=torch.as_tensor(np.array(jt.prob)),
                           alias=torch.as_tensor(np.array(jt.alias)))
    u_col = torch.as_tensor((k + 0.5) / 50, dtype=torch.float32)
    got = talias.draw_alias_batch(tt, u=(u_col, torch.as_tensor(coin)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [1, 7, 257, 1000])
def test_radix_forest_matches_reference(K):
    rng = np.random.default_rng(K)
    w = rng.integers(0, 5, (1, K)).astype(np.float32)
    w[0, 0] = 1.0
    nu = 512
    u = np.linspace(0.0, 1.0, nu, endpoint=False).astype(np.float32)
    jc, jr = jradix.build_radix_forest(jnp.tile(jnp.asarray(w), (nu, 1)))
    tc, tr_ = tradix.build_radix_forest(torch.as_tensor(w).repeat(nu, 1))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr))
    want = np.asarray(jradix.draw_radix_forest(jc, jr, jnp.asarray(u)))
    got = tradix.draw_radix_forest(torch.as_tensor(np.array(jc)),
                                   torch.as_tensor(np.array(jr)), torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    row = np.asarray(jc[0])
    np.testing.assert_array_equal(got.numpy(), np.minimum(np.searchsorted(row, u, "right"),
                                                          K - 1))


@pytest.mark.parametrize("draw", ["gumbel", "gumbel_logits", "alias", "alias_device"])
def test_generator_draws_chi2(draw):
    K, N = 20, 60_000
    probs = np.random.default_rng(5).dirichlet(np.full(K, 0.3))
    w = torch.as_tensor(probs, dtype=torch.float32)[None].repeat(N, 1)
    g = torch.Generator().manual_seed(1)
    if draw == "gumbel":
        idx = tgumbel.draw_gumbel(w, g)
    elif draw == "gumbel_logits":
        idx = tgumbel.draw_gumbel_logits(torch.log(w), g)
    elif draw == "alias":
        idx = talias.draw_alias_batch(talias.build_alias_tables(w), g)
    else:
        idx = talias.draw_alias_batch(tops.build_alias_tables_device(w), g)
    stat, dof = _chi2(idx.numpy(), probs)
    assert stat < chi2_crit_999(dof), (draw, stat, dof)
    single = talias.draw_alias(talias.build_alias_table(w[0]), g, shape=(N,))
    stat, dof = _chi2(single.numpy(), probs)
    assert stat < chi2_crit_999(dof), ("draw_alias", stat)
