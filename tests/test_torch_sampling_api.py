"""The port's sampling API (repro_torch.sampling: Categorical, plan; and
repro_torch.core.api: sample_categorical, sample_from_logits) against the
reference's, on the CPU with the same numpy inputs and the same uniforms.

Tolerance: integer weights keep every fp32 sum exact, so indices are
equal.  On real weights (and on weights made from logits, whose exp may
round apart in the two frameworks) a mismatch must be a float64-checked
boundary tie (``ref.boundary_ties`` / ``trunc_boundary_ties``).  The
generator-driven strategies (gumbel, alias, alias_device) cannot share
uniforms with the reference and are compared by chi-squared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.configs import base as jbase
from repro.configs import gemma2_9b as jgemma
from repro.core import api as japi
from repro.sampling import transforms as jtr
from repro_torch import autotune
from repro_torch import sampling
from repro_torch.configs import base as tbase
from repro_torch.configs import gemma2_9b as tgemma
from repro_torch.core import api as tapi
from repro_torch.kernels.butterfly_sample import ops as bops
from repro_torch.kernels.butterfly_sample.ref import boundary_ties, trunc_boundary_ties
from repro_torch.sampling import transforms as ttr

U_FLAT = ["prefix", "fenwick", "butterfly", "two_level", "kernel", "radix_forest"]
KEYED = ["gumbel", "alias", "alias_device"]


@pytest.fixture
def port_autotune(tmp_path, monkeypatch):
    """The port's tuner on a throwaway cache file."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    yield
    autotune.reset()


def chi2_crit_999(dof: int) -> float:
    z = 3.0902
    return dof * (1.0 - 2.0 / (9.0 * dof) + z * np.sqrt(2.0 / (9.0 * dof))) ** 3


def _weights(seed, B, K, kind="int"):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(1, 1000, (B, K)).astype(np.float32)
    return rng.dirichlet(np.full(K, 0.3), size=B).astype(np.float32)


def _u(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("method", U_FLAT)
def test_categorical_u_draws_match_reference(method):
    """(B,) and (S, B) uniforms on integer weights: equal indices; on
    Dirichlet weights only float64-checked ties."""
    B, K, W = 24, 300, 16
    for kind in ("int", "dirichlet"):
        w = _weights(3, B, K, kind)
        jd = jsampling.Categorical.from_weights(jnp.asarray(w), method=method, W=W)
        td = sampling.Categorical.from_weights(torch.as_tensor(w), method=method, W=W)
        assert (td.method, td.W, td.shape, td.needs_key) == (method, W, (B, K), False)
        for shape in ((B,), (3, B)):
            u = _u(len(shape), shape)
            want = np.asarray(jd.draw(u=jnp.asarray(u)))
            got = td.draw(u=torch.as_tensor(u))
            assert got.shape == shape and got.dtype == torch.int32
            res = boundary_ties(got, want, w, u)
            assert res["faults"] == 0 and (kind != "int" or res["mismatches"] == 0), res


def test_lda_kernel_from_factors_matches_reference():
    rng = np.random.default_rng(4)
    C, V, K, B, W = 6, 40, 24, 50, 8
    theta = rng.integers(1, 50, (C, K)).astype(np.float32)
    phi = rng.integers(1, 50, (V, K)).astype(np.float32)
    words = rng.integers(0, V, B).astype(np.int32)
    docs = rng.integers(0, C, B).astype(np.int32)
    u = _u(1, (2, B))
    jd = jsampling.Categorical.from_factors(jnp.asarray(theta), jnp.asarray(phi),
                                            jnp.asarray(words), jnp.asarray(docs), W=W)
    td = sampling.Categorical.from_factors(torch.as_tensor(theta), torch.as_tensor(phi),
                                           torch.as_tensor(words), torch.as_tensor(docs), W=W)
    np.testing.assert_array_equal(td.draw(u=torch.as_tensor(u)).numpy(),
                                  np.asarray(jd.draw(u=jnp.asarray(u))))
    theta2 = theta[::-1].copy()
    td2 = td.refresh_from_factors(torch.as_tensor(theta2), torch.as_tensor(phi))
    jd2 = jd.refresh_from_factors(jnp.asarray(theta2), jnp.asarray(phi))
    np.testing.assert_array_equal(td2.draw(u=torch.as_tensor(u[0])).numpy(),
                                  np.asarray(jd2.draw(u=jnp.asarray(u[0]))))
    # a flat method on factors forms the product once
    tf = sampling.Categorical.from_factors(torch.as_tensor(theta), torch.as_tensor(phi),
                                           torch.as_tensor(words), torch.as_tensor(docs),
                                           method="fenwick", W=W)
    np.testing.assert_array_equal(tf.draw(u=torch.as_tensor(u[0])).numpy(),
                                  td.draw(u=torch.as_tensor(u[0])).numpy())


@pytest.mark.parametrize("method", ["prefix", "two_level", "kernel"])
def test_from_logits_with_transforms_matches_reference(method):
    rng = np.random.default_rng(8)
    B, K, W = 16, 400, 16
    logits = rng.normal(0, 3.0, (B, K)).astype(np.float32)
    ks = rng.integers(5, 60, B).astype(np.float32)
    kw = dict(temperature=0.8, top_k=ks, top_p=0.9)
    jd = jsampling.Categorical.from_logits(jnp.asarray(logits), method=method, W=W,
                                           transforms=jtr.chain(**{**kw, "top_k": jnp.asarray(ks)}))
    td = sampling.Categorical.from_logits(torch.as_tensor(logits), method=method, W=W,
                                          transforms=ttr.chain(**{**kw, "top_k": torch.as_tensor(ks)}))
    wj = np.asarray(jtr.apply_to_logits(jtr.chain(**{**kw, "top_k": jnp.asarray(ks)}),
                                        jnp.asarray(logits)))
    u = _u(2, (B,))
    res = boundary_ties(td.draw(u=torch.as_tensor(u)), np.asarray(jd.draw(u=jnp.asarray(u))),
                        wj, u)
    assert res["faults"] == 0 and res["mismatches"] == 0, res


@pytest.mark.parametrize("method", KEYED + ["radix_forest", "kernel"])
def test_generator_draws_chi2(method):
    K, N = 20, 30_000
    probs = np.random.default_rng(5).dirichlet(np.full(K, 0.3))
    w = torch.as_tensor(probs, dtype=torch.float32)[None].repeat(N, 1)
    d = sampling.Categorical.from_weights(w, method=method)
    assert d.needs_key == (method in KEYED)
    idx = d.draw(generator=torch.Generator().manual_seed(2), num_samples=2)
    assert idx.shape == (2, N)
    counts = np.bincount(idx.numpy().reshape(-1), minlength=K).astype(float)
    exp = probs * counts.sum()
    stat = float(((counts - exp) ** 2 / exp).sum())
    assert stat < chi2_crit_999(K - 1), (method, stat)
    if method in KEYED:
        with pytest.raises(ValueError, match="generator"):
            d.draw(u=torch.rand(N))


def test_plan_memo_spec_and_defaults():
    sampling.reset_plans()
    p = sampling.plan((64, 300), method="kernel")
    assert sampling.plan((64, 300), method="kernel") is p
    sampling.plan((64, 300), method="kernel", transforms=(ttr.TopK(5), ttr.TopP(0.9)))
    sampling.plan((64, 300), method="kernel", transforms="kp")
    assert sampling.plan_stats() == {"autotune_resolves": 0, "plan_hits": 2, "plan_misses": 2}
    jp = jsampling.plan((64, 300), method="kernel")
    assert (p.W, p.tb, p.tk, p.shape) == (jp.W, jp.tb, jp.tk, jp.shape)
    s = sampling.plan(tbase.SamplerSpec(method="fenwick", W=32), shape=(8, 100))
    assert (s.method, s.W) == ("fenwick", 32)
    t = sampling.plan(torch.zeros(4, 50, dtype=torch.bfloat16), method="prefix")
    assert t.dtype == "bfloat16" and t.shape == (4, 50)
    kt = sampling.plan((8, 100), method="kernel_trunc")
    assert kt.table_method == "kernel"
    assert kt.build(torch.ones(8, 100)).method == "kernel"
    with pytest.raises(ValueError, match="unknown method"):
        sampling.plan((8, 100), method="sorted")
    with pytest.raises(ValueError, match="shape"):
        p.build(torch.ones(3, 3))
    sampling.reset_plans()
    assert sampling.plan_stats()["plan_misses"] == 0


def test_sample_logits_truncated_matches_reference():
    """plan(method="kernel").sample_logits with a top-k/top-p chain: the
    reference on its key's uniforms against the port's truncated draw on
    the same uniforms (one draw, then S=4), and the port's own generator
    path against the draw on the generator's uniforms."""
    rng = np.random.default_rng(12)
    B, V = 16, 1000
    logits = rng.normal(0, 4.0, (B, V)).astype(np.float32)
    chain_j = (jtr.TopK(40), jtr.TopP(0.9))
    chain_t = (ttr.TopK(40), ttr.TopP(0.9))
    key = jax.random.PRNGKey(7)
    jp = jsampling.plan((B, V), method="kernel", transforms="kp")
    tp = sampling.plan((B, V), method="kernel", transforms="kp")
    wj = np.asarray(jsampling.logits_to_weights(jnp.asarray(logits)))
    kpm = ttr.canonical_params(chain_t, B)
    want = np.asarray(jp.sample_logits(jnp.asarray(logits), key, transforms=chain_j))
    u = np.asarray(jax.random.uniform(key, (B,)))
    got = bops.butterfly_sample_truncated(torch.as_tensor(wj), torch.as_tensor(u), kpm,
                                          W=tp.W)
    res = trunc_boundary_ties(got, want, wj, u, kpm)
    assert res["faults"] == 0 and res["mismatches"] == 0, res
    want4 = np.asarray(jp.sample_logits(jnp.asarray(logits), key, num_samples=4,
                                        transforms=chain_j))
    u4 = np.asarray(jax.random.uniform(key, (4, B)))
    got4 = bops.butterfly_sample_truncated(torch.as_tensor(wj), torch.as_tensor(u4), kpm,
                                           W=tp.W)
    res = trunc_boundary_ties(got4, want4, wj, u4, kpm)
    assert res["faults"] == 0 and res["mismatches"] == 0, res
    for S in (1, 4):
        own = tp.sample_logits(torch.as_tensor(logits), torch.Generator().manual_seed(3),
                               num_samples=S, transforms=chain_t)
        uu = torch.rand((B,) if S == 1 else (S, B), generator=torch.Generator().manual_seed(3))
        ref = bops.butterfly_sample_truncated(
            sampling.logits_to_weights(torch.as_tensor(logits)), uu, kpm, W=tp.W)
        assert torch.equal(own, ref)
    # other variants mask by the threshold twin; gumbel stays in logit space
    mask = ttr.apply(sampling.logits_to_weights(torch.as_tensor(logits)), chain_t) > 0
    for m in ("two_level", "gumbel", "alias_device"):
        tok = sampling.plan((B, V), method=m).sample_logits(
            torch.as_tensor(logits), torch.Generator().manual_seed(1), num_samples=3,
            transforms=chain_t)
        assert tok.shape == (3, B)
        assert mask.gather(1, tok.T.long()).all(), m
    greedy = tp.sample_logits(torch.as_tensor(logits), None, temperature=0.0,
                              transforms=chain_t)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(1))


@pytest.mark.parametrize("method", U_FLAT)
def test_sample_categorical_and_from_logits_match_reference(method):
    B, K, W = 24, 300, 16
    w = _weights(6, B, K)
    u = _u(9, (B,))
    want = np.asarray(japi.sample_categorical(jnp.asarray(w), u=jnp.asarray(u),
                                              method=method, W=W))
    got = tapi.sample_categorical(torch.as_tensor(w), u=torch.as_tensor(u), method=method,
                                  W=W)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tapi.sample_categorical(torch.as_tensor(w[0]), u=torch.as_tensor(u[:1]),
                                method=method, W=W).numpy(), want[0])
    # sample_from_logits: the reference on its key's uniforms, the port on
    # the same uniforms; the port's generator path on its own uniforms
    logits = np.random.default_rng(1).normal(0, 2.0, (B, K)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(japi.sample_from_logits(jnp.asarray(logits), key, 0.7, method=method,
                                              W=W))
    uk = np.asarray(jax.random.uniform(key, (B,)))
    d = sampling.Categorical.from_logits(torch.as_tensor(logits), 0.7, method=method, W=W)
    wj = np.asarray(jsampling.logits_to_weights(jnp.asarray(logits), 0.7))
    res = boundary_ties(d.draw(u=torch.as_tensor(uk)), want, wj, uk)
    assert res["faults"] == 0 and res["mismatches"] == 0, res
    own = tapi.sample_from_logits(torch.as_tensor(logits), torch.Generator().manual_seed(2),
                                  0.7, method=method, W=W)
    uu = torch.rand(B, generator=torch.Generator().manual_seed(2))
    assert torch.equal(own, d.draw(u=uu))


@pytest.mark.parametrize("method", KEYED)
def test_keyed_one_shot_entry_points(method):
    w = torch.as_tensor(_weights(2, 12, 30))
    g = torch.Generator().manual_seed(0)
    idx = tapi.sample_categorical(w, g, method=method)
    assert idx.shape == (12,) and int(idx.max()) < 30
    with pytest.raises(ValueError, match="generator"):
        tapi.sample_categorical(w, u=torch.rand(12), method=method)
    tok = tapi.sample_from_logits(torch.log(w), g, method=method)
    assert tok.shape == (12,)
    assert int(tapi.sample_from_logits(torch.log(w[0]), g, temperature=0.0,
                                       method=method)) == int(w[0].argmax())


def test_unported_options_name_their_slices(monkeypatch, port_autotune):
    """The defaults resolve through autotune (``method="auto"``) and draw
    what the method they resolved to draws; ``dist_key=`` goes through the
    table cache; the other options keep their checks."""
    w = torch.as_tensor(_weights(3, 4, 10))
    u = torch.as_tensor(_u(4, (4,)))
    p = sampling.plan((4, 10))
    assert p.method in sampling.VARIANTS and p.backend == "cpu"
    pu = sampling.plan((4, 10), has_key=False, backend="cpu")
    assert torch.equal(tapi.sample_categorical(w, u=u),
                       tapi.sample_categorical(w, u=u, method=pu.method, W=pu.W))
    d = sampling.Categorical.from_weights(w)
    assert (d.method, d.W) == (p.method, p.W)
    assert torch.equal(tapi.sample_categorical(w, u=u, method="fenwick", dist_key="phi"),
                       tapi.sample_categorical(w, u=u, method="fenwick"))
    assert autotune.get_table_cache().stats()["entries"] == 1
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(tapi.sample_from_logits(torch.log(w), g1),
                       tapi.sample_from_logits(torch.log(w), g2, method=p.method, W=p.W))
    # mesh= is ported (tests/test_torch_sharded.py): it takes a DeviceMesh,
    # and spec= only with it
    with pytest.raises(TypeError, match="DeviceMesh"):
        sampling.plan((4, 10), method="kernel", mesh=object())
    with pytest.raises(ValueError, match="only has meaning with mesh"):
        sampling.plan((4, 10), method="kernel", spec=("data",))
    with pytest.raises(ValueError, match="unknown method"):
        tapi.sample_categorical(w, u=torch.rand(4), method="sorted")
    # input that is not a tensor goes to the card unless device= says otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sampling.Categorical.from_weights(np.ones((4, 10), np.float32), method="prefix")
    d = sampling.Categorical.from_weights(np.ones((4, 10), np.float32), method="prefix",
                                          device="cpu")
    assert d.device.type == "cpu"


def test_refresh_build_count_and_checks():
    w = torch.as_tensor(_weights(1, 8, 50))
    n0 = sampling.build_count()
    d = sampling.Categorical.from_weights(w, method="alias_device", W=8)
    d.draw(generator=torch.Generator().manual_seed(0), num_samples=5)
    assert sampling.build_count() == n0 + 1
    d2 = d.refreshed(w.flip(1))
    assert (d2.method, d2.W, sampling.build_count()) == ("alias_device", 8, n0 + 2)
    with pytest.raises(ValueError, match="shape"):
        d.refreshed(torch.ones(3, 3))
    with pytest.raises(ValueError, match="factored"):
        sampling.Categorical.from_factors(w[:, :5], w, torch.arange(8)).refreshed(w)
    with pytest.raises(ValueError, match="flat-weight"):
        d.refresh_from_factors(w, w)
    with pytest.raises(ValueError, match=r"\(B, K\)"):
        sampling.Categorical.from_weights(w[0], method="prefix")
    with pytest.raises(ValueError, match="num_samples"):
        sampling.Categorical.from_weights(w, method="prefix").draw(u=torch.rand(8),
                                                                   num_samples=2)
    assert set(sampling.VARIANTS) == set(jsampling.VARIANTS)
    assert sampling.U_VARIANTS == jsampling.U_VARIANTS
    assert sampling.KEY_VARIANTS == jsampling.KEY_VARIANTS
    assert tapi.METHODS == japi.METHODS


def test_configs_match_reference():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jbase.SamplerSpec)}
    tf = {f.name: f.default for f in dataclasses.fields(tbase.SamplerSpec)}
    assert tf == jf
    js = jgemma.CONFIG.sampler
    assert (tgemma.SAMPLER.top_k, tgemma.SAMPLER.top_p, tgemma.SAMPLER.min_p) == \
        (js.top_k, js.top_p, js.min_p)
    assert tgemma.VOCAB_SIZE == jgemma.CONFIG.vocab_size
    assert tgemma.SAMPLER.truncates
