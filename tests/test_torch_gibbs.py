"""The port's LDA sweep (repro_torch.lda) against the reference on the CPU:
the same corpus, the same chunked draws from the reference's uniforms,
exact counts, the likelihood, the Dirichlet updates, and the sweep's
behaviour on a planted corpus."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lda.gibbs as jg
from repro.lda import synthesize_corpus as j_synth
from repro_torch import autotune
from repro_torch.lda import corpus as tcorpus
from repro_torch.lda import gibbs as tg
from repro_torch.lda.metrics import topic_recovery_score
from repro_torch.kernels.lda_draw.ref import boundary_ties

CPU = "cpu"


@pytest.fixture
def port_autotune(tmp_path, monkeypatch):
    """The port's tuner on a throwaway cache file."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    yield
    autotune.reset()


@pytest.fixture(scope="module")
def small_corpus():
    return tcorpus.synthesize_corpus(seed=0, M=96, V=120, K=8, avg_len=40, max_len=80)


@pytest.fixture(scope="module")
def ref_state(small_corpus):
    return jg.init_state(jax.random.PRNGKey(0), small_corpus, 8)


def test_corpus_copy_is_identical(small_corpus):
    ref = j_synth(seed=0, M=96, V=120, K=8, avg_len=40, max_len=80)
    for f in ("docs", "lengths", "mask", "true_phi", "true_theta"):
        np.testing.assert_array_equal(getattr(small_corpus, f), getattr(ref, f))
    assert small_corpus.vocab_size == ref.vocab_size
    assert small_corpus.total_words == ref.total_words


def test_state_round_trip(ref_state):
    arrays = [np.asarray(a) for a in (ref_state.theta, ref_state.phi, ref_state.z)]
    st = tg.state_from_numpy(*arrays, step=3, seed=11, device=CPU)
    back = tg.state_to_numpy(st)
    for a, b in zip(arrays, back[:3]):
        np.testing.assert_array_equal(a, b)
    assert back[3] == 3 and st.z.dtype == torch.int32


@pytest.mark.parametrize("method", ["lda_kernel", "prefix", "butterfly", "fenwick",
                                    "two_level", "kernel"])
def test_chunked_draw_reproduces_reference(small_corpus, ref_state, method):
    """Fed the reference's per-chunk uniforms, the port's chunked draw gives
    the reference's z; a mismatch must be a float64-checked boundary tie."""
    W, chunk = 8, 40                          # 3 chunks, the last one padded
    docs = small_corpus.docs
    want = np.asarray(jg.draw_z(ref_state, jnp.asarray(docs), method=method, W=W,
                                chunk=chunk))
    theta = torch.as_tensor(np.array(ref_state.theta))
    phi = torch.as_tensor(np.array(ref_state.phi))
    nc = -(-docs.shape[0] // chunk)
    keys = jax.random.split(ref_state.key, nc + 1)[:nc]
    ties = 0
    for k, (start, end, theta_c, docs_c) in zip(
        keys, tg._chunks(theta, torch.as_tensor(docs), chunk)
    ):
        C, N = docs_c.shape
        u = torch.as_tensor(np.array(jax.random.uniform(k, (C * N,))))
        got = tg._draw_chunk(theta_c, phi, docs_c, u, method, W)
        ref = np.asarray(want[start:end])
        doc_ids = torch.arange(C * N) // N
        res = boundary_ties(got[: end - start].reshape(-1), ref.reshape(-1), theta_c,
                            phi, doc_ids[: (end - start) * N],
                            docs_c.reshape(-1)[: (end - start) * N], u[: (end - start) * N])
        assert res["faults"] == 0, (method, start, res)
        ties += res["ties"]
    assert ties <= 5, ties                    # ~3,800 draws; ties are rare


def test_counts_equal_reference(small_corpus, ref_state):
    z = np.array(ref_state.z)
    docs, mask = small_corpus.docs, small_corpus.mask
    jd, jw = jg._counts(jnp.asarray(z), jnp.asarray(docs), jnp.asarray(mask), 8, 120)
    td, tw = tg._counts(torch.as_tensor(z), torch.as_tensor(docs),
                        torch.as_tensor(mask), 8, 120)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_likelihood_matches_reference(small_corpus, ref_state):
    args = [np.array(ref_state.theta), np.array(ref_state.phi),
            small_corpus.docs, small_corpus.mask]
    want = float(jg.log_likelihood(*[jnp.asarray(a) for a in args]))
    got = float(tg.log_likelihood(*[torch.as_tensor(a) for a in args], chunk=40))
    assert abs(got - want) <= 1e-5 * abs(want)
    st = tg.state_from_numpy(args[0], args[1], np.asarray(ref_state.z), 0, 0, CPU)
    p_want = jg.perplexity(ref_state, small_corpus)
    assert abs(tg.perplexity(st, small_corpus) - p_want) <= 1e-5 * p_want


def test_dirichlet_update_mean():
    """Rows of _update_theta are Dirichlet(alpha + counts): their mean over
    R draws is within 5 standard errors of a / a.sum() in every topic."""
    K, R = 6, 20000
    counts = torch.tensor([0.0, 1.0, 3.0, 0.0, 10.0, 2.0])
    alpha = 0.1
    g = torch.Generator().manual_seed(0)
    th = tg._update_theta(g, counts.expand(R, K), alpha).double()
    a = (alpha + counts).double()
    a0 = a.sum()
    mean = a / a0
    se = torch.sqrt(a * (a0 - a) / (a0 ** 2 * (a0 + 1)) / R)
    assert torch.allclose(th.sum(dim=1), torch.ones(R, dtype=torch.float64), atol=1e-5)
    assert ((th.mean(dim=0) - mean).abs() <= 5 * se).all()
    ph = tg._update_phi(g, counts[:, None].expand(K, 4).contiguous(), alpha)
    assert torch.allclose(ph.sum(dim=0), torch.ones(4), atol=1e-5)


def test_perplexity_decreases(small_corpus):
    state = tg.init_state(1, small_corpus, 8, device=CPU)
    p0 = tg.perplexity(state, small_corpus)
    for _ in range(30):
        state = tg.gibbs_step(state, small_corpus, method="fenwick")
    p1 = tg.perplexity(state, small_corpus)
    assert np.isfinite(p1) and p1 < 0.6 * p0, (p0, p1)
    assert state.step == 30


def test_topic_recovery(small_corpus):
    state = tg.init_state(2, small_corpus, 8, device=CPU)
    base = topic_recovery_score(state.phi.numpy(), small_corpus.true_phi)
    for _ in range(60):
        state = tg.gibbs_step(state, small_corpus, method="fenwick")
    score = topic_recovery_score(state.phi.numpy(), small_corpus.true_phi)
    assert score > base + 0.15, (base, score)


def test_lda_kernel_sweeps_lower_perplexity():
    corpus = tcorpus.synthesize_corpus(seed=3, M=48, V=80, K=6, avg_len=30, max_len=60)
    state = tg.init_state(0, corpus, 6, device=CPU)
    p0 = tg.perplexity(state, corpus)
    for _ in range(6):
        state = tg.gibbs_step(state, corpus, method="lda_kernel", W=8)
    p1 = tg.perplexity(state, corpus)
    assert np.isfinite(p1) and p1 < p0
    th = state.theta
    assert torch.allclose(th.sum(dim=1), torch.ones(th.shape[0]), atol=1e-5)
    z = tg.sample_z(state, corpus, num_samples=3, W=8, chunk=16)
    assert z.shape == (3, *corpus.docs.shape) and 0 <= int(z.min()) and int(z.max()) < 6


@pytest.mark.parametrize("method", ["butterfly", "kernel"])
def test_table_sweeps_lower_perplexity(method):
    """A few sweeps of the two methods this slice brings lower perplexity
    and keep theta on the simplex (plain versions on the CPU)."""
    corpus = tcorpus.synthesize_corpus(seed=4, M=48, V=80, K=6, avg_len=30, max_len=60)
    state = tg.init_state(0, corpus, 6, device=CPU)
    p0 = tg.perplexity(state, corpus)
    for _ in range(6):
        state = tg.gibbs_step(state, corpus, method=method, W=8, chunk=16)
    p1 = tg.perplexity(state, corpus)
    assert np.isfinite(p1) and p1 < p0, (p0, p1)
    th = state.theta
    assert torch.allclose(th.sum(dim=1), torch.ones(th.shape[0]), atol=1e-5)
    assert 0 <= int(state.z.min()) and int(state.z.max()) < 6


def test_unported_options_raise(small_corpus, port_autotune):
    """``sparse=True`` and ``sparse="auto"`` run (slice 10: the MH-alias
    sweep, the same state in and out) and an unknown method raises; the
    default ``method="auto"`` resolves through the factored chunk plan and
    draws what the method it resolved to draws, on the same generator."""
    state = tg.init_state(0, small_corpus, 8, device=CPU)
    for sparse in (True, "auto"):
        out = tg.gibbs_step(state, small_corpus, sparse=sparse)
        assert out.step == 1 and out.z.shape == state.z.shape
        assert 0 <= int(out.z.min()) and int(out.z.max()) < 8
        assert torch.allclose(out.theta.sum(dim=1), torch.ones(out.theta.shape[0]),
                              atol=1e-5)
    with pytest.raises(ValueError):
        tg.gibbs_step(state, small_corpus, method="nope")
    M, N = small_corpus.docs.shape
    p = tg._chunk_plan(min(256, M) * N, 8, "auto", None, torch.float32, CPU)
    assert p.method in tg.METHODS and p.method != "auto" and p.factored
    a = tg.draw_z(tg.init_state(0, small_corpus, 8, device=CPU), small_corpus.docs)
    b = tg.draw_z(tg.init_state(0, small_corpus, 8, device=CPU), small_corpus.docs,
                  method=p.method, W=p.W)
    assert torch.equal(a, b)
    nxt = tg.gibbs_step(tg.init_state(0, small_corpus, 8, device=CPU), small_corpus)
    assert nxt.step == 1 and 0 <= int(nxt.z.min()) and int(nxt.z.max()) < 8


@pytest.mark.parametrize("method", ["gumbel", "alias", "alias_device", "radix_forest"])
def test_new_strategy_sweeps_lower_perplexity(method):
    """Sweeps with the strategies this slice brings lower perplexity and
    keep theta on the simplex (plain versions on the CPU)."""
    corpus = tcorpus.synthesize_corpus(seed=5, M=48, V=80, K=6, avg_len=30, max_len=60)
    state = tg.init_state(0, corpus, 6, device=CPU)
    p0 = tg.perplexity(state, corpus)
    for _ in range(6):
        state = tg.gibbs_step(state, corpus, method=method, W=8, chunk=16)
    p1 = tg.perplexity(state, corpus)
    assert np.isfinite(p1) and p1 < p0, (p0, p1)
    th = state.theta
    assert torch.allclose(th.sum(dim=1), torch.ones(th.shape[0]), atol=1e-5)
    assert 0 <= int(state.z.min()) and int(state.z.max()) < 6


@pytest.mark.parametrize("method", ["lda_kernel", "kernel", "fenwick", "alias"])
def test_dists_reproduces_fresh_build(small_corpus, method):
    """draw_z with held per-chunk distributions (dists=) draws what the
    fresh build draws from the same random stream, on the first sweep
    (built) and the second (refreshed from the new theta and phi)."""
    dists = {}
    for sweep in range(2):
        st = tg.init_state(sweep, small_corpus, 8, device=CPU)
        st = st._replace(key=torch.Generator().manual_seed(sweep))
        fresh = tg.draw_z(st, small_corpus.docs, method=method, W=8, chunk=40)
        st = st._replace(key=torch.Generator().manual_seed(sweep))
        held = tg.draw_z(st, small_corpus.docs, method=method, W=8, chunk=40,
                         dists=dists)
        assert torch.equal(held, fresh), (method, sweep)
        assert sorted(dists) == [0, 40, 80]
        assert all(d.method == method for d in dists.values())


def test_cuda_default_without_card_raises(small_corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.init_state(0, small_corpus, 8)


def test_port_imports_no_jax():
    """Importing every repro_torch module (``dist`` and ``launch`` among
    them) loads no jax and no repro module, and brings up no process
    group."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch, repro_torch.lda.sparse, repro_torch.kernels.sparse_mh\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "n = len([m for m in sys.modules if m.startswith('repro_torch')])\n"
        "import torch.distributed as dist\n"
        "walked = [m for m in ('repro_torch.dist.fault', 'repro_torch.dist.multihost',\n"
        "                      'repro_torch.launch.mesh', 'repro_torch.launch.train',\n"
        "                      'repro_torch.launch.serve') if m in sys.modules]\n"
        "print(json.dumps({'n': n, 'bad': bad, 'walked': walked,\n"
        "                  'group': dist.is_available() and dist.is_initialized()}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"},
                         timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["n"] >= 81, res
    assert len(res["walked"]) == 5 and not res["group"], res
