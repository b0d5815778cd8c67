"""The port's autotune (``repro_torch.autotune``) and kernel registry
against the reference's, on the CPU in one process.

Counterparts of ``tests/test_autotune.py`` (its 16 tests that pass here;
``test_measure_mode_never_times_during_trace`` is red on the reference
and has its own port check below, with the stream capture and the
compile faked), then parity: the ``"cpu"`` cost-model rankings (order and
microseconds), the candidate sets, ``bucket_key`` and ``resolve_full``
equal the reference's over a grid; the default draws on given uniforms
equal the reference's (a mismatch must be a float64-checked boundary
tie, ROADMAP rule (a)); the sweep's chunk plan equals the reference's.
Each package resolves on its own temporary cache file.
"""

import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.lda.gibbs as jg
from repro import autotune as jat
from repro import kernels as jkernels
from repro import sampling as jsampling
from repro.autotune import cost_model as jcm
from repro.autotune import tuner as jtuner
from repro.core import api as japi
from repro_torch import autotune
from repro_torch import kernels
from repro_torch import sampling
from repro_torch.autotune import cost_model
from repro_torch.autotune import tuner as tuner_mod
from repro_torch.autotune.cache import TuningCache, bucket_key
from repro_torch.core import api as tapi
from repro_torch.kernels.butterfly_sample.ref import boundary_ties
from repro_torch.lda import gibbs as tg

# the chi-square harness of test_sampler_stats (same rootdir import)
from test_sampler_stats import CHI2_999, _chi2_stat

ALL_MODEL_METHODS = (
    "prefix", "fenwick", "two_level", "butterfly", "gumbel", "alias", "kernel"
)


@pytest.fixture
def fresh_autotune(tmp_path, monkeypatch):
    """Both packages' tuners, each on a throwaway cache file of its own."""
    port = str(tmp_path / "port" / "autotune.json")
    ref = str(tmp_path / "ref" / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", port)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", ref)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reset()
    jat.reset()
    yield port
    autotune.reset()
    jat.reset()


def _w(seed, B, K, kind="uniform"):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(1, 1000, (B, K)).astype(np.float32)
    return rng.uniform(0.1, 1.0, (B, K)).astype(np.float32)


# ---------------------------------------------------------------------------
# Layer 1: cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ALL_MODEL_METHODS)
@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu", "cuda"])
def test_cost_model_monotone_in_K(method, backend):
    Ks = [16, 32, 64, 128, 256, 1024, 4096, 16384]
    costs = [autotune.predict_us(method, 1024, K, W=32, backend=backend) for K in Ks]
    for k0, k1, c0, c1 in zip(Ks, Ks[1:], costs, costs[1:]):
        assert c1 > c0, f"{method}/{backend}: cost fell from K={k0} to K={k1}"


def test_cost_model_regimes():
    """The paper-grounded regimes of the reference's fit, on its backends."""
    m, _, _ = autotune.choose(("prefix", "fenwick", "two_level"), 4096, 16)
    assert m == "prefix"
    m, _, _ = autotune.choose(ALL_MODEL_METHODS, 4096, 4096, backend="tpu")
    assert m in ("two_level", "fenwick", "butterfly", "kernel")
    m, _, _ = autotune.choose(ALL_MODEL_METHODS, 4096, 4096, draws=512)
    assert m == "alias"
    m, _, _ = autotune.choose(("prefix", "fenwick", "two_level"), 4096, 4096, draws=512)
    assert m == "fenwick"


def test_default_w_powers_of_two():
    for K in (2, 16, 200, 1024, 50_000, 10**6):
        W = autotune.default_w(K)
        assert 8 <= W <= 128 and (W & (W - 1)) == 0
        assert W == jat.default_w(K)


# ---------------------------------------------------------------------------
# Layer 2: tuning cache round trip and tuner behaviour
# ---------------------------------------------------------------------------


def test_cache_roundtrip(tmp_path):
    path = str(tmp_path / "cache.json")
    c1 = TuningCache(path=path)
    key = bucket_key("cpu", 4096, 1000, 1, "float32")
    assert key == "cpu|B4096|K1024|d1|float32|key"
    assert bucket_key("cpu", 4096, 1000, 1, "float32", has_key=False).endswith("|nokey")
    c1.put(key, "two_level", 32, 123.4, source="measured")
    c1.save()
    c2 = TuningCache(path=path)  # a fresh object: a process restart
    assert c2.get(key) == {"method": "two_level", "W": 32, "us": 123.4,
                           "source": "measured"}
    c2.put(key, "prefix", 8, 1.0, source="model")
    assert c2.get(key)["method"] == "two_level"
    with open(path, "w") as f:
        f.write("{not json")
    assert len(TuningCache(path=path)) == 0


def test_cache_ingest_bench_records(tmp_path):
    c = TuningCache(path=str(tmp_path / "never-written.json"), autoload=False)
    records = [
        {"backend": "cpu", "B": 512, "K": 512, "method": "prefix", "us": 90.0},
        {"backend": "cpu", "B": 512, "K": 512, "method": "two_level", "W": 16, "us": 40.0},
        {"backend": "cpu", "B": 512, "K": 512, "method": "gumbel", "us": 800.0},
        {"backend": "cpu", "B": 512, "K": 512, "method": "trunc_sorted", "us": 1.0},
    ]
    n = c.ingest_records({"schema": autotune.BENCH_SCHEMA, "records": records})
    assert n == 2  # one bucket per caller kind (key / nokey)
    for has_key in (True, False):
        hit = c.get(bucket_key("cpu", 512, 512, 1, "float32", has_key=has_key))
        assert hit["method"] == "two_level" and hit["W"] == 16
    c2 = TuningCache(path=str(tmp_path / "never.json"), autoload=False)
    n = c2.ingest_records({"schema": autotune.SCHEMA, "entries": {
        "cpu|B8|K8|d1|float32|key": {"method": "prefix", "W": 8, "us": 5.0}}})
    assert n == 1 and c2.get("cpu|B8|K8|d1|float32|key")["method"] == "prefix"
    # the reference's schema is not this cache's
    assert c2.ingest_records({"schema": jat.SCHEMA, "entries": {
        "cpu|B8|K16|d1|float32|key": {"method": "prefix", "W": 8, "us": 5.0}}}) == 0


def test_resolve_persists_and_survives_restart(fresh_autotune):
    path = fresh_autotune
    first = autotune.resolve(256, 1024, backend="cpu")
    assert os.path.exists(path), "resolve must persist the winner"
    blob = json.load(open(path))
    assert blob["schema"] == autotune.SCHEMA and len(blob["entries"]) == 1
    assert autotune.get_tuner().resolve(250, 1000, backend="cpu") == first
    autotune.reset_tuner()
    assert autotune.resolve(256, 1024, backend="cpu") == first
    assert len(json.load(open(path))["entries"]) == 1


def test_measure_mode_times_once_per_bucket(fresh_autotune, monkeypatch):
    calls = []
    real = tuner_mod.measure_method

    def counting(method, B, K, W, **kw):
        calls.append(method)
        kw.update(iters=1, warmup=1)
        return real(method, B, K, W, **kw)

    monkeypatch.setattr(tuner_mod, "measure_method", counting)
    t = autotune.Tuner(mode="measure", backend="cpu")
    first = t.resolve(64, 128)
    assert calls, "measure mode must actually time candidates"
    n = len(calls)
    assert t.resolve(64, 128) == first
    assert len(calls) == n, "a second resolve on the bucket must not time again"
    entry = t.cache.get(bucket_key("cpu", 64, 128, 1, "float32"))
    assert entry["source"] == "measured"


# ---------------------------------------------------------------------------
# Layer 3: table cache
# ---------------------------------------------------------------------------


def test_table_cache_hits_and_invalidation(monkeypatch):
    cache = autotune.TableCache(max_entries=4)
    w = torch.as_tensor(_w(0, 8, 64))
    p = sampling.plan(w, method="fenwick", W=8)
    t1 = cache.get_or_build_dist("phi", p, w)
    t2 = cache.get_or_build_dist("phi", p, w)
    assert t1 is t2 and cache.stats() == {"entries": 1, "hits": 1, "misses": 1}
    assert cache.invalidate("phi") == 1 and len(cache) == 0
    # while a stream captures (the reference: inside jit) nothing is cached
    monkeypatch.setattr(tuner_mod, "_tracing_active", lambda: True)
    cache.get_or_build_dist("phi", p, w)
    assert len(cache) == 0


def test_dist_key_integer_weights_match_uncached():
    """The cached-table path normalizes dtype like the uncached one."""
    w = torch.full((4, 8), 1, dtype=torch.int32)
    u = torch.full((4,), 0.9)
    autotune.reset_table_cache()
    a = tapi.sample_categorical(w, u=u, method="fenwick", W=8)
    b = tapi.sample_categorical(w, u=u, method="fenwick", W=8, dist_key="int")
    assert torch.equal(a, b) and bool((b == 7).all())


def test_draws_hint_ignored_without_dist_key(fresh_autotune):
    """No dist_key, no reuse between calls: auto resolves at one draw."""
    w = torch.ones((64, 4096))
    tapi.sample_categorical(w, torch.Generator().manual_seed(0), draws=512)
    (key,) = json.load(open(fresh_autotune))["entries"]
    assert "|d1|" in key, f"resolved at draws=512 without a dist_key: {key}"


def test_kernel_candidate_cuda_only():
    """The CUDA kernels are candidates on the card only: on the CPU their
    plain versions are oracles (the reference: TPU only)."""
    for fn in (lambda b: kernels.candidates(1024, 1024, b),
               lambda b: kernels.candidates(1024, 1024, b, truncated=True)):
        assert "kernel" in fn("cuda") and "kernel" not in fn("cpu")
    assert "kernel_trunc" in kernels.candidates(64, 4096, "cuda", truncated=True)
    assert "kernel_trunc" not in kernels.candidates(64, 4096, "cpu", truncated=True)
    assert "kernel_trunc" not in kernels.candidates(64, 4096, "cuda")
    for b in ("cpu", "cuda"):
        assert "lda_kernel" in kernels.candidates(64, 240, b, factored=True)
        assert {"alias_device", "radix_forest"} <= set(kernels.candidates(64, 240, b))


def test_dist_key_draws_match_uncached():
    w = torch.as_tensor(_w(1, 32, 48))
    u = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, 32).astype(np.float32))
    autotune.reset_table_cache()
    a = tapi.sample_categorical(w, u=u, method="fenwick", W=8)
    b = tapi.sample_categorical(w, u=u, method="fenwick", W=8, dist_key="w")
    c = tapi.sample_categorical(w, u=u, method="fenwick", W=8, dist_key="w")
    assert torch.equal(a, b) and torch.equal(a, c)
    assert autotune.get_table_cache().hits >= 1


# ---------------------------------------------------------------------------
# method="auto" end to end
# ---------------------------------------------------------------------------


def test_auto_statistically_matches_prefix(fresh_autotune):
    """auto draws from the same distribution as the prefix oracle (chi-square
    on a skewed pmf, the gate of test_sampler_stats)."""
    K, N = 20, 150_000
    probs = np.random.default_rng(5).dirichlet(np.full(K, 0.3))
    w = torch.as_tensor(probs, dtype=torch.float32)[None].expand(N, K).contiguous()
    for method in ("auto", "prefix"):
        idx = tapi.sample_categorical(w, torch.Generator().manual_seed(1), method=method)
        counts = np.bincount(idx.numpy(), minlength=K).astype(np.float64)
        stat, _ = _chi2_stat(counts, probs)
        assert stat < CHI2_999[19], f"{method}: chi2={stat:.1f}"


def test_auto_works_without_key(fresh_autotune):
    w = torch.as_tensor(_w(2, 64, 200))
    u = torch.rand(64, generator=torch.Generator().manual_seed(2))
    idx = tapi.sample_categorical(w, u=u)
    assert idx.shape == (64,) and int(idx.min()) >= 0 and int(idx.max()) < 200


def test_auto_1d_logits(fresh_autotune):
    """1-D logits lift to (1, K) before auto resolution."""
    x = torch.tensor([0.0, 5.0, 1.0])
    idx = tapi.sample_from_logits(x, torch.Generator().manual_seed(0))
    assert idx.shape == () and 0 <= int(idx) < 3
    assert int(tapi.sample_from_logits(x, torch.Generator(), temperature=0.0)) == 1


@pytest.mark.parametrize("trace", ["capture", "compile"])
def test_auto_while_tracing(fresh_autotune, monkeypatch, trace):
    """The reference's auto inside jit: while a stream captures or
    torch.compile traces (faked here), auto resolves by the model, draws,
    persists a "model" entry (never "measured": nothing is timed) and the
    table cache stays empty."""
    monkeypatch.setattr(tuner_mod, "measure_method", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("timed while tracing")))
    monkeypatch.setenv("REPRO_AUTOTUNE", "measure")
    if trace == "capture":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert tuner_mod._tracing_active()
    autotune.reset()
    w = torch.ones((16, 4096))
    idx = tapi.sample_categorical(w, torch.Generator().manual_seed(0))
    assert idx.shape == (16,) and int(idx.max()) < 4096
    tapi.sample_categorical(w, u=torch.rand(16), method="fenwick", dist_key="w")
    assert len(autotune.get_table_cache()) == 0
    entry = autotune.get_tuner().cache.get(bucket_key("cpu", 16, 4096, 1, "float32"))
    assert entry is not None and entry["source"] == "model"


# ---------------------------------------------------------------------------
# Parity with the reference on the CPU
# ---------------------------------------------------------------------------

GRID_B = (1, 64, 1024, 27392)
GRID_DRAWS = (1, 16, 512)
GRID_DTYPE = (2, 4, 8)


@pytest.mark.parametrize("K", [2, 16, 200, 240, 1024, 4096, 32000, 256000])
def test_rank_methods_equal_reference_on_cpu(K):
    """Order and microseconds of every ranking equal the reference's over
    B, draws, dtype, factored, truncated and has_key."""
    for B, d, db, fac, tr, hk in itertools.product(GRID_B, GRID_DRAWS, GRID_DTYPE,
                                                   (False, True), (False, True),
                                                   (False, True)):
        sig = "kp" if tr else ""
        pc = tuner_mod.candidate_methods(B, K, "cpu", hk, factored=fac, transforms=sig)
        assert pc == jtuner.candidate_methods(B, K, "cpu", hk, factored=fac,
                                              transforms=sig)
        kw = dict(draws=d, dtype_bytes=db, backend="cpu", factored=fac, truncated=tr)
        assert cost_model.rank_methods(pc, B, K, **kw) == jcm.rank_methods(pc, B, K, **kw)


def test_candidates_and_bucket_keys_equal_reference():
    for B, K, backend in itertools.product((1, 64, 1000), (2, 240, 5000), ("cpu", "tpu")):
        port_backend = "cuda" if backend == "tpu" else backend
        for fac, tr, sp in itertools.product((False, True), repeat=3):
            assert kernels.candidates(B, K, port_backend, factored=fac, truncated=tr,
                                      sparse=sp) == jkernels.candidates(
                B, K, backend, factored=fac, truncated=tr, sparse=sp)
        for args in itertools.product((1, 3, 64), ("float32", "bfloat16"), (True, False),
                                      (False, True), (1, 2, 6), ("", "kp", "kpm"),
                                      (False, True)):
            assert bucket_key("cpu", B, K, *args) == jat.bucket_key("cpu", B, K, *args)


def test_sparse_mh_listed_but_unavailable():
    """The registry lists sparse_mh under repro_torch.lda.sparse (slice 10):
    offered on both backends for sparse-capable workloads only, as in the
    reference, and measure mode times its MH draw (only when the workload
    is sparse)."""
    (c,) = [c for c in kernels.registry() if c.method == "sparse_mh"]
    assert c.module == "repro_torch.lda.sparse" and c.factored and c.sparse
    for b in ("cpu", "cuda"):
        assert "sparse_mh" in kernels.candidates(64, 240, b, factored=True, sparse=True)
        assert "sparse_mh" not in kernels.candidates(64, 240, b, factored=True)
        assert "sparse_mh" not in kernels.candidates(64, 1, b, factored=True, sparse=True)
    us = autotune.measure_method("sparse_mh", 64, 16, 8, sparse=True, factored=True,
                                 device="cpu")
    assert us is not None and us > 0
    assert autotune.measure_method("sparse_mh", 64, 16, 8, factored=True,
                                   device="cpu") is None
    assert [m.method for m in kernels.registry()] == [m.method for m in jkernels.registry()]


@pytest.mark.parametrize("transforms,devices", [("", 1), ("kp", 1), ("", 4), ("kpm", 2)])
def test_resolve_full_equals_reference(fresh_autotune, transforms, devices):
    """(method, W, tb, tk) of every resolution equal the reference's."""
    for B, K, d, dt, hk, fac in itertools.product(
            (1, 64, 1024, 27392), (2, 16, 240, 4096, 256000), (1, 64),
            ("float32", "bfloat16"), (True, False), (False, True)):
        kw = dict(draws=d, dtype_name=dt, has_key=hk, factored=fac, devices=devices,
                  transforms=transforms)
        got = autotune.get_tuner().resolve_full(B, K, backend="cpu", **kw)
        want = jat.get_tuner().resolve_full(B, K, **kw)
        assert (got.method, got.W, got.tb, got.tk, got.source) == (
            want.method, want.W, want.tb, want.tk, want.source), (B, K, kw)


@pytest.mark.parametrize("B,K,kind", [(64, 16, "uniform"), (64, 200, "int"),
                                      (32, 1000, "uniform"), (16, 5000, "uniform"),
                                      (8, 40000, "uniform")])
def test_default_draws_equal_reference(fresh_autotune, B, K, kind):
    """sample_categorical(w, u=u) at its default: the same resolution as
    the reference and the same indices on the same uniforms, a mismatch
    only at a float64-checked boundary tie (rule (a))."""
    w = _w(B + K, B, K, kind)
    u = np.random.default_rng(K).uniform(0, 1, B).astype(np.float32)
    p = sampling.plan((B, K), has_key=False, backend="cpu")
    jp = jsampling.plan((B, K), has_key=False)
    assert (p.method, p.W) == (jp.method, jp.W)
    got = tapi.sample_categorical(torch.as_tensor(w), u=torch.as_tensor(u))
    want = torch.as_tensor(np.asarray(japi.sample_categorical(jnp.asarray(w),
                                                              u=jnp.asarray(u))))
    r = boundary_ties(got, want, torch.as_tensor(w), torch.as_tensor(u))
    assert r["faults"] == 0, r
    if kind == "int":
        assert r["mismatches"] == 0, r


@pytest.mark.parametrize("K", [4, 8, 16, 64, 240, 1000])
def test_chunk_plan_equals_reference(fresh_autotune, K):
    """The sweep's chunk plan resolves as the reference's for the chunk
    shapes of a sweep (auto and explicit methods)."""
    for rows in (40 * 80, 256 * 307, 96 * 120):
        for method, W in (("auto", None), ("auto", 8), ("lda_kernel", None),
                          ("gumbel", None), ("alias", 16), ("prefix", None)):
            p = tg._chunk_plan(rows, K, method, W, torch.float32, "cpu")
            jp = jg._chunk_plan(rows, K, method, W, "float32")
            assert (p.method, p.W, p.tb, p.tk, p.has_key, p.factored) == (
                jp.method, jp.W, jp.tb, jp.tk, jp.has_key, jp.factored), (rows, method)


def test_from_factors_auto_resolves_over_factored_set(fresh_autotune):
    rng = np.random.default_rng(7)
    theta = torch.as_tensor(rng.uniform(0.1, 1, (6, 40)).astype(np.float32))
    phi = torch.as_tensor(rng.uniform(0.1, 1, (9, 40)).astype(np.float32))
    words = torch.as_tensor(rng.integers(0, 9, 48), dtype=torch.int32)
    docs = torch.arange(48, dtype=torch.int32) // 8
    d = sampling.Categorical.from_factors(theta, phi, words, docs, method="auto")
    jd = jsampling.Categorical.from_factors(jnp.asarray(theta.numpy()),
                                            jnp.asarray(phi.numpy()),
                                            jnp.asarray(words.numpy()),
                                            jnp.asarray(docs.numpy()), method="auto")
    assert (d.method, d.W) == (jd.method, jd.W)
    u = torch.rand(48, generator=torch.Generator().manual_seed(3))
    e = sampling.Categorical.from_factors(theta, phi, words, docs, method=d.method, W=d.W)
    assert torch.equal(d.draw(u=u), e.draw(u=u))


# ---------------------------------------------------------------------------
# The port's own: table staleness, cache files, failures, backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change", ["mul_", "copy_", "view"])
def test_dist_key_in_place_change_misses(fresh_autotune, change):
    """Tensors are mutable: after an in-place change (of the tensor or of a
    view of it) the same dist_key rebuilds, and the draws are those of the
    new weights."""
    w = torch.as_tensor(_w(11, 16, 300))
    u = torch.rand(16, generator=torch.Generator().manual_seed(11))
    cache = autotune.get_table_cache()
    tapi.sample_categorical(w, u=u, method="fenwick", dist_key="phi")
    d0 = autotune.content_digest(w)
    if change == "mul_":
        w[:, :150].mul_(3.0)
    elif change == "copy_":
        w.copy_(torch.as_tensor(_w(12, 16, 300)))
    else:
        w.view(-1)[17] = 100.0
    assert autotune.content_digest(w) != d0
    got = tapi.sample_categorical(w, u=u, method="fenwick", dist_key="phi")
    assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 0
    assert torch.equal(got, tapi.sample_categorical(w.clone(), u=u, method="fenwick"))
    tapi.sample_categorical(w, u=u, method="fenwick", dist_key="phi")
    assert cache.stats()["hits"] == 1


def test_content_digest_exact_and_memoized():
    w = torch.as_tensor(_w(13, 4, 64))
    d = autotune.content_digest(w)
    assert autotune.content_digest(w) == d
    assert autotune.content_digest(w.clone()) == d          # same content
    swapped = w.clone()
    swapped[0, [0, 1]] = swapped[0, [1, 0]]                 # same plain byte sum
    assert autotune.content_digest(swapped) != d
    tiny = w.clone()
    tiny[3, 63] = torch.nextafter(tiny[3, 63], torch.tensor(2.0))
    assert autotune.content_digest(tiny) != d
    assert autotune.content_digest(w.to(torch.float64)) != d


def test_cache_files_never_mix(fresh_autotune):
    """One process, both packages: each writes its own file with its own
    schema, and neither reads the other's."""
    w = _w(14, 32, 500)
    u = np.random.default_rng(14).uniform(0, 1, 32).astype(np.float32)
    tapi.sample_categorical(torch.as_tensor(w), u=torch.as_tensor(u))
    japi.sample_categorical(jnp.asarray(w), u=jnp.asarray(u))
    port, ref = fresh_autotune, os.environ["REPRO_AUTOTUNE_CACHE"]
    assert port != ref
    pb, rb = json.load(open(port)), json.load(open(ref))
    assert pb["schema"] == autotune.SCHEMA and rb["schema"] == jat.SCHEMA
    assert autotune.SCHEMA != jat.SCHEMA
    assert len(TuningCache(path=ref)) == 0
    assert len(jat.TuningCache(path=port)) == 0
    assert autotune.default_cache_path() == port
    assert autotune.PATH_ENV == "REPRO_TORCH_AUTOTUNE_CACHE"


def test_default_cache_path(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    assert autotune.default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "autotune.json"))


@pytest.mark.parametrize("error,swallowed", [
    (RuntimeError("nvcc: kernel failed to build"), False),
    (ValueError("W must be a power of two in [8, 128]"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
])
def test_measure_method_lets_kernel_failures_propagate(fresh_autotune, monkeypatch,
                                                       error, swallowed):
    """Only a deliberate not-viable case (the method refuses the shape, or
    the card runs out of memory) gives None; a kernel that fails to build
    or launch raises, from measure_method and from measure mode."""
    def failing(*a, **k):
        raise error

    monkeypatch.setattr(tapi, "sample_categorical", failing)
    if swallowed:
        assert autotune.measure_method("prefix", 8, 64, 8, device="cpu") is None
    else:
        with pytest.raises(RuntimeError, match="failed to build"):
            autotune.measure_method("prefix", 8, 64, 8, device="cpu")
        with pytest.raises(RuntimeError, match="failed to build"):
            autotune.Tuner(mode="measure", backend="cpu").resolve(8, 64)


def test_measure_candidates_times_blocked_methods_at_two_widths():
    timed = autotune.measure_candidates(("prefix", "two_level", "lda_kernel"), 16, 1024,
                                        device="cpu", iters=1)
    assert set(timed) == {("prefix", 32), ("two_level", 32), ("lda_kernel", 32)}
    assert timed[("lda_kernel", 32)] is None                # not a factored workload
    timed = autotune.measure_candidates(("two_level", "lda_kernel"), 16, 240,
                                        device="cpu", iters=1, factored=True)
    assert set(timed) == {("two_level", 16), ("two_level", 32), ("lda_kernel", 16),
                          ("lda_kernel", 32)}
    assert all(v is not None and v > 0 for v in timed.values())


def test_backend_per_call_and_reset_drops_plans(fresh_autotune):
    """The backend is the workload's: the same shape resolves in a cpu and
    a cuda bucket apart (the card's candidates include the CUDA kernels),
    and autotune.reset() drops the memoized plans."""
    t = autotune.get_tuner()
    cpu = t.resolve_full(64, 256000, transforms="kp", backend="cpu")
    cuda = t.resolve_full(64, 256000, transforms="kp", backend="cuda")
    keys = [k for k, _ in t.cache.items()]
    assert keys == ["cpu|B64|K262144|d1|float32|key|tr:kp",
                    "cuda|B64|K262144|d1|float32|key|tr:kp"]
    assert cpu.method not in ("kernel", "kernel_trunc")
    assert cuda.method in tuner_mod.candidate_methods(64, 256000, "cuda", True,
                                                      transforms="kp")
    p = sampling.plan(torch.ones(4, 10))
    assert p.backend == "cpu" and sampling.plan_stats()["autotune_resolves"] == 1
    autotune.reset()
    assert sampling.plan_stats() == {"autotune_resolves": 0, "plan_hits": 0,
                                     "plan_misses": 0}
