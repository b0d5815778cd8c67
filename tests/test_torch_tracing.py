"""The port's spans and counters (``repro_torch.tracing``) and the sweeps'
sites, on the CPU: nesting, parents and self time on a fake clock; the
shared no-op when nothing records; the counters of dense and sparse sweeps
(chunks, forced host reads, MH accepts) with the state bit-equal to the
same sweeps unrecorded; ``SparseSweepCache.last_stats`` read on access."""

import math

import pytest
import torch

from repro_torch import autotune, tracing
from repro_torch.kernels.sparse_mh import kernel as sparse_mh_kernel
from repro_torch.lda import corpus as tcorpus
from repro_torch.lda import gibbs as tg
from repro_torch.lda import sparse as ts

CPU = "cpu"


def _fake_clock(monkeypatch, times):
    it = iter(times)
    monkeypatch.setattr(tracing, "clock_ns", lambda: next(it))


def test_spans_nest_with_parents_sweep_ids_and_self_time(monkeypatch):
    with tracing.recording() as rec:
        # a: 0..100, b (in a): 10..40, c (in b): 15..20, d (in a): 50..90
        _fake_clock(monkeypatch, [0, 10, 15, 20, 40, 50, 90, 100, 120])
        with tracing.span("a", sweep=7):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d", sweep=8):
                pass
    assert [(s.name, s.start, s.end, s.parent, s.sweep) for s in rec.spans] == [
        ("a", 0, 100, -1, 7), ("b", 10, 40, 0, 7), ("c", 15, 20, 1, 7),
        ("d", 50, 90, 0, 8)]
    assert rec.self_ns() == [100 - 30 - 40, 30 - 5, 5, 40]
    s = rec.summary()["spans"]
    assert s["a"] == {"calls": 1, "ms": pytest.approx(100e-6), "self_ms": pytest.approx(30e-6)}
    assert s["c"]["calls"] == 1 and s["d"]["self_ms"] == pytest.approx(40e-6)


def test_off_span_is_one_shared_no_op_and_nothing_is_kept():
    assert tracing._active is None
    a, b = tracing.span("lda.sweep", 3), tracing.span("lda.draw_z")
    assert a is b is tracing._NO_SPAN
    with a:
        tracing.count("host_syncs")
        tracing.count("sparse.proposals", torch.tensor(5))
        tracing.gauge("sparse.cap", 16)
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {} and rec.launches == {}
    assert tracing.span("x") is tracing._NO_SPAN


def test_counters_add_gauges_keep_the_last_and_device_counts_sum_at_close():
    with tracing.recording() as rec:
        tracing.count("n")
        tracing.count("n", 4)
        tracing.count("acc", torch.tensor(3, dtype=torch.int32))
        tracing.count("acc", torch.tensor(2, dtype=torch.int64))
        tracing.count("acc", 1)
        tracing.gauge("cap", 32)
        tracing.gauge("cap", 16)
        assert "acc" in rec.counters and rec.counters["acc"] == 1   # tensors not yet read
    assert rec.counters == {"n": 5, "acc": 6, "cap": 16}


def test_launches_are_the_kernel_modules_counts_over_the_window():
    before = dict(sparse_mh_kernel.LAUNCHES)
    try:
        sparse_mh_kernel.LAUNCHES["sparse_mh"] += 4
        with tracing.recording() as rec:
            sparse_mh_kernel.LAUNCHES["sparse_mh"] += 3
        assert rec.launches == {"sparse_mh.sparse_mh": 3}
    finally:
        sparse_mh_kernel.LAUNCHES.update(before)


def test_one_recording_at_a_time_and_a_span_left_open_closes_with_it():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass
        sp = tracing.span("open")
        sp.__enter__()
    assert tracing._active is None
    assert rec.spans[0].end >= rec.spans[0].start > 0


def _corpus():
    return tcorpus.synthesize_corpus(3, M=40, V=60, K=6, avg_len=12, max_len=20)


def _sweeps(step, state, n):
    for _ in range(n):
        state = step(state)
    return state


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip((a.theta, a.phi, a.z),
                                                  (b.theta, b.phi, b.z)))


@pytest.mark.parametrize("chunk", [16, 40, 64])
def test_dense_sweep_counts_chunks_no_host_reads_and_keeps_the_state(chunk):
    corpus = _corpus()
    n = 3

    def step(s):
        return tg.gibbs_step(s, corpus, method="lda_kernel", chunk=chunk)

    off = _sweeps(step, tg.init_state(5, corpus, 12, device=CPU), n)
    with tracing.recording() as rec:
        on = _sweeps(step, tg.init_state(5, corpus, 12, device=CPU), n)
    assert _equal(on, off)
    M = corpus.docs.shape[0]
    assert rec.counters == {"lda.sweeps": n, "lda.chunks": n * math.ceil(M / chunk)}
    names = [s.name for s in rec.spans]
    assert names == ["lda.sweep", "lda.draw_z", "autotune.plan", "lda.counts",
                     "lda.theta", "lda.phi"] * n
    for i, s in enumerate(rec.spans):
        parent = rec.spans[s.parent].name if s.parent >= 0 else None
        assert parent == {"lda.sweep": None, "autotune.plan": "lda.draw_z"}.get(
            s.name, "lda.sweep")
        assert s.sweep == i // 6 and s.start <= s.end
    assert rec.launches == {}


def _sparse_recording(device):
    """Four recorded sparse sweeps against the same sweeps unrecorded, on
    ``device``: the counters and spans the two sparse tests assert."""
    corpus = _corpus()
    n = 4

    def run(record):
        cache = ts.SparseSweepCache()
        s = tg.init_state(9, corpus, 12, device=device)
        counts, caps = [], []

        def step(s):
            caps.append(cache.cap)
            s = tg.gibbs_step(s, corpus, sparse=True, sparse_cache=cache)
            counts.append([int(c) for c in cache.last_counts])
            return s

        if not record:
            return _sweeps(step, s, n), counts, caps, None
        with tracing.recording() as rec:
            s = _sweeps(step, s, n)
        return s, counts, caps, rec

    off, counts_off, _, _ = run(False)
    on, counts, caps, rec = run(True)
    assert _equal(on, off) and counts == counts_off
    c = rec.counters
    # _prepare's read before the first sweep, then _nnz_max once a sweep
    assert c["host_syncs"] == n + 1 and c["lda.sweeps"] == n
    assert [c["sparse.word_accepts"], c["sparse.doc_accepts"], c["sparse.proposals"]] \
        == [sum(x[i] for x in counts) for i in range(3)]
    assert c["sparse.proposals"] == n * 2 * int(corpus.mask.sum())
    assert c["sparse.cap"] == min(caps[-1], 12)
    syncs = [s for s in rec.spans if s.name.startswith("sync.")]
    assert [s.name for s in syncs] == ["sync.nnz_max"] * (n + 1)
    mh = [s for s in rec.spans if s.name == "lda.sparse.mh"]
    assert len(mh) == n and all(rec.spans[s.parent].name == "lda.sweep" for s in mh)
    assert sum(s.name == "lda.sparse.sort" for s in rec.spans) == n + 1
    assert [s.sweep for s in rec.spans if s.name == "lda.sweep"] == list(range(n))
    return rec, n


def test_sparse_sweep_forces_one_host_read_after_the_first_and_sums_accepts():
    rec, _ = _sparse_recording(CPU)
    # the plain version builds the lists on the CPU: no kernel pass counted
    assert rec.counters.get("sparse.fused_counts", 0) == 0
    assert rec.launches == {}


@pytest.mark.cuda
def test_sparse_sweep_counts_the_fused_pass_on_the_card():
    """On the card each sweep's lists, and the fresh cache's, come from the
    sparse_counts kernel's pass: sweeps + 1."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sparse_counts kernel runs only on the card")
    rec, n = _sparse_recording(torch.device("cuda"))
    assert rec.counters["sparse.fused_counts"] == n + 1
    assert rec.launches["sparse_counts.sparse_counts"] == n + 1


def test_sparse_auto_routes_count_their_forced_reads(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "model")
    autotune.reset()
    try:
        c = _corpus()
        corpus = tcorpus.Corpus(docs=torch.as_tensor(c.docs),
                                lengths=torch.as_tensor(c.lengths),
                                mask=torch.as_tensor(c.mask), vocab_size=c.vocab_size)
        s = tg.init_state(2, corpus, 12, device=CPU)
        cache = ts.SparseSweepCache()
        s = tg.gibbs_step(s, corpus, sparse=True, sparse_cache=cache)
        with tracing.recording() as rec:
            tg.gibbs_step(s, corpus, sparse=True, sparse_cache=cache,
                          word_proposal="auto")
            tg.gibbs_step(s, corpus, sparse="auto", sparse_cache=cache)
    finally:
        autotune.reset()
    syncs = [s.name for s in rec.spans if s.name.startswith("sync.")]
    assert syncs[:2] == ["sync.tokens", "sync.nnz_max"]
    assert syncs[2] == "sync.total_words"
    assert rec.counters["host_syncs"] == len(syncs)
    plans = [s for s in rec.spans if s.name == "autotune.plan"]
    assert rec.spans[plans[0].parent].name == "lda.sweep"


def test_last_stats_reads_what_draw_z_sparse_returns():
    corpus = _corpus()
    state = _sweeps(lambda s: tg.gibbs_step(s, corpus, method="lda_kernel"),
                    tg.init_state(4, corpus, 12, device=CPU), 2)
    cache = ts.SparseSweepCache()
    assert cache.last_stats is None
    copy = state._replace(z=state.z.clone())
    ts.gibbs_step_sparse(state, corpus, cache=cache)
    _, stats = ts.draw_z_sparse(copy, corpus.docs, corpus.mask, word_proposal="cdf",
                                cache=ts.SparseSweepCache(), return_stats=True)
    assert cache.last_stats == stats
    assert set(stats) == {"word_accept_rate", "doc_accept_rate", "proposals_per_kind"}
    assert all(torch.is_tensor(x) for x in cache.last_counts)
