"""The corpus generator, the byte and operation counts, the trace reader
and the per-layer metrics' readers, at tiny sizes on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from bench import manifest, trace, yardstick
from bench.corpus import make_corpus

TINY = dict(M=50, V=70, K_planted=6, avg_len=7.0, max_len=12, topic_concentration=0.08,
            doc_concentration=0.25, zipf_exponent=1.05)
HBM = yardstick.PEAKS["hbm_bytes_per_s"]


def test_corpus_is_a_function_of_its_seed():
    a, b = make_corpus(TINY, 7, "cpu"), make_corpus(TINY, 7, "cpu")
    c = make_corpus(TINY, 8, "cpu")
    assert torch.equal(a.docs, b.docs) and torch.equal(a.mask, b.mask)
    assert not torch.equal(a.docs, c.docs)


def test_corpus_shapes_lengths_and_token_count():
    c = make_corpus(TINY, 2**31 + 11, "cpu")
    assert c.docs.shape == (50, 12) and c.docs.dtype == torch.int32
    assert int(c.lengths.min()) >= 1 and int(c.lengths.max()) <= 12
    assert torch.equal(c.mask, torch.arange(12)[None, :] < c.lengths[:, None])
    assert c.live_tokens == int(c.mask.sum()) == int(c.lengths.sum())
    assert int(c.docs.min()) >= 0 and int(c.docs.max()) < 70
    assert int(c.docs[~c.mask].abs().sum()) == 0
    assert 5.0 < c.live_tokens / 50 < 9.0


def test_sweep_bytes_by_hand():
    # 100 live tokens: word, topic read, topic written; theta (3 x 4) and
    # phi (5 x 4) read and written, float32
    assert yardstick.sweep_bytes(100, 3, 5, 4) == 100 * 12 + 2 * 4 * (3 * 4 + 5 * 4)
    assert yardstick.sweep_seconds(100, 3, 5, 4) == pytest.approx(1456 / HBM)


def test_k8_chunk_bounds_by_hand():
    docs = torch.tensor([[1, 2], [2, 0], [5, 5]], dtype=torch.int32)
    b = yardstick.k8_chunk_bounds(docs, K=4, chunk=2)
    # chunk 1: 2 theta rows, words {0, 1, 2}; chunk 2: 2 rows (one padded),
    # words {5} and the padding's 0; 4 positions of ids, u and z each
    assert [x["bytes"] for x in b] == [(2 + 3) * 16 + 4 * 16, (2 + 2) * 16 + 4 * 16]
    assert [x["flops"] for x in b] == [4 * 8, 4 * 8]
    assert b[0]["seconds"] == pytest.approx(144 / HBM)


def test_s1_bound_by_hand():
    docs = torch.tensor([[3, 4, 0], [3, 0, 0]], dtype=torch.int32)
    mask = torch.tensor([[True, True, False], [True, False, False]])
    z_in = torch.tensor([[1, 1, 0], [2, 0, 0]], dtype=torch.int32)
    z_out = torch.tensor([[1, 2, 0], [2, 0, 0]], dtype=torch.int32)
    b = yardstick.s1_bound(z_in, z_out, docs, mask, K=8, steps=2)
    # theta (d, k): (0,1) (0,2) (1,2); phi (w, k): (3,1) (4,1) (4,2) (3,2);
    # retained pairs (0,1) (1,2); words {3, 4}, a descent's 3 + 1 entries
    assert b["bytes"] == 6 * 13 + 2 * 8 + (3 + 4) * 4 + 2 * 4 * 4
    assert b["uniforms"] == 3 * 2 * 4
    clocks = max(20 / 64, 66 / 128)
    assert b["int32_s"] == pytest.approx(24 * clocks / (132 * 1.98e9))
    assert b["seconds"] == max(b["bytes_s"], b["int32_s"])


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    """Two sweeps: marker, a uniform kernel, K8, a count kernel; a sync."""
    ev = []
    corr = 0
    for s, t0 in enumerate((100.0, 200.0)):
        for name, at, d in (("at::cuda::spin_kernel(long)", 0, 1),
                            ("uniform_kernel", 5, 4),
                            ("void lda_fused_group_kernel<float, 32, true>", 12, 30),
                            ("indexFuncLargeIndex", 50, 10)):
            corr += 1
            ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t0 + at - 3, 2, corr))
            ev.append(_ev("kernel", name, t0 + at, d, corr))
    ev.append(_ev("cuda_runtime", "cudaDeviceSynchronize", 255.0, 10.0))
    return ev


def test_trace_parse_window_busy_stages_and_gaps():
    t = trace.parse(synthetic_trace())
    assert t.sweeps == 2
    assert t.window_s == pytest.approx((265.0 - 97.0) * 1e-6)
    assert t.busy_s == pytest.approx(2 * (4 + 30 + 10) * 1e-6)
    assert t.stage_s["draw"] == pytest.approx(2 * 34e-6)
    assert t.stage_s["resample"] == pytest.approx(2 * 10e-6)
    assert t.by_kernel["K8"] == [pytest.approx(60e-6), 2]
    assert sum(t.idle_by_host.values()) == pytest.approx(t.window_s - t.busy_s)
    assert "in cudaDeviceSynchronize" in t.idle_by_host
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void lda_fused_group_kernel")
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_trace_without_markers_reads_nothing():
    ev = [e for e in synthetic_trace() if "spin" not in e["name"]]
    t = trace.parse(ev)
    assert t.sweeps == 0 and t.busy_s == 0.0


def test_readers_on_the_synthetic_trace():
    c = manifest.cell("lda-nytimes-k1000.dense")
    corpus = make_corpus(TINY, 3, "cpu")
    c.config.update(TINY, K=8)
    ctx = SimpleNamespace(cell=c, trace=trace.parse(synthetic_trace()), sweep_s=0.5,
                          corpus=corpus, probe=None)
    read = {m: manifest.load_reader(manifest.ROOT, m).read for m in
            ("device_idle", "sweep_mfu", "draw_ms", "resample_ms", "k8_roofline",
             "s1_roofline")}
    t = ctx.trace
    assert read["device_idle"](ctx) == pytest.approx(100 * (1 - t.busy_s / t.window_s))
    assert read["draw_ms"](ctx) == pytest.approx(1e3 * 34e-6)
    assert read["resample_ms"](ctx) == pytest.approx(1e3 * 10e-6)
    least = yardstick.sweep_seconds(corpus.live_tokens, 50, 70, 8)
    assert read["sweep_mfu"](ctx) == pytest.approx(100 * least / 0.5)
    bounds = yardstick.k8_chunk_bounds(corpus.docs, 8, 256)
    assert read["k8_roofline"](ctx) == pytest.approx(100 * bounds[0]["seconds"] / 30e-6)
    assert read["s1_roofline"](ctx) is None
