"""The port's spans put on a trace's clock (``bench/spans.py``), on the CPU:
the join by the markers' launches, idle put down to the innermost span,
the draw kernels' launches inside their spans, the existing trace fields
and readers unchanged for the same events, the four readers of the
program's spans and counters, and nothing read where nothing is traced or
the program records no spans."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from bench import harness, manifest, spans, trace
from bench.test_bench_yardstick import TINY, synthetic_trace
from bench.test_bench_run import tiny
from bench.corpus import make_corpus
from repro_torch import tracing

NEW = ("chunk_host_us", "host_syncs", "issue_idle_ms", "sync_idle_ms")
OLD = ("device_idle", "sweep_mfu", "draw_ms", "resample_ms", "k8_roofline", "s1_roofline")
OFFSET_US = 50.0          # trace clock = span clock (ns) / 1e3 + OFFSET_US
BASE_NS = 10**18


def _ns(us):
    return round((us - OFFSET_US) * 1e3)


def synthetic_record():
    """The spans of the synthetic trace's two sweeps (t0 = 100, 200 µs on
    the trace's clock), the markers' launch anchors and the counters."""
    out = []
    for s, t0 in enumerate((100.0, 200.0)):
        root = len(out)
        for name, a, b, parent in (("lda.sweep", 0.5, 62, -1), ("lda.draw_z", 0.8, 44, root),
                                   ("autotune.plan", 0.9, 1.9, root + 1),
                                   ("sync.nnz_max", 45, 61, root)):
            out.append(tracing.Span(name, _ns(t0 + a), _ns(t0 + b), parent, s))
    rec = tracing.Record(spans=out, counters={"lda.sweeps": 2, "lda.chunks": 4,
                                              "host_syncs": 2},
                         wall_offset_ns=BASE_NS + round(OFFSET_US * 1e3))
    # each marker's launch is [t0 - 3, t0 - 1]: the host read its clock
    # half a µs before and after
    anchors = [(_ns(t0 - 3.5), _ns(t0 - 0.5)) for t0 in (100.0, 200.0)]
    return rec, anchors


def synthetic_window():
    rec, anchors = synthetic_record()
    return spans.analyse(synthetic_trace(), rec, anchors, BASE_NS)


def test_clocks_join_by_the_markers_and_agree_with_the_wall_clock():
    w = synthetic_window()
    assert w.clock["offset_us"] == pytest.approx(OFFSET_US)
    assert w.clock["error_us"] == pytest.approx(0.5)
    assert w.clock["pairs"] == 2 and "inconsistent" not in w.clock
    assert w.clock["wall_minus_anchored_us"] == pytest.approx(0.0)
    assert w.spans[1][:2] == ("lda.draw_z", pytest.approx(100.8))


def test_clocks_that_disagree_are_flagged():
    _, anchors = synthetic_record()
    skewed = [anchors[0], (anchors[1][0] + 5000, anchors[1][1] + 5000)]
    c = spans.join_clocks(synthetic_trace(), skewed)
    assert c["inconsistent"] == 1.0 and c["error_us"] == pytest.approx(49.5 - 45.5)
    assert c["pairs"] == c["marker_launches"] == c["anchors"] == 2


def test_a_lost_marker_pairs_by_the_wall_clock_or_joins_nothing():
    rec, anchors = synthetic_record()
    events = synthetic_trace()
    c = spans.join_clocks(events, anchors[:1], guess_us=OFFSET_US + 3)
    assert c["pairs"] == 1 and c["marker_launches"] == 2
    assert c["offset_us"] == pytest.approx(OFFSET_US) and c["error_us"] == 0.5
    assert spans.join_clocks(events, anchors[:1]) == {
        "marker_kernels": 2, "marker_launches": 2, "anchors": 1}
    # a wall clock far off: paired in order where the numbers agree
    assert spans.join_clocks(events, anchors, guess_us=1e6)["offset_us"] == OFFSET_US
    assert spans.analyse(events, rec, anchors[:1], BASE_NS).clock["pairs"] == 1
    w = spans.analyse(events, rec, anchors[:1], base_ns=0)
    assert "offset_us" not in w.clock and w.spans == [] and w.idle_by_span == {}


def test_idle_goes_to_the_innermost_span_open_when_each_gap_began():
    w = synthetic_window()
    # gaps: [97, 105] before the first sweep's spans; [109, 112], [142, 150],
    # [209, 212], [242, 250] in lda.draw_z (autotune.plan ended at t0 + 1.9);
    # [160, 205] and [260, 265] in sync.nnz_max
    assert w.idle_by_span == {spans.OUTSIDE: pytest.approx(8e-6),
                              "lda.draw_z": pytest.approx(22e-6),
                              "sync.nnz_max": pytest.approx(50e-6)}
    t = w.trace
    assert sum(w.idle_by_span.values()) == pytest.approx(t.window_s - t.busy_s)
    assert w.inside == {"K8": [2, 2]}


def test_a_launch_outside_its_span_is_counted_outside():
    rec, anchors = synthetic_record()
    for s in rec.spans:
        if s.name == "lda.draw_z":
            s.end = _ns(100.0 + 10.5 if s.sweep == 0 else 200.0 + 44)
    rec.spans[2].end = rec.spans[2].start          # plan stays inside draw_z
    w = spans.analyse(synthetic_trace(), rec, anchors, BASE_NS)
    assert w.inside == {"K8": [1, 2]}              # sweep 0's launch ends at 111


def test_existing_trace_fields_and_readers_are_unchanged():
    events = synthetic_trace()
    w = synthetic_window()
    assert w.trace == trace.parse(events)
    assert w.trace.breakdown() == trace.parse(events).breakdown()
    c = manifest.cell("lda-nytimes-k1000.dense")
    corpus = make_corpus(TINY, 3, "cpu")
    c.config.update(TINY, K=8)
    a = SimpleNamespace(cell=c, trace=trace.parse(events), sweep_s=0.5, corpus=corpus,
                        probe=None)
    b = SimpleNamespace(cell=c, trace=w.trace, sweep_s=0.5, corpus=corpus, probe=None)
    for m in OLD:
        read = manifest.load_reader(manifest.ROOT, m).read
        assert read(a) == read(b)


def _ctx(w, monkeypatch):
    ctx = SimpleNamespace(cell=None, trace=w.trace, sweep_s=0.5, corpus=None, probe=None)
    monkeypatch.setattr(spans, "_last", (ctx.trace, w))
    return ctx


def test_the_four_readers_on_the_synthetic_window(monkeypatch):
    ctx = _ctx(synthetic_window(), monkeypatch)
    read = {m: manifest.load_reader(manifest.ROOT, m).read for m in NEW}
    # lda.draw_z: 43.2 µs less autotune.plan's 1.0, twice, over 4 chunks
    assert read["chunk_host_us"](ctx) == pytest.approx(2 * 42.2 / 4)
    assert read["host_syncs"](ctx) == 1.0
    assert read["issue_idle_ms"](ctx) == pytest.approx(1e3 * 22e-6 / 2)
    assert read["sync_idle_ms"](ctx) == pytest.approx(1e3 * 50e-6 / 2)


def test_a_dense_window_reads_zero_syncs_and_no_chunks_reads_nothing(monkeypatch):
    rec, anchors = synthetic_record()
    rec.counters = {"lda.sweeps": 2}
    ctx = _ctx(spans.analyse(synthetic_trace(), rec, anchors, BASE_NS), monkeypatch)
    read = {m: manifest.load_reader(manifest.ROOT, m).read for m in NEW}
    assert read["host_syncs"](ctx) == 0.0
    assert read["chunk_host_us"](ctx) is None


def test_nothing_is_read_untraced_or_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(spans, "_last", None)
    read = {m: manifest.load_reader(manifest.ROOT, m).read for m in NEW}
    cpu = SimpleNamespace(trace=trace.Trace(), probe=(None, None))
    assert all(read[m](cpu) is None for m in NEW)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)   # a port without spans
    traced = SimpleNamespace(trace=trace.parse(synthetic_trace()), probe=(None, None))
    assert all(read[m](traced) is None for m in NEW)
    assert spans._last == (traced.trace, None)


@pytest.mark.parametrize("name", ["lda-nytimes-k1000.dense", "lda-wikipedia-k240.sparse"])
def test_the_window_program_starts_from_the_probe_topics(name):
    c = tiny(name)
    corpus, prog, _, _ = harness.setup(c, 2**31 + 5, "cpu", time.perf_counter())
    z_in = prog.state.z.clone()
    prog.sweep()
    ctx = SimpleNamespace(cell=c, corpus=corpus, probe=(z_in, prog.state.z))
    w = spans.program(ctx)
    assert torch.equal(w.state.z, prog.state.z) and w.state.z is not prog.state.z
    assert torch.allclose(w.state.theta.sum(1), torch.ones(1))
    assert torch.allclose(w.state.phi.sum(0), torch.ones(1))
    before = prog.state.z.clone()
    with tracing.recording() as rec:
        w.sweep()
    assert torch.equal(prog.state.z, before)
    assert rec.counters["lda.sweeps"] == 1


def test_a_traced_run_logs_counters_idle_by_span_and_the_clock_check():
    import io
    import json

    w = synthetic_window()
    w.counters.update({"sparse.proposals": 10, "sparse.word_accepts": 3,
                       "sparse.doc_accepts": 4, "sparse.cap": 16})
    out = io.StringIO()
    spans.log(w, out)
    counters, idle, clock = out.getvalue().splitlines()
    assert counters.startswith("program counters: sweeps 2, chunks 4, host_syncs 2")
    assert "sparse.cap 16" in counters and "word_accept_rate 0.3" in counters
    assert idle.startswith("idle by span (s): sync.nnz_max")
    c = json.loads(clock.split(": ", 1)[1])
    assert c["inside"] == {"K8": [2, 2]}
    assert c["idle_put_down_s"] == pytest.approx(c["trace_idle_s"])
