"""The port's own spans and counters (``repro_torch.tracing``) over a traced
window, put on the device trace's clock.

:func:`window` runs, once for a traced run, a second window like
:func:`bench.trace.traced_sweeps` (``torch.profiler`` on the card only,
a marker kernel before each sweep, ``synchronize()`` at the end), with a
recording open over the marked sweeps.  Its program is the cell's own,
rebuilt from the topics of the run's probe sweep (theta and phi resampled
from their counts, :func:`bench.reference.resample`) and swept once
before the window, so it enters in the state the traced run left.  The
readers ``chunk_host_us``, ``host_syncs``, ``issue_idle_ms`` and
``sync_idle_ms`` read it; where nothing is traced (a CPU) or the program
records nothing (no ``repro_torch.tracing``) it is None.

:func:`analyse` joins the two clocks by the markers: the host reads its
span clock just before and after launching each marker, and the trace
holds that launch's ``cudaLaunchKernel``, so the offset between the
clocks lies in every marker's interval; their intersection gives it, and
its half-width is the join's error.  Device idle in the window (the gaps
of :func:`bench.trace.parse`) is put down to the innermost span open on
the host when each gap began, or to :data:`OUTSIDE`.

A traced run logs three lines on standard error: the program's counters,
the idle by span, and the clock check (the offset, its error, the
wall-clock offset beside it, each draw kernel's launches that fall inside
the span that issues it, and the idle put down against the trace's).
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench import reference
from bench.trace import (
    _DEVICE_CATS,
    _RUNTIME_CATS,
    _SYNC,
    MARKER,
    Trace,
    _kernel_of,
    _span,
    _union,
    parse,
)

OUTSIDE = "outside the port"
# a marker's launch pairs with a host reading at most this far (µs) from
# where the wall clock puts it
PAIR_US = 50.0
# the span that issues each draw kernel's launches
KERNEL_SPANS = {"K6": "lda.draw_z", "K7": "lda.draw_z", "K8": "lda.draw_z",
                "S1": "lda.sparse.mh"}


@dataclass
class Window:
    """A recorded, traced window: the existing :class:`Trace` of its
    events, and what the program recorded."""

    trace: Trace
    spans: List[tuple] = field(default_factory=list)   # (name, start us, end us, parent, sweep)
    self_us: List[float] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    idle_by_span: Dict[str, float] = field(default_factory=dict)   # seconds
    clock: Dict[str, float] = field(default_factory=dict)
    inside: Dict[str, List[int]] = field(default_factory=dict)     # kernel -> [inside, all]

    def span_self_us(self, name: str) -> float:
        return sum(u for s, u in zip(self.spans, self.self_us) if s[0] == name)


def _gaps(events: List[dict]) -> List[Tuple[float, float]]:
    """The device's idle intervals (µs) in the window, as parse() finds them."""
    calls = sorted((*_span(e), e["name"], (e.get("args") or {}).get("correlation"))
                   for e in events if e.get("cat") in _RUNTIME_CATS and "ts" in e)
    launched = {c[3]: c[0] for c in calls if c[3] is not None}
    dev = sorted((*_span(e), e["name"], (e.get("args") or {}).get("correlation"))
                 for e in events if e.get("cat") in _DEVICE_CATS and "ts" in e)
    markers = [d for d in dev if MARKER in d[2]]
    if not markers or markers[0][3] not in launched:
        return []
    w0 = launched[markers[0][3]]
    last = launched.get(markers[-1][3], markers[-1][0])
    ends = [c[1] for c in calls if c[2] == _SYNC and c[0] >= last]
    w1 = ends[0] if ends else max(d[1] for d in dev)
    ops = [d for d in dev if MARKER not in d[2] and d[1] > w0 and d[0] < w1]
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in ops])
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def _launch_calls(events: List[dict]) -> Dict[object, Tuple[float, float]]:
    return {(e.get("args") or {}).get("correlation"): _span(e) for e in events
            if e.get("cat") in _RUNTIME_CATS and "ts" in e
            and (e.get("args") or {}).get("correlation") is not None}


def join_clocks(events: List[dict], anchors: List[Tuple[int, int]],
                guess_us: Optional[float] = None) -> Dict[str, float]:
    """The offset (µs) to add to a span-clock time (ns / 1e3) to place it
    on the trace's clock, from the markers' launches, and its error; only
    the markers and launches found where none pair.  Each launch pairs
    with the anchor nearest it at ``guess_us`` (the wall clock's offset)
    if one lies within :data:`PAIR_US`, or else all pair in order where
    their numbers agree."""
    calls = _launch_calls(events)
    marks = sorted((_span(e)[0], (e.get("args") or {}).get("correlation"))
                   for e in events if e.get("cat") in _DEVICE_CATS and MARKER in e["name"])
    launches = [calls[c] for _, c in marks if c in calls]
    seen = {"marker_kernels": len(marks), "marker_launches": len(launches),
            "anchors": len(anchors)}
    pairs = []
    if guess_us is not None and anchors:
        mids = [(t0 + t1) / 2e3 + guess_us for t0, t1 in anchors]
        for ls, le in launches:
            i = min(range(len(mids)), key=lambda j: abs(mids[j] - ls))
            if abs(mids[i] - ls) <= PAIR_US:
                pairs.append(((ls, le), anchors[i]))
    if not pairs and len(launches) == len(anchors):
        pairs = list(zip(launches, anchors))
    if not pairs:
        return seen
    lo = max(le - t1 / 1e3 for (_, le), (_, t1) in pairs)
    hi = min(ls - t0 / 1e3 for (ls, _), (t0, _) in pairs)
    out = {"pairs": len(pairs), **seen}
    if lo <= hi:
        return {"offset_us": (lo + hi) / 2, "error_us": (hi - lo) / 2, **out}
    mids = [(ls + le) / 2 - (t0 + t1) / 2e3 for (ls, le), (t0, t1) in pairs]
    return {"offset_us": statistics.median(mids), "error_us": lo - hi,
            "inconsistent": 1.0, **out}


class _Timeline:
    """The innermost span open at a time, for properly nested spans kept in
    the order they opened."""

    def __init__(self, spans: List[tuple]):
        self.spans = spans
        self.starts = [s[1] for s in spans]

    def innermost(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][2] <= t:
            i = self.spans[i][3]
        return i

    def within(self, a: float, b: float, name: str) -> bool:
        i = self.innermost(a)
        while i >= 0:
            s = self.spans[i]
            if s[0] == name:
                return s[2] >= b
            i = s[3]
        return False


def analyse(events: List[dict], record, anchors: List[Tuple[int, int]],
            base_ns: int = 0) -> Window:
    """The :class:`Window` of a trace's events and the record made over
    them; ``anchors`` are the span clock's (before, after) of each
    marker's launch, ``base_ns`` the trace's ``baseTimeNanoseconds``."""
    w = Window(trace=parse(events), counters=dict(record.counters),
               launches=dict(record.launches))
    wall_us = (record.wall_offset_ns - base_ns) / 1e3
    w.clock = join_clocks(events, anchors, wall_us)
    if "offset_us" not in w.clock:
        return w
    off = w.clock["offset_us"]
    w.clock["wall_minus_anchored_us"] = wall_us - off
    w.spans = [(s.name, s.start / 1e3 + off, s.end / 1e3 + off, s.parent, s.sweep)
               for s in record.spans]
    w.self_us = [ns / 1e3 for ns in record.self_ns()]
    tl = _Timeline(w.spans)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in _gaps(events):
        i = tl.innermost(a)
        idle[w.spans[i][0] if i >= 0 else OUTSIDE] += (b - a) * 1e-6
    w.idle_by_span = dict(idle)
    calls = _launch_calls(events)
    first = anchors[0][0] / 1e3 + off      # the recording's first marker
    inside: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    for e in events:
        k = _kernel_of(e["name"]) if e.get("cat") in _DEVICE_CATS else None
        call = calls.get((e.get("args") or {}).get("correlation")) if k else None
        if k in KERNEL_SPANS and call is not None and call[0] >= first:
            inside[k][0] += tl.within(*call, KERNEL_SPANS[k])
            inside[k][1] += 1
    w.inside = {k: list(v) for k, v in inside.items()}
    return w


def recorded_window(sweep, n: int, tmpdir: Optional[str] = None) -> Window:
    """Run ``sweep`` once to settle the profiler, then ``n`` times, each
    after a marker, with a recording open over the marked sweeps and their
    ``synchronize()``; the :class:`Window` of what both saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    anchors: List[Tuple[int, int]] = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
        with tracing.recording() as rec:
            for _ in range(n):
                t0 = tracing.clock_ns()
                torch.cuda._sleep(1)
                anchors.append((t0, tracing.clock_ns()))
                sweep()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return analyse(data["traceEvents"], rec, anchors, int(data.get("baseTimeNanoseconds", 0)))


_last: Optional[tuple] = None   # (the run's Trace, its Window or None)


def window(ctx) -> Optional[Window]:
    """The recorded window of a traced run (made at the first call for the
    run's context), or None where nothing was traced or the program
    records no spans."""
    global _last
    if _last is not None and _last[0] is ctx.trace:
        return _last[1]
    w = None
    if ctx.trace.sweeps and ctx.probe is not None:
        try:
            import repro_torch.tracing  # noqa: F401
        except ImportError:
            pass
        else:
            w = _run(ctx)
    _last = (ctx.trace, w)
    return w


def program(ctx):
    """The cell's program in the state the traced run left: a copy of the
    probe sweep's topics, theta and phi resampled from their counts, and a
    fresh sparse cache where the mix holds one."""
    from bench.sut import Program

    cfg = ctx.cell.config
    z = ctx.probe[1].clone()
    prog = Program(cfg, ctx.cell.mix, ctx.corpus, 1, z.device)
    c = prog.corpus
    theta, phi, _ = reference.resample(prog.state.key, z, c.docs, c.mask, prog.alpha,
                                       prog.beta, int(cfg["K"]), c.vocab_size)
    prog.state = prog.state._replace(theta=theta, phi=phi, z=z)
    return prog


def _run(ctx) -> Window:
    import torch

    prog = program(ctx)
    prog.sweep()
    torch.cuda.synchronize()
    w = recorded_window(prog.sweep, int(ctx.cell.mix["trace_sweeps"]))
    prog.free()
    log(w)
    return w


def log(w: Window, out=None) -> None:
    out = out or sys.stderr
    c = w.counters
    parts = [f"sweeps {c.get('lda.sweeps', 0)}", f"chunks {c.get('lda.chunks', 0)}",
             f"host_syncs {c.get('host_syncs', 0)}",
             "launches " + json.dumps(w.launches, sort_keys=True)]
    if "sparse.cap" in c:
        parts.append(f"sparse.cap {c['sparse.cap']}")
    if c.get("sparse.proposals"):
        parts += [f"{k}_accept_rate {c.get(f'sparse.{k}_accepts', 0) / c['sparse.proposals']!r}"
                  for k in ("word", "doc")]
    print("program counters: " + ", ".join(parts), file=out)
    idle = sorted(w.idle_by_span.items(), key=lambda kv: -kv[1])
    print("idle by span (s): " + ", ".join(f"{k} {v!r}" for k, v in idle), file=out)
    t = w.trace
    print("clock check: " + json.dumps({
        **w.clock, "inside": w.inside, "idle_put_down_s": sum(w.idle_by_span.values()),
        "trace_idle_s": t.window_s - t.busy_s}, sort_keys=True), file=out)
