"""Spans and counters inside the port's LDA sweeps, kept in memory while a
recording is open.

Recording is off unless a caller opens :func:`recording`, the only
switch.  Off, :func:`span` returns one shared no-op object and
:func:`count` / :func:`gauge` return at once: a site costs a function
call, with no allocation, no clock read and no device operation.

On, each span keeps its name, start and end (``time.perf_counter_ns()``),
the enclosing span and the id its sweep's spans share (a sweep passes its
state's ``step``; a span given none takes its parent's).  Spans nest in
the order they open, on the thread that holds the recording.  Counters
are host numbers: ``count`` adds (a 0-d device tensor is kept as it is
and summed once, when the record closes, so the hot path never waits for
it), ``gauge`` keeps the last value.  The record also holds each kernel
module's ``LAUNCHES`` (``repro_torch.kernels.*.kernel``) counted over the
recording::

    from repro_torch import tracing

    with tracing.recording() as rec:
        for _ in range(8):
            state = gibbs.gibbs_step(state, corpus)
        torch.cuda.synchronize()
    print(rec.summary())

Span names in the sweeps: ``lda.sweep`` (the root), ``autotune.plan``,
``lda.draw_z``, ``lda.counts``, ``lda.theta``, ``lda.phi``,
``lda.sparse.tables``, ``lda.sparse.mh``, ``lda.sparse.sort`` and one
``sync.<site>`` around each read of a device value that a sweep forces.
Counters: ``lda.sweeps``, ``lda.chunks``, ``host_syncs``, ``sparse.cap``,
the MH ``sparse.word_accepts``, ``sparse.doc_accepts`` and
``sparse.proposals``, and ``sparse.fused_counts`` (lists built by the
``sparse_counts`` kernel's pass).
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch

clock_ns = time.perf_counter_ns


@dataclass(slots=True)
class Span:
    name: str
    start: int                  # ns, clock_ns
    end: int                    # ns; the record's close for a span still open then
    parent: int                 # index of the enclosing span in Record.spans, -1 if none
    sweep: Optional[int]        # the id a sweep's spans share (its state's step)


@dataclass
class Record:
    """What one recording kept.  ``wall_offset_ns`` is ``time.time_ns()``
    less ``clock_ns()`` when it opened, to place spans on a wall clock."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    wall_offset_ns: int = 0
    _stack: List[int] = field(default_factory=list, repr=False)
    _device: List[tuple] = field(default_factory=list, repr=False)

    def self_ns(self) -> List[int]:
        """Each span's duration less the time its child spans cover."""
        out = [s.end - s.start for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end - s.start
        return out

    def summary(self) -> dict:
        """Calls, total and self milliseconds by span name, the counters
        and the launches."""
        by: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
        for s, own in zip(self.spans, self.self_ns()):
            b = by[s.name]
            b[0] += 1
            b[1] += (s.end - s.start) * 1e-6
            b[2] += own * 1e-6
        return {"spans": {k: {"calls": v[0], "ms": v[1], "self_ms": v[2]}
                          for k, v in by.items()},
                "counters": dict(self.counters), "launches": dict(self.launches)}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_active: Optional[Record] = None


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_sweep", "_i")

    def __init__(self, rec: Record, name: str, sweep: Optional[int]):
        self._rec, self._name, self._sweep = rec, name, sweep

    def __enter__(self):
        rec = self._rec
        parent = rec._stack[-1] if rec._stack else -1
        sweep = self._sweep
        if sweep is None and parent >= 0:
            sweep = rec.spans[parent].sweep
        self._i = len(rec.spans)
        rec._stack.append(self._i)
        rec.spans.append(Span(self._name, clock_ns(), 0, parent, sweep))
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.spans[self._i].end = clock_ns()
        self._rec._stack.pop()
        return False


def span(name: str, sweep: Optional[int] = None):
    """A context manager around one piece of work: recorded while a
    recording is open, else the shared no-op."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name, sweep)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name``: an int at once, a 0-d device tensor
    when the record closes."""
    rec = _active
    if rec is None:
        return
    if isinstance(n, torch.Tensor):
        rec._device.append((name, n))
    else:
        rec.counters[name] = rec.counters.get(name, 0) + n


def gauge(name: str, value) -> None:
    """Set counter ``name`` to its last value."""
    rec = _active
    if rec is not None:
        rec.counters[name] = value


def _launches() -> Dict[str, int]:
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        parts = mod_name.split(".")
        if len(parts) == 4 and parts[:2] == ["repro_torch", "kernels"] \
                and parts[3] == "kernel" and isinstance(getattr(mod, "LAUNCHES", None), dict):
            out.update({f"{parts[2]}.{k}": v for k, v in mod.LAUNCHES.items()})
    return out


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record spans and counters until the block ends; yields the
    :class:`Record`, complete once the block has closed.  Closing sums the
    kept device counts, which waits for them: close after the window's
    own ``synchronize()``."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    rec = Record(wall_offset_ns=time.time_ns() - clock_ns())
    before = _launches()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        end = clock_ns()
        for s in rec.spans:
            if not s.end:
                s.end = end
        rec._stack.clear()
        rec.launches = {k: v - before.get(k, 0) for k, v in _launches().items()
                        if v != before.get(k, 0)}
        if rec._device:
            names = [n for n, _ in rec._device]
            vals = torch.stack([t.detach().reshape(()).to(torch.int64)
                                for _, t in rec._device]).tolist()
            for n, v in zip(names, vals):
                rec.counters[n] = rec.counters.get(n, 0) + v
            rec._device.clear()
