"""A traced run of sweeps and what its trace says.

:func:`traced_sweeps` runs sweeps under ``torch.profiler`` tracing the
card only (``ProfilerActivity.CUDA``: kernels, copies, sets and the host's
CUDA runtime calls; recording every host operator as well doubled the
host's time a dense sweep, 0.415 s against ~0.2 s, so the traced window
would not stand for the measured one).  Before each sweep it launches a
marker kernel (``torch.cuda._sleep(1)``, ``spin_kernel``), and closes the
window with ``torch.cuda.synchronize()``.  :func:`parse` reads the Chrome
trace:

* ``window_s``: from the host's launch of the first marker to the end of
  the synchronisation after the last sweep; ``busy_s``: the union of the
  device's kernels, copies and sets in that window (markers left out);
* each device operation's stage: an operation belongs to the sweep whose
  marker ran last before it on the stream, and to its ``draw`` stage if it
  ran no later than the sweep's last draw kernel (``layers.json``), else
  to its ``resample`` stage;
* the device time of each kernel name, and of each of ``layers.json``'s
  kernels (K6, K7, K8, S1) with their launches;
* the device's idle time in the window by what the host was doing when
  each gap began: inside a runtime call (``in cudaStreamSynchronize``), or
  the last runtime call it had made (``after cudaLaunchKernel``: Python
  and PyTorch's dispatch between launches).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from bench.manifest import read_json

LAYERS = read_json("layers.json")
MARKER = "spin_kernel"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_SYNC = "cudaDeviceSynchronize"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    sweeps: int = 0
    stage_s: Dict[str, float] = field(default_factory=dict)
    by_name: Dict[str, List[float]] = field(default_factory=dict)   # name -> [s, n]
    by_kernel: Dict[str, List[float]] = field(default_factory=dict)  # K8 -> [s, n]
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), v[0]] for n, v in ops],
                "idle_gaps": [[_short(n), s] for n, s in gaps]}


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def traced_sweeps(sweep: Callable[[], None], n: int, tmpdir: Optional[str] = None
                  ) -> Trace:
    """Run ``sweep`` once to settle the profiler, then ``n`` times in the
    traced window, each after a marker, and parse the trace (CUDA only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
        for _ in range(n):
            torch.cuda._sleep(1)
            sweep()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def _kernel_of(name: str) -> Optional[str]:
    for k, pats in LAYERS["kernels"].items():
        if any(p in name for p in pats):
            return k
    return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _span(e: dict) -> Tuple[float, float]:
    a = float(e["ts"])
    return a, a + float(e.get("dur", 0.0))


def parse(events: List[dict]) -> Trace:
    """The :class:`Trace` of a Chrome trace's ``traceEvents`` (µs)."""
    out = Trace()
    calls = sorted((*_span(e), e["name"], (e.get("args") or {}).get("correlation"))
                   for e in events if e.get("cat") in _RUNTIME_CATS and "ts" in e)
    launched = {c[3]: c[0] for c in calls if c[3] is not None}
    dev = sorted((*_span(e), e["name"], (e.get("args") or {}).get("correlation"))
                 for e in events if e.get("cat") in _DEVICE_CATS and "ts" in e)
    markers = [d for d in dev if MARKER in d[2]]
    if not markers or markers[0][3] not in launched:
        return out
    w0 = launched[markers[0][3]]
    last = launched.get(markers[-1][3], markers[-1][0])
    ends = [c[1] for c in calls if c[2] == _SYNC and c[0] >= last]
    w1 = ends[0] if ends else max(d[1] for d in dev)
    out.window_s = (w1 - w0) * 1e-6
    out.sweeps = len(markers)
    ops = [d for d in dev if MARKER not in d[2] and d[1] > w0 and d[0] < w1]
    # each sweep's operations on the stream, from its marker to the next
    bounds = [m[0] for m in markers]
    sweeps: List[List[tuple]] = [[] for _ in markers]
    for d in ops:
        i = bisect.bisect_right(bounds, d[0]) - 1
        if i >= 0:
            sweeps[i].append(d)
    stage_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for sw in sweeps:
        draws = [j for j, d in enumerate(sw) if _kernel_of(d[2]) in LAYERS["draw_kernels"]]
        for j, (a, b, name, _) in enumerate(sw):
            s = (min(b, w1) - max(a, w0)) * 1e-6
            by_name[name][0] += s
            by_name[name][1] += 1
            k = _kernel_of(name)
            if k is not None:
                by_kernel[k][0] += s
                by_kernel[k][1] += 1
            if not draws:
                stage_s["unattributed"] += s
            else:
                stage_s["draw" if j <= draws[-1] else "resample"] += s
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in ops])
    out.busy_s = sum(b - a for a, b in busy) * 1e-6
    # idle gaps in the window, by the host's runtime call where each began
    starts = [c[0] for c in calls]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i < 0:
            what = "host: before any runtime call"
        elif calls[i][1] > a:
            what = f"in {calls[i][2]}"
        else:
            what = f"after {calls[i][2]}"
        idle[what] += (b - a) * 1e-6
    out.stage_s = dict(stage_s)
    out.by_name = {k: list(v) for k, v in by_name.items()}
    out.by_kernel = {k: list(v) for k, v in by_kernel.items()}
    out.idle_by_host = dict(idle)
    return out
