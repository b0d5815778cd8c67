"""One run of one cell: set-up, the measured or traced window, the check.

Set-up makes the corpus on the device from the seed, builds the program's
start and drives it through the mix's ``checked_sweeps`` sweeps with the
window's own call, copying the start and each sweep's (theta, phi, z) to
the host for the judge (those copies are timed and left out of
``setup_s``).  The same program object then enters the window:

* ``trace=False``: sweeps back to back for ``seconds``; the clock stops at
  the ``synchronize()`` after the last sweep issued, so every counted
  sweep has finished.  ``tokens_per_s`` = live tokens x sweeps / time.
* ``trace=True``: sweeps untraced for at least ``timing_seconds`` (the time
  a sweep that ``sweep_mfu`` reads), then ``trace_sweeps`` sweeps under the
  profiler (:mod:`bench.trace`; on a CPU, in tests, nothing is traced),
  then one probe sweep whose topics before and after the readers may count
  from; each per-layer metric's reader turns these into its number.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the checked sweeps
(:class:`bench.reference.Judge`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from bench import manifest, reference
from bench.corpus import BenchCorpus, make_corpus
from bench.sut import Program
from bench.trace import Trace, traced_sweeps


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    cell: manifest.Cell
    trace: Trace
    sweep_s: float            # seconds a sweep, untraced, host clock
    corpus: BenchCorpus
    probe: tuple              # (z before, z after) of one sweep after the trace


def seeds(seed: int):
    """(corpus seed, state seed) from the run's ``--seed``."""
    s = int(seed) % (1 << 62)
    return s, s + (1 << 62)


def setup(c: manifest.Cell, seed: int, device, t_start: float):
    """The corpus, the program after its checked sweeps, the host copies of
    its start and of each checked sweep's (theta, phi, z), and the set-up's
    stage times (``copies_s``: the copies, left out of ``setup_s``)."""
    dev = torch.device(device)
    cfg, mix = c.config, c.mix
    corpus_seed, state_seed = seeds(seed)
    times = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    corpus = make_corpus(cfg, corpus_seed, dev)
    _sync(dev)
    times["corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = Program(cfg, mix, corpus, state_seed, dev)
    _sync(dev)
    times["init_s"] = time.perf_counter() - t
    snaps: list = []
    times["copies_s"] = 0.0
    t_sweeps = time.perf_counter()
    for i in range(int(mix["checked_sweeps"]) + 1):
        if i:
            prog.sweep()
        _sync(dev)
        t = time.perf_counter()
        snaps.append(prog.snapshot())
        times["copies_s"] += time.perf_counter() - t
    times["sweeps_s"] = time.perf_counter() - t_sweeps - times["copies_s"]
    return corpus, prog, snaps, times


def check(c: manifest.Cell, corpus: BenchCorpus, snaps: list, seed: int, device) -> dict:
    """Each number the judge compares, beside its limit."""
    numbers = reference.Judge(c.config, c.mix, corpus.docs, corpus.mask, seeds(seed)[1],
                              device).numbers(snaps)
    return reference.judge(numbers, c.mix["limits"])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(c: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, tmpdir: Optional[str] = None, log=None) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mix = c.mix
    corpus, prog, snaps, times = setup(c, seed, dev, t_start)
    live = corpus.live_tokens
    setup_s = time.perf_counter() - t_start - times["copies_s"]
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    device_info = {}
    if not trace:
        n = 0
        t0 = time.perf_counter()
        while True:
            prog.sweep()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        elapsed = time.perf_counter() - t0
        values = {"tokens_per_s": live * n / elapsed, "setup_s": setup_s}
        values = {m["name"]: values[m["name"]] for m in c.end_to_end}
        attempted = n
    else:
        prog.sweep()
        _sync(dev)
        n = 0
        t0 = time.perf_counter()
        while n < 2 or time.perf_counter() - t0 < float(mix["timing_seconds"]):
            prog.sweep()
            n += 1
        _sync(dev)
        sweep_s = (time.perf_counter() - t0) / n
        tr = traced_sweeps(prog.sweep, int(mix["trace_sweeps"]), tmpdir) if cuda else Trace()
        z_in = prog.state.z.clone()
        prog.sweep()
        _sync(dev)
        ctx = Context(cell=c, trace=tr, sweep_s=sweep_s, corpus=corpus,
                      probe=(z_in, prog.state.z))
        values = {}
        for name, reader in manifest.load_readers(c).items():
            v = reader.read(ctx)
            if v is not None:
                values[name] = float(v)
        attempted = tr.sweeps
        device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tr.breakdown()
        del ctx, z_in
    device = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0,
        **device_info,
    }
    prog.free()
    del prog
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(c, corpus, snaps, seed, dev)
    times["check_s"] = time.perf_counter() - t
    if log is not None:
        log("set-up and check stages (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
    result = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": attempted,
        "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device,
    }
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
