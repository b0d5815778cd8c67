"""Multi-host step monitoring: throughput, stragglers, dead hosts, a copy
of ``repro.dist.monitor`` (numpy and the standard library only).

``StepMonitor`` aggregates per-host step times over a sliding window and
answers three questions the launcher asks every few steps:

- how fast are we? (:meth:`summary`: mean/p50 step time, tokens/sec)
- is one host consistently slow? (:meth:`flagged_hosts` — a host whose
  median step time exceeds ``straggler_ratio`` x the fleet median; the
  elastic data loader can rebalance with :meth:`shard_weights`)
- is a host gone? (:meth:`dead_hosts` — heartbeat older than
  ``heartbeat_timeout``; ``record``/``heartbeat`` refresh it)

Everything is plain numpy on the host — nothing here traces or touches
devices, so the monitor can run inside the step loop at zero cost.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np


class StepMonitor:
    """Sliding-window per-host step statistics for the launcher.

    Feed it aligned rows (``record``) and liveness pings
    (``heartbeat``) — in multi-process runs both arrive through
    :class:`repro_torch.dist.heartbeat.MonitorFeeder`, which polls every
    host's mailbox and aligns complete per-step rows; single-process
    runs call them directly.  Timestamps passed as ``now`` must come
    from one consistent clock: ``time.time()`` when rows cross
    processes (see :mod:`repro_torch.dist.heartbeat`), the default
    ``time.monotonic()`` otherwise.
    """

    def __init__(
        self,
        num_hosts: int = 1,
        window: int = 64,
        straggler_ratio: float = 1.5,
        min_records: int = 4,
        heartbeat_timeout: float = 60.0,
    ):
        self.num_hosts = int(num_hosts)
        self.window = int(window)
        self.straggler_ratio = float(straggler_ratio)
        self.min_records = int(min_records)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._times: Deque[np.ndarray] = collections.deque(maxlen=self.window)
        self._tokens: Deque[float] = collections.deque(maxlen=self.window)
        self._last_heartbeat = np.full(self.num_hosts, -np.inf)
        self._steps = 0
        # timestamp of the first beat anywhere in the fleet: never-beaten
        # hosts are measured against it, not -inf, so startup compile skew
        # (one rank beating while another still traces) can't false-flag
        self._armed_at: Optional[float] = None

    # -- feeding -----------------------------------------------------------

    def record(
        self,
        step_times: Sequence[float],
        tokens: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """One training step's per-host wall times (len == num_hosts).

        ``tokens`` is the *global* token count of the step (for
        tokens/sec).  Reporting a time is also a heartbeat."""
        t = np.asarray(step_times, np.float64).reshape(-1)
        if t.shape[0] != self.num_hosts:
            raise ValueError(
                f"expected {self.num_hosts} per-host times, got {t.shape[0]}"
            )
        self._times.append(t)
        self._tokens.append(float(tokens) if tokens is not None else 0.0)
        now = time.monotonic() if now is None else now
        self._last_heartbeat[np.isfinite(t)] = now
        self._steps += 1
        if self._armed_at is None:
            self._armed_at = now

    def heartbeat(self, host: int, now: Optional[float] = None) -> None:
        """Mark ``host`` alive at ``now`` without recording a step time.

        The feeder calls this on every mailbox poll, so a host that
        dies before the fleet completes a single aligned row is still
        detected by :meth:`dead_hosts`."""
        now = time.monotonic() if now is None else now
        self._last_heartbeat[int(host)] = now
        if self._armed_at is None:
            self._armed_at = now

    # -- straggler detection -----------------------------------------------

    def _host_medians(self) -> Optional[np.ndarray]:
        if len(self._times) < self.min_records:
            return None
        return np.median(np.stack(self._times), axis=0)

    def flagged_hosts(self) -> List[int]:
        """Hosts whose median step time over the window exceeds
        ``straggler_ratio`` x the fleet median (empty before
        ``min_records`` steps — no cold-start false positives)."""
        med = self._host_medians()
        if med is None:
            return []
        fleet = np.median(med)
        return [int(i) for i in np.nonzero(med > self.straggler_ratio * fleet)[0]]

    def shard_weights(self) -> np.ndarray:
        """Relative data-shard weights ~ speed: ``w_i = (1/t_i)``
        normalized to sum to ``num_hosts`` (so 1.0 = a fair share).  The
        elastic pipeline can feed a straggler proportionally less."""
        med = self._host_medians()
        if med is None:
            return np.ones(self.num_hosts)
        inv = 1.0 / np.maximum(med, 1e-9)
        return inv * (self.num_hosts / inv.sum())

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        """Hosts with no heartbeat for ``heartbeat_timeout`` seconds.

        Empty until the first ``record``/``heartbeat`` arrives (an idle
        monitor flags nobody).  A host that has *never* beaten is
        measured from that first beat, so it goes dead once the timeout
        elapses — but startup skew (one rank still compiling while
        another already beats) doesn't false-flag it instantly."""
        if self._armed_at is None:
            return []
        now = time.monotonic() if now is None else now
        last = np.maximum(self._last_heartbeat, self._armed_at)
        stale = now - last > self.heartbeat_timeout
        return [int(i) for i in np.nonzero(stale)[0]]

    # -- reporting ----------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """One dict of fleet-level stats (JSON-serializable) — the rows CI
        attaches to the bench artifact (`summary_rows` flattens per-host)."""
        if not self._times:
            return {"steps": 0, "hosts": self.num_hosts}
        stacked = np.stack(self._times)          # (steps, hosts)
        slowest = stacked.max(axis=1)            # the step critical path
        tokens = float(np.sum(self._tokens))
        sec = float(np.sum(slowest))
        return {
            "steps": self._steps,
            "hosts": self.num_hosts,
            "window": len(self._times),
            "step_ms_mean": float(slowest.mean() * 1e3),
            "step_ms_p50": float(np.median(slowest) * 1e3),
            "step_ms_p99": float(np.percentile(slowest, 99) * 1e3),
            "tokens_per_sec": tokens / sec if sec > 0 and tokens > 0 else 0.0,
            "stragglers": self.flagged_hosts(),
            "dead_hosts": self.dead_hosts(),
        }

    def summary_rows(self) -> List[Dict[str, object]]:
        """Per-host rows for artifact upload: median/mean step time,
        relative weight, straggler flag."""
        med = self._host_medians()
        if med is None:
            return []
        w = self.shard_weights()
        flagged = set(self.flagged_hosts())
        stacked = np.stack(self._times)
        return [
            {
                "host": int(i),
                "step_ms_median": float(med[i] * 1e3),
                "step_ms_mean": float(stacked[:, i].mean() * 1e3),
                "shard_weight": float(w[i]),
                "straggler": bool(i in flagged),
            }
            for i in range(self.num_hosts)
        ]

    def to_markdown(self) -> str:
        """The :meth:`summary_rows` table as GitHub markdown (for BENCH
        artifacts and step-log dumps)."""
        rows = self.summary_rows()
        if not rows:
            return "(no monitor records)"
        out = [
            "| host | median ms | mean ms | weight | straggler |",
            "|---|---|---|---|---|",
        ]
        for r in rows:
            out.append(
                f"| {r['host']} | {r['step_ms_median']:.1f} | "
                f"{r['step_ms_mean']:.1f} | {r['shard_weight']:.2f} | "
                f"{'YES' if r['straggler'] else ''} |"
            )
        return "\n".join(out)
