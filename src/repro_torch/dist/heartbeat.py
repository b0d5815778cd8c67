"""Cross-process heartbeats: a file mailbox driving ``StepMonitor``, a copy
of ``repro.dist.heartbeat`` with the same on-disk mailbox format.

`repro_torch.dist.monitor.StepMonitor` answers "who is slow, who is dead" —
but it only sees what it is fed, and in a multi-process run each host
only *knows* its own step times.  This module is the transport between
the two: every host writes its own timings into a per-host mailbox file
on shared storage, and whichever process runs the monitor (process 0 in
the launcher) polls the mailboxes and feeds the monitor genuinely
per-host rows.

Two transports share one interface (``beat`` / ``read``):

- :class:`FileMailbox` — one ``host{i}.json`` per host in a shared
  directory (the checkpoint filesystem is the natural place).  Writes
  are atomic (tmp + ``os.replace``) so a reader never parses a torn
  file, and each file carries a small ring of recent step records so a
  slow poller misses nothing.
- :class:`LocalMailbox` — the in-process fallback with the same
  interface, used by single-process runs and unit tests (no filesystem,
  no clock skew).

Timestamps are wall-clock (``time.time()``): they must be comparable
*across* processes, which monotonic clocks are not.  Pass the same
clock into ``StepMonitor.dead_hosts(now=...)`` when polling.

:class:`MonitorFeeder` closes the loop: it refreshes per-host
heartbeats on every poll (dead-host detection needs no complete rows)
and assembles aligned per-step ``(host0_time, host1_time, ...)`` rows —
feeding ``monitor.record`` only for steps every host has reported, in
step order, so straggler medians compare like with like.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional

# Each mailbox file keeps the host's most recent step records; a poller
# that misses a few beats still reconstructs complete rows.
RING = 32

_PREFIX = "host"


class Beat:
    """One host's latest mailbox contents: heartbeat time + step ring."""

    __slots__ = ("host", "time", "steps")

    def __init__(self, host: int, time_: float, steps: List[dict]):
        self.host = int(host)
        self.time = float(time_)
        # each: {"step": int, "step_time": float, "tokens": float}
        self.steps = steps

    def __repr__(self):
        """Debug form: host, age-defining timestamp, ring length."""
        return f"Beat(host={self.host}, time={self.time:.3f}, n={len(self.steps)})"


class FileMailbox:
    """Per-host heartbeat files in a shared directory (atomic writes).

    Parameters
    ----------
    dir: the mailbox directory — must be on storage every host and the
        monitoring process can reach (the checkpoint dir qualifies).
    host: this process's host index; defaults to the
        ``torch.distributed`` rank (0 without a process group).
    """

    def __init__(self, dir: str, host: Optional[int] = None):
        if host is None:
            import torch.distributed as dist

            host = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        self.dir = dir
        self.host = int(host)
        self._ring: collections.deque = collections.deque(maxlen=RING)
        os.makedirs(dir, exist_ok=True)

    def _path(self, host: int) -> str:
        return os.path.join(self.dir, f"{_PREFIX}{host}.json")

    def beat(
        self,
        step: Optional[int] = None,
        step_time: Optional[float] = None,
        tokens: float = 0.0,
        now: Optional[float] = None,
    ) -> None:
        """Refresh this host's heartbeat, optionally recording a step time.

        A bare ``beat()`` (no step) is a liveness-only heartbeat — e.g.
        during a long compile.  With ``step``/``step_time`` the record
        also enters the ring the feeder aligns into monitor rows.
        """
        now = time.time() if now is None else float(now)
        if step is not None:
            self._ring.append({
                "step": int(step),
                "step_time": float(step_time if step_time is not None else 0.0),
                "tokens": float(tokens),
            })
        payload = {"host": self.host, "time": now, "steps": list(self._ring)}
        tmp = self._path(self.host) + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(self.host))

    def read(self) -> Dict[int, Beat]:
        """All hosts' latest beats (unparseable/foreign files skipped)."""
        out: Dict[int, Beat] = {}
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return out
        for name in names:
            if not (name.startswith(_PREFIX) and name.endswith(".json")):
                continue
            try:
                host = int(name[len(_PREFIX):-len(".json")])
                with open(os.path.join(self.dir, name)) as f:
                    p = json.load(f)
                out[host] = Beat(host, p["time"], list(p.get("steps", [])))
            except (ValueError, KeyError, OSError, json.JSONDecodeError):
                continue
        return out


class LocalMailbox:
    """In-process mailbox with the :class:`FileMailbox` interface.

    The single-process fallback: ``beat``/``read`` hit a dict instead of
    the filesystem, so the launcher's monitor loop is identical code in
    both worlds.
    """

    def __init__(self, host: int = 0):
        self.host = int(host)
        self._ring: collections.deque = collections.deque(maxlen=RING)
        self._beats: Dict[int, Beat] = {}

    def beat(
        self,
        step: Optional[int] = None,
        step_time: Optional[float] = None,
        tokens: float = 0.0,
        now: Optional[float] = None,
    ) -> None:
        """Same contract as :meth:`FileMailbox.beat`, minus the disk."""
        now = time.time() if now is None else float(now)
        if step is not None:
            self._ring.append({
                "step": int(step),
                "step_time": float(step_time if step_time is not None else 0.0),
                "tokens": float(tokens),
            })
        self._beats[self.host] = Beat(self.host, now, list(self._ring))

    def read(self) -> Dict[int, Beat]:
        """All hosts' latest beats (only ever this process's own)."""
        return dict(self._beats)


def open_mailbox(dir: Optional[str] = None, host: Optional[int] = None):
    """The right transport for this run: file-backed iff ``dir`` is set."""
    if dir:
        return FileMailbox(dir, host=host)
    return LocalMailbox(host=host or 0)


class MonitorFeeder:
    """Polls a mailbox and feeds a ``StepMonitor`` aligned per-host rows.

    Call :meth:`poll` from the monitoring process (typically once per
    step, or on a timer).  Each poll:

    1. refreshes every host's heartbeat from its beat timestamp —
       ``monitor.dead_hosts(now=time.time())`` then works without any
       completed rows (a host that died during its very first step is
       still detected);
    2. collects the per-step records from each host's ring and, for
       every step ALL ``monitor.num_hosts`` hosts have reported (in
       step order), calls ``monitor.record([t_0 .. t_{H-1}],
       tokens=sum)`` stamped at the row's newest beat time — so the
       straggler/shard-weight medians compare the same steps across
       hosts.
    """

    def __init__(self, monitor, mailbox):
        self.monitor = monitor
        self.mailbox = mailbox
        # step -> {host: (step_time, tokens)}
        self._pending: Dict[int, Dict[int, tuple]] = {}
        self._fed_through = -1

    def poll(self, now: Optional[float] = None) -> List[int]:
        """One mailbox scan; returns the step numbers fed this call."""
        beats = self.mailbox.read()
        for host, b in beats.items():
            if host >= self.monitor.num_hosts:
                continue
            self.monitor.heartbeat(host, now=b.time)
            for rec in b.steps:
                s = int(rec["step"])
                if s <= self._fed_through:
                    continue
                row = self._pending.setdefault(s, {})
                row[host] = (
                    float(rec["step_time"]), float(rec.get("tokens", 0.0)),
                    b.time,
                )
        fed: List[int] = []
        for s in sorted(self._pending):
            row = self._pending[s]
            if len(row) < self.monitor.num_hosts:
                continue
            times = [row[h][0] for h in range(self.monitor.num_hosts)]
            tokens = sum(row[h][1] for h in range(self.monitor.num_hosts))
            stamp = max(row[h][2] for h in range(self.monitor.num_hosts))
            self.monitor.record(times, tokens=tokens or None, now=stamp)
            fed.append(s)
            self._fed_through = max(self._fed_through, s)
            del self._pending[s]
        # rows for steps at/below the high-water mark can never complete
        for s in [s for s in self._pending if s <= self._fed_through]:
            del self._pending[s]
        return fed
