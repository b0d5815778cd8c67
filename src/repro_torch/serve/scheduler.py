"""Admission control + slot scheduling for continuous batching, a copy of
``repro.serve.scheduler``.

The scheduler owns the two resources of the serving system: a bounded
waiting queue (admission control — beyond ``max_waiting`` a submission is
*rejected*, never silently dropped or unboundedly buffered) and the
``max_slots`` decode slots of the fixed-shape batch.  Policy is FCFS:
freed slots are refilled from the queue head between decode steps, which
is exactly the WarpLDA/EZLDA restructuring argument applied to serving —
the hot path (one decode step) never changes shape; all churn
lives in this layer as data.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.serve.request import Request, RequestState

__all__ = ["QueueFullError", "Scheduler"]


class QueueFullError(RuntimeError):
    """Admission control: the waiting queue is at ``max_waiting``."""


class Scheduler:
    def __init__(self, max_slots: int, max_waiting: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_waiting < 0:
            raise ValueError(f"max_waiting must be >= 0, got {max_waiting}")
        self.max_slots = max_slots
        self.max_waiting = max_waiting
        self._waiting: Deque[Request] = deque()
        self._slots: List[Optional[Request]] = [None] * max_slots
        self._next_id = 0
        self.stats: Dict[str, int] = {
            "submitted": 0,
            "rejected": 0,
            "finished": 0,
        }

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Admit a request into the waiting queue, or reject it.

        Raises :class:`QueueFullError` when the queue holds
        ``max_waiting`` requests already (the request is marked REJECTED
        so a caller holding a handle sees a terminal state)."""
        if len(self._waiting) >= self.max_waiting:
            self.stats["rejected"] += 1
            req.state = RequestState.REJECTED
            raise QueueFullError(
                f"waiting queue full ({self.max_waiting}); request rejected"
            )
        req.id = self._next_id
        self._next_id += 1
        req.state = RequestState.QUEUED
        self._waiting.append(req)
        self.stats["submitted"] += 1
        return req

    # -- slots -------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def bind(self, slot: int, req: Request) -> None:
        if self._slots[slot] is not None:
            raise RuntimeError(f"slot {slot} already bound to {self._slots[slot]}")
        self._slots[slot] = req
        req.slot = slot
        req.state = RequestState.DECODING

    def release(self, slot: int) -> Request:
        req = self._slots[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is not bound")
        self._slots[slot] = None
        req.slot = None
        self.stats["finished"] += 1
        return req

    def bound(self, slot: int) -> Optional[Request]:
        return self._slots[slot]

    def next_waiting(self) -> Optional[Request]:
        """Pop the FCFS head of the waiting queue (None when empty)."""
        return self._waiting.popleft() if self._waiting else None

    # -- introspection -------------------------------------------------------

    @property
    def waiting_depth(self) -> int:
        return len(self._waiting)

    @property
    def active_slots(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def idle(self) -> bool:
        return self.active_slots == 0 and not self._waiting

    def active_requests(self) -> List[Request]:
        return [r for r in self._slots if r is not None]
