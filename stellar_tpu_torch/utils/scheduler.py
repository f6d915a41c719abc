"""Fair multi-queue action scheduler with load shedding.

The reference's ``src/util/Scheduler.h:20-121``: actions are enqueued into
named queues; queues are serviced in least-recently-serviced order
(approximate fairness); DROPPABLE actions are shed when the scheduler's
aggregate queue latency exceeds a threshold. The reference uses this to
keep consensus responsive under overlay flood load.
"""

from __future__ import annotations

import enum
import time as _time
from collections import deque
from typing import Callable, Deque, Dict, Tuple

__all__ = ["ActionType", "Scheduler"]


class ActionType(enum.Enum):
    NORMAL = 0
    DROPPABLE = 1


class _Queue:
    __slots__ = ("name", "items", "last_service", "total_service_time")

    def __init__(self, name: str):
        self.name = name
        self.items: Deque[Tuple[Callable, ActionType, float]] = deque()
        self.last_service = 0.0
        self.total_service_time = 0.0


class Scheduler:
    # Shed DROPPABLE work when the oldest queued action has waited longer
    # than this many (clock) seconds — the reference's latency window.
    LATENCY_WINDOW = 5.0

    def __init__(self, clock=None):
        self._clock = clock
        self._queues: Dict[str, _Queue] = {}
        self._size = 0
        self.actions_run = 0
        self.actions_dropped = 0

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None \
            else _time.monotonic()

    def enqueue(self, name: str, fn: Callable,
                action_type: ActionType = ActionType.NORMAL):
        q = self._queues.get(name)
        if q is None:
            q = self._queues[name] = _Queue(name)
        now = self._now()
        if action_type is ActionType.DROPPABLE and self._overloaded(now):
            self.actions_dropped += 1
            return
        q.items.append((fn, action_type, now))
        self._size += 1

    def _overloaded(self, now: float) -> bool:
        oldest = None
        for q in self._queues.values():
            if q.items:
                t = q.items[0][2]
                oldest = t if oldest is None else min(oldest, t)
        return oldest is not None and (now - oldest) > self.LATENCY_WINDOW

    def size(self) -> int:
        return self._size

    def queue_sizes(self) -> Dict[str, int]:
        return {n: len(q.items) for n, q in self._queues.items() if q.items}

    def run_one(self) -> bool:
        """Service the least-recently-serviced non-empty queue."""
        best = None
        for q in self._queues.values():
            if q.items and (best is None
                            or q.last_service < best.last_service):
                best = q
        if best is None:
            return False
        fn, action_type, enq_time = best.items.popleft()
        self._size -= 1
        now = self._now()
        best.last_service = now
        if action_type is ActionType.DROPPABLE and \
                (now - enq_time) > self.LATENCY_WINDOW:
            self.actions_dropped += 1
            return True
        fn()
        self.actions_run += 1
        best.total_service_time += self._now() - now
        return True

    def run_some(self, max_items: int = 64) -> int:
        n = 0
        while n < max_items and self.run_one():
            n += 1
        return n

    def stats(self) -> dict:
        return {"run": self.actions_run, "dropped": self.actions_dropped,
                "queued": self._size}
