"""VirtualClock + VirtualTimer: the node's deterministic event loop core.

Re-creates the reference's ``src/util/Timer.h:66-217`` semantics:

  * ``VirtualClock`` owns *the* time source for a node, in one of two
    modes — REAL_TIME (wall clock) or VIRTUAL_TIME (time advances only
    when the event loop is idle, jumping straight to the next scheduled
    event).  VIRTUAL_TIME is what makes multi-node consensus tests
    deterministic and fast.
  * ``VirtualTimer`` schedules callbacks at a time point; cancellation
    invokes handlers with ``cancelled=True`` (asio error_code style).
  * ``crank(block=False)`` runs due timers + queued actions; returns the
    number of work items performed.
  * ``post_to_main`` / ``post_action`` enqueue callables, mirroring
    ``postOnMainThread`` + the Scheduler action queues.

Single-threaded consensus discipline: everything posted here runs on
whichever thread cranks the clock, one item at a time — the structural
concurrency model of the reference (``docs/architecture.md:24-27``).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from typing import Callable, List, Optional

from stellar_tpu_torch.utils.scheduler import ActionType, Scheduler

__all__ = ["VirtualClock", "VirtualTimer", "REAL_TIME", "VIRTUAL_TIME"]

REAL_TIME = "REAL_TIME"
VIRTUAL_TIME = "VIRTUAL_TIME"


class _Event:
    __slots__ = ("when", "seq", "callback", "cancelled")

    def __init__(self, when: float, seq: int, callback):
        self.when = when
        self.seq = seq
        self.callback = callback
        self.cancelled = False

    def __lt__(self, other):
        return (self.when, self.seq) < (other.when, other.seq)


class VirtualClock:
    def __init__(self, mode: str = VIRTUAL_TIME):
        if mode not in (REAL_TIME, VIRTUAL_TIME):
            raise ValueError(f"bad clock mode {mode}")
        self.mode = mode
        self._virtual_now = 0.0
        self._real_base = _time.monotonic()
        self._events: List[_Event] = []
        self._seq = itertools.count()
        self._scheduler = Scheduler(self)
        self._lock = threading.Lock()          # guards cross-thread posts
        self._main_queue: List[Callable] = []  # post_to_main from any thread
        self._main_thread = threading.current_thread()
        self._stopped = False

    # ---- time ----

    def now(self) -> float:
        """Seconds since clock epoch (monotonic)."""
        if self.mode == REAL_TIME:
            return _time.monotonic() - self._real_base
        return self._virtual_now

    def system_now(self) -> int:
        """Wall-clock seconds (close times). In VIRTUAL_TIME this is the
        virtual offset applied to a fixed epoch so tests are reproducible."""
        if self.mode == REAL_TIME:
            return int(_time.time())
        return int(VirtualClock.VIRTUAL_EPOCH + self._virtual_now)

    # Fixed epoch for virtual wall time: 2025-01-01T00:00:00Z.
    VIRTUAL_EPOCH = 1735689600

    def set_current_virtual_time(self, t: float):
        if self.mode != VIRTUAL_TIME:
            raise RuntimeError("not a virtual clock")
        if t < self._virtual_now:
            raise RuntimeError("virtual time cannot go backwards")
        self._virtual_now = t

    def sleep_for(self, seconds: float):
        """Advance time by cranking (virtual) or sleeping (real)."""
        deadline = self.now() + seconds
        while self.now() < deadline and not self._stopped:
            if self.crank(block=False) == 0:
                if self.mode == VIRTUAL_TIME:
                    nxt = self._next_event_time()
                    self._virtual_now = (min(nxt, deadline)
                                         if nxt is not None else deadline)
                else:
                    # a slow crank can overrun the deadline between the
                    # loop check and here; never sleep a negative span
                    _time.sleep(max(0.0, min(0.001,
                                             deadline - self.now())))

    # ---- event scheduling ----

    def _enqueue(self, ev: _Event):
        heapq.heappush(self._events, ev)

    def _next_event_time(self) -> Optional[float]:
        while self._events and self._events[0].cancelled:
            heapq.heappop(self._events)
        return self._events[0].when if self._events else None

    def post_to_main(self, fn: Callable, name: str = "main",
                     action_type: ActionType = ActionType.NORMAL):
        """Thread-safe enqueue onto the cranking thread (reference
        ``postOnMainThread``)."""
        if threading.current_thread() is self._main_thread:
            self._scheduler.enqueue(name, fn, action_type)
        else:
            with self._lock:
                self._main_queue.append((name, fn, action_type))

    def post_action(self, fn: Callable, name: str = "action",
                    action_type: ActionType = ActionType.NORMAL):
        self._scheduler.enqueue(name, fn, action_type)

    @property
    def scheduler(self) -> Scheduler:
        return self._scheduler

    def is_stopped(self) -> bool:
        return self._stopped

    def stop(self):
        self._stopped = True

    # ---- the crank ----

    def _drain_cross_thread(self):
        with self._lock:
            pending, self._main_queue = self._main_queue, []
        for name, fn, at in pending:
            self._scheduler.enqueue(name, fn, at)

    def crank(self, block: bool = False) -> int:
        """Run one batch of due work; the reference's
        ``VirtualClock::crank`` (``Timer.h:193``). Returns #items run."""
        if self._stopped:
            return 0
        progress = 0
        self._drain_cross_thread()
        # 1. fire due timers
        now = self.now()
        while self._events and self._events[0].when <= now:
            ev = heapq.heappop(self._events)
            if not ev.cancelled:
                ev.callback(False)
                progress += 1
        # 2. run queued actions (bounded batch for fairness with timers)
        progress += self._scheduler.run_some(max_items=64)
        if progress == 0 and block:
            if self.mode == VIRTUAL_TIME:
                nxt = self._next_event_time()
                if nxt is not None:
                    self._virtual_now = max(self._virtual_now, nxt)
                    return self.crank(block=False)
            else:
                nxt = self._next_event_time()
                wait = 0.001 if nxt is None else max(0.0, min(nxt - now, 0.05))
                _time.sleep(wait)
                return self.crank(block=False)
        return progress

    def crank_until(self, pred: Callable[[], bool], timeout: float) -> bool:
        """Crank until pred() or ``timeout`` (clock-relative) elapses."""
        deadline = self.now() + timeout
        while not pred():
            if self.now() >= deadline or self._stopped:
                return pred()
            if self.crank(block=True) == 0 and self.mode == VIRTUAL_TIME \
                    and self._next_event_time() is None \
                    and self._scheduler.size() == 0:
                return pred()  # fully idle virtual clock: nothing will change
        return True


class VirtualTimer:
    """One-shot timer bound to a VirtualClock (``Timer.h:222``).
    ``cancel`` fires the cancel handler of **every** pending wait, like
    the reference's asio timer cancellation."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._events: List[_Event] = []
        self._when: Optional[float] = None

    def expires_at(self, when: float):
        self.cancel()
        self._when = when

    def expires_from_now(self, seconds: float):
        self.expires_at(self._clock.now() + seconds)

    def async_wait(self, on_fire: Callable[[], None],
                   on_cancel: Optional[Callable[[], None]] = None):
        if self._when is None:
            raise RuntimeError("async_wait before expires_at/from_now")

        def handler(cancelled: bool):
            if cancelled:
                if on_cancel is not None:
                    on_cancel()
            else:
                on_fire()
        ev = _Event(self._when, next(self._clock._seq), handler)
        self._events.append(ev)
        self._clock._enqueue(ev)

    def cancel(self):
        pending, self._events = self._events, []
        self._when = None
        for ev in pending:
            if not ev.cancelled:
                ev.cancelled = True
                ev.callback(True)

    def seconds_remaining(self) -> float:
        live = [ev.when for ev in self._events if not ev.cancelled]
        if not live:
            return 0.0
        return max(0.0, min(live) - self._clock.now())
