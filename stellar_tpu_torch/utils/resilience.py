"""Circuit breaker and deadlines for the port's dispatch fault domains —
the port's copy of ``stellar_tpu/utils/resilience.py``.

* :class:`CircuitBreaker`: closed -> open on a consecutive-failure
  threshold -> half-open re-probe after an exponential backoff window,
  with jitter so a fleet of nodes does not re-probe in lockstep; a
  half-open probe grant expires after the current backoff interval. Each
  engine keeps one a device index
  (:mod:`stellar_tpu_torch.parallel.device_health`).
* :class:`Deadline` and :func:`call_with_deadline`: time budgets for
  calls whose failure is a hang, not an exception (a wait on a card
  that never finishes its stream).
* :class:`WatchdogPool`: the daemon workers behind
  :func:`call_with_deadline`. A guarded call is a queue hand-off to an
  idle worker; a worker parked in a hung call is simply missing from the
  idle set, and the next call gets a fresh one.
* :class:`Overloaded`: the typed admission verdict of the verify service
  and the trickle batcher, work refused at ingress or shed under load.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional

from stellar_tpu_torch.utils import tracing

__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker", "Deadline",
           "DeadlineExceeded", "Overloaded", "WatchdogPool",
           "call_with_deadline", "watchdog_stats"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class DeadlineExceeded(Exception):
    """A guarded call did not finish within its budget."""


class Overloaded(RuntimeError):
    """Typed admission-control verdict: the system chose to refuse or
    drop work rather than buffer it without bound. Two kinds:

    * ``kind="rejected"``: refused at ingress (queue depth or byte
      budget exceeded, or the service is stopping); the work never
      entered a queue;
    * ``kind="shed"``: admitted, then dropped by the deterministic
      load-shed ladder under overload; the caller learns it from this
      exception on its ticket, never by silence.

    ``lane`` names the priority lane (``"trickle"`` for the micro-batch
    window), ``reason`` the budget that tripped (``"queue-depth"``,
    ``"bytes"``, ``"tenant-depth"``, ``"tenant-bytes"``, ``"backlog"``,
    ...), ``tenant`` the submitting tenant when the verdict was
    tenant-scoped, ``replica`` the refusing service's fleet identity
    (None for a single service), and ``trace_ids`` the refused or shed
    items' trace IDs."""

    def __init__(self, message: str, *, kind: str = "rejected",
                 lane: Optional[str] = None, reason: str = "",
                 tenant: Optional[str] = None, trace_ids=None,
                 replica: Optional[int] = None):
        super().__init__(message)
        self.kind = kind
        self.lane = lane
        self.reason = reason
        self.tenant = tenant
        self.trace_ids = trace_ids if trace_ids is not None else ()
        self.replica = replica


class Deadline:
    """A monotonic time budget threaded through a multi-step operation,
    so each step races against what is left, not a fresh allowance."""

    def __init__(self, budget_s: float, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self.budget_s = float(budget_s)

    @classmethod
    def from_ms(cls, budget_ms: float, clock=time.monotonic) -> "Deadline":
        return cls(budget_ms / 1000.0, clock=clock)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"{what}: {self.budget_s:.3f}s budget exhausted")


class WatchdogPool:
    """Daemon workers for deadline-guarded calls.

    * A submitted job is picked up at once: ``submit`` starts a worker
      whenever the queue outnumbers the idle workers, so a guarded call
      never waits behind another caller's hang.
    * A worker whose job hangs is absent from the idle set; if the call
      ever returns, the worker rejoins the pool.
    * At most ``max_idle`` workers linger between bursts.

    Each job runs under the submitter's span context
    (:class:`stellar_tpu_torch.utils.tracing.span_context`), so a span
    opened in it links to the span that waits on it. All shared state
    changes under the pool's condition variable."""

    def __init__(self, name: str = "watchdog", max_idle: int = 4):
        self.name = name
        self._max_idle = max_idle
        self._cv = threading.Condition()
        self._jobs: deque = deque()
        self._idle = 0
        self._workers = 0
        self._spawned_total = 0

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._jobs:
                    if self._idle >= self._max_idle:
                        self._workers -= 1
                        return
                    self._idle += 1
                    while not self._jobs:
                        self._cv.wait()
                    self._idle -= 1
                job = self._jobs.popleft()
            try:
                with tracing.span_context(job["ctx"]):
                    job["box"]["out"] = job["fn"]()
            except BaseException as e:  # raised again on the caller
                job["box"]["err"] = e
            finally:
                job["done"].set()

    def submit(self, fn: Callable) -> dict:
        """Queue ``fn`` for a worker; returns the job (its ``done``
        event and ``box`` result slot). Never blocks."""
        job = {"fn": fn, "box": {}, "done": threading.Event(),
               "ctx": tracing.current_context()}
        with self._cv:
            self._jobs.append(job)
            if self._idle >= len(self._jobs):
                self._cv.notify()
            else:
                self._workers += 1
                self._spawned_total += 1
                threading.Thread(target=self._loop, daemon=True,
                                 name=f"{self.name}-worker").start()
        return job

    def stats(self) -> dict:
        with self._cv:
            return {"workers": self._workers, "idle": self._idle,
                    "queued": len(self._jobs),
                    "spawned_total": self._spawned_total}


# the process-wide pool behind call_with_deadline
_pool = WatchdogPool(name="resilience-watchdog")


def watchdog_stats() -> dict:
    """Worker, idle and spawn counts of the shared pool."""
    return _pool.stats()


def call_with_deadline(fn: Callable, budget_s: Optional[float],
                       name: str = "guarded-call"):
    """Run ``fn()`` on a pool worker; raise :class:`DeadlineExceeded` if
    it does not finish within ``budget_s`` (None: no guard, a direct
    call). A worker cannot be killed: on a timeout the job is abandoned
    and its worker stays parked in whatever hung, so the caller treats
    the resource as suspect (the breaker's job). An exception of ``fn``
    is raised again as it is."""
    if budget_s is None:
        return fn()
    if budget_s <= 0:
        raise DeadlineExceeded(f"{name}: no budget left")
    job = _pool.submit(fn)
    if not job["done"].wait(budget_s):
        raise DeadlineExceeded(f"{name} exceeded {budget_s:.3f}s budget")
    box = job["box"]
    if "err" in box:
        raise box["err"]
    return box.get("out")


class CircuitBreaker:
    """Thread-safe consecutive-failure circuit breaker.

    States: ``closed`` (healthy — every call allowed; failures counted),
    ``open`` (tripped — calls refused until the backoff window expires),
    ``half-open`` (window expired — ONE probe call allowed; its outcome
    decides: success re-closes, failure re-opens with doubled backoff).

    A half-open probe grant expires after the current backoff interval,
    so a probe that itself hangs and never reports can't wedge the
    breaker half-open forever.

    ``on_transition(old, new)`` fires OUTSIDE the internal lock (it may
    log or update metrics; it must not need the breaker's lock-step
    consistency).
    """

    def __init__(self, name: str = "breaker", failure_threshold: int = 3,
                 backoff_min_s: float = 1.0, backoff_max_s: float = 120.0,
                 backoff_factor: float = 2.0, jitter_frac: float = 0.1,
                 clock=time.monotonic, rng=random.random,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.name = name
        self._lock = threading.Lock()
        self._clock = clock
        self._rng = rng
        self._on_transition = on_transition
        self._state = CLOSED
        self._failures = 0
        self._opened_total = 0
        self._open_until = 0.0
        self._grant_expires = 0.0
        self.configure(failure_threshold=failure_threshold,
                       backoff_min_s=backoff_min_s,
                       backoff_max_s=backoff_max_s,
                       backoff_factor=backoff_factor,
                       jitter_frac=jitter_frac)

    def configure(self, failure_threshold: Optional[int] = None,
                  backoff_min_s: Optional[float] = None,
                  backoff_max_s: Optional[float] = None,
                  backoff_factor: Optional[float] = None,
                  jitter_frac: Optional[float] = None) -> None:
        """Update policy knobs in place (config push); None keeps the
        current value. Does not change the current state."""
        with self._lock:
            if failure_threshold is not None:
                self._threshold = max(1, int(failure_threshold))
            if backoff_min_s is not None:
                self._backoff_min = max(0.001, float(backoff_min_s))
            if backoff_max_s is not None:
                self._backoff_max = float(backoff_max_s)
            if backoff_factor is not None:
                self._factor = max(1.0, float(backoff_factor))
            if jitter_frac is not None:
                self._jitter = max(0.0, float(jitter_frac))
            self._backoff_max = max(self._backoff_max, self._backoff_min)
            cur = getattr(self, "_backoff_cur", None)
            self._backoff_cur = self._backoff_min if cur is None else \
                min(max(cur, self._backoff_min), self._backoff_max)

    # ---------------- state machine ----------------

    def _transition_locked(self, new: str) -> Optional[tuple]:
        old = self._state
        if old == new:
            return None
        self._state = new
        if new == OPEN:
            self._opened_total += 1
        return (old, new)

    def _fire(self, change: Optional[tuple]) -> None:
        if change is not None and self._on_transition is not None:
            try:
                self._on_transition(*change)
            except Exception:
                pass  # observability must never break the guarded path

    def allow(self) -> bool:
        """May a call proceed right now? In ``open``, flips to
        ``half-open`` once the backoff window has expired and grants
        exactly one probe per grant window."""
        change = None
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now < self._open_until:
                    return False
                change = self._transition_locked(HALF_OPEN)
                self._grant_expires = now + self._backoff_cur
                ok = True
            else:  # HALF_OPEN: one outstanding probe per grant window
                ok = now >= self._grant_expires
                if ok:
                    self._grant_expires = now + self._backoff_cur
        self._fire(change)
        return ok

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._backoff_cur = self._backoff_min
            change = self._transition_locked(CLOSED)
        self._fire(change)

    def record_failure(self) -> bool:
        """Returns True when THIS call transitioned the breaker to
        ``open`` (computed under the lock, so concurrent failure
        reports can't both claim the same onset — callers use it to
        count quarantine onsets exactly once)."""
        change = None
        with self._lock:
            self._failures += 1
            now = self._clock()
            if self._state == CLOSED:
                if self._failures >= self._threshold:
                    change = self._transition_locked(OPEN)
                    self._arm_locked(now)
            elif self._state == HALF_OPEN:
                # the probe failed: back off harder
                self._backoff_cur = min(self._backoff_cur * self._factor,
                                        self._backoff_max)
                change = self._transition_locked(OPEN)
                self._arm_locked(now)
            # already OPEN: a straggler failure report; don't extend
        self._fire(change)
        return change is not None and change[1] == OPEN

    def trip(self) -> None:
        """Force the breaker OPEN immediately, regardless of the
        failure streak — the hard-quarantine primitive. A
        result-INTEGRITY violation (a device returning wrong bits, not
        hanging) must not get ``threshold - 1`` more chances to decide
        signature validity; from half-open the backoff doubles exactly
        as a failed probe would."""
        with self._lock:
            now = self._clock()
            self._failures = max(self._failures, self._threshold)
            if self._state == HALF_OPEN:
                self._backoff_cur = min(self._backoff_cur * self._factor,
                                        self._backoff_max)
            change = self._transition_locked(OPEN)
            self._arm_locked(now)
        self._fire(change)

    def _arm_locked(self, now: float) -> None:
        jittered = self._backoff_cur * (1.0 + self._jitter * self._rng())
        self._open_until = now + jittered

    # ---------------- introspection ----------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def seconds_until_retry(self) -> float:
        """0 when calls are (or may be) allowed; else time left in the
        open backoff window."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._open_until - self._clock())

    def snapshot(self) -> dict:
        """Observability payload (info endpoint / metrics push)."""
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "failure_threshold": self._threshold,
                "backoff_s": round(self._backoff_cur, 3),
                "retry_in_s": round(
                    max(0.0, self._open_until - self._clock()), 3)
                if self._state == OPEN else 0.0,
                "opened_total": self._opened_total,
            }
