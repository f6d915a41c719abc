"""Circuit breaker for the port's dispatch fault domains — the port's
copy of ``stellar_tpu/utils/resilience.py``'s :class:`CircuitBreaker`.

closed -> open on a consecutive-failure threshold -> half-open re-probe
after an exponential backoff window, with jitter so a fleet of nodes does
not re-probe in lockstep; a half-open probe grant expires after the
current backoff interval. Each engine keeps one a device index
(:mod:`stellar_tpu_torch.parallel.device_health`).

Not in this slice: the reference's ``Deadline``, ``WatchdogPool`` and
``call_with_deadline`` (the deadline-guarded resolve; ROADMAP.md).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


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
