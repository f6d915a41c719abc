"""Per-device fault domains for the engine's multi-device path — the
port's copy of ``stellar_tpu/parallel/device_health.py``.

One :class:`~stellar_tpu_torch.utils.resilience.CircuitBreaker` per
device index of an engine's device list, so a launch, copy or fetch
failure attributable to device ``i`` opens only device ``i``'s breaker
and the batch re-shards over the survivors. Each engine owns its
registry (``BatchEngine.health``): an index means a position in that
engine's list, and two engines over different lists share no breaker.

Lifecycle of one device:

* **healthy** (breaker closed): in the dispatch rotation;
* **quarantined** (open): excluded from sub-chunk assignment; its share
  of the batch rides the surviving devices, at the same sub-chunk shape;
* **probation** (half-open): after the backoff window ONE sub-chunk of
  real traffic is routed back to it; success re-closes, failure re-opens
  with doubled backoff.

:meth:`DeviceHealth.quarantine` is the hard open the result-integrity
audit uses: a device caught returning wrong bits gets no further chances.

Every transition is kept in a bounded history ring (``seq``-ordered)
and mirrored, as in the reference, into the process registry
(:mod:`stellar_tpu_torch.utils.metrics`): ``crypto.verify.device.<i>.
failures``, ``.quarantines``, ``.audit.ok`` / ``.audit.mismatch``, the
gauge ``.breaker.state`` and ``crypto.verify.device.breaker.transitions``.
The names carry the device index, so engines over different lists add
into the same counters; each engine's own ``health`` keeps them apart.
The engine dumps the flight recorder on a quarantine onset and an audit
conviction (``stellar_tpu_torch.parallel.batch_engine``).

Determinism: this module reads no clock and no RNG itself; the breakers
it owns carry their own monotonic clocks for backoff pacing, which
affects only latency, never a verdict.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from stellar_tpu_torch.utils import resilience
from stellar_tpu_torch.utils.metrics import registry as _metrics

__all__ = ["DeviceHealth", "DEFAULT_FAILURE_THRESHOLD",
           "DEFAULT_BACKOFF_MIN_S", "DEFAULT_BACKOFF_MAX_S"]

# The reference's per-device defaults: a low threshold, since benching
# one device of n costs 1/n of throughput.
DEFAULT_FAILURE_THRESHOLD = 2
DEFAULT_BACKOFF_MIN_S = 1.0
DEFAULT_BACKOFF_MAX_S = 300.0

HISTORY_LIMIT = 256


class DeviceHealth:
    """Registry of one circuit breaker per device index."""

    def __init__(self,
                 failure_threshold: Optional[int] = None,
                 backoff_min_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 history_limit: int = HISTORY_LIMIT):
        self._lock = threading.Lock()
        self._breakers: Dict[int, resilience.CircuitBreaker] = {}
        self._history: deque = deque(maxlen=history_limit)
        self._seq = 0
        # per-device audit-verdict tallies (key "-1" = single-device
        # dispatch)
        self._audits: Dict[str, Dict[str, int]] = {}
        self._threshold = int(failure_threshold
                              if failure_threshold is not None
                              else DEFAULT_FAILURE_THRESHOLD)
        self._backoff_min = float(backoff_min_s
                                  if backoff_min_s is not None
                                  else DEFAULT_BACKOFF_MIN_S)
        self._backoff_max = float(backoff_max_s
                                  if backoff_max_s is not None
                                  else DEFAULT_BACKOFF_MAX_S)

    # ---------------- breaker access ----------------

    def breaker(self, idx: int) -> resilience.CircuitBreaker:
        """Get-or-create the breaker for device ``idx``."""
        with self._lock:
            br = self._breakers.get(idx)
            if br is None:
                br = resilience.CircuitBreaker(
                    name=f"verify-device-{idx}",
                    failure_threshold=self._threshold,
                    backoff_min_s=self._backoff_min,
                    backoff_max_s=self._backoff_max,
                    on_transition=lambda old, new, i=idx:
                        self._note_transition(i, old, new))
                self._breakers[idx] = br
            return br

    def configure(self,
                  failure_threshold: Optional[int] = None,
                  backoff_min_s: Optional[float] = None,
                  backoff_max_s: Optional[float] = None) -> None:
        """Policy push; None keeps the current value. Applies to existing
        breakers and future ones."""
        with self._lock:
            if failure_threshold is not None:
                self._threshold = max(1, int(failure_threshold))
            if backoff_min_s is not None:
                self._backoff_min = float(backoff_min_s)
            if backoff_max_s is not None:
                self._backoff_max = float(backoff_max_s)
            breakers = list(self._breakers.values())
        for br in breakers:
            br.configure(failure_threshold=failure_threshold,
                         backoff_min_s=backoff_min_s,
                         backoff_max_s=backoff_max_s)

    # ---------------- accounting ----------------

    def record_failure(self, idx: int) -> bool:
        """Account one failure to device ``idx``. Returns True when THIS
        failure opened the device's breaker (quarantine onset)."""
        _metrics.counter(f"crypto.verify.device.{idx}.failures").inc()
        return self.breaker(idx).record_failure()

    def record_success(self, idx: int) -> None:
        self.breaker(idx).record_success()

    def quarantine(self, idx: int, reason: str = "integrity") -> None:
        """Hard quarantine: force the breaker open at once (an audit
        mismatch: wrong bits, not a failure streak)."""
        self._note_event(idx, "quarantine", reason)
        _metrics.counter(f"crypto.verify.device.{idx}.quarantines").inc()
        self.breaker(idx).trip()

    def note_audit(self, idx: Optional[int], ok: bool,
                   sampled: int) -> None:
        """Record one audit verdict against device ``idx`` (None = a
        single-device dispatch): ok/mismatch tallies in the snapshot, a
        history event on a mismatch."""
        key = "-1" if idx is None else str(int(idx))
        with self._lock:
            tally = self._audits.setdefault(key, {"ok": 0, "mismatch": 0})
            tally["ok" if ok else "mismatch"] += 1
        if not ok:
            self._note_event(-1 if idx is None else idx,
                             "audit-mismatch", f"sampled={sampled}")
        _metrics.counter(f"crypto.verify.device.{key}.audit."
                         + ("ok" if ok else "mismatch")).inc()

    def assign_parts(self, n_devices: int, n_parts: int,
                     exclude=()) -> List[Optional[int]]:
        """Serving device per sub-chunk (None = no device), the degraded
        re-shard assignment:

        * closed (healthy) devices share the parts round-robin;
        * a non-closed device is consulted (``allow()``, which consumes
          its one half-open grant) only when it will receive a part, and
          then receives exactly one: probation traffic is the re-probe;
        * with no healthy device and no grant, a part gets None;
        * an index in ``exclude`` (a device the audit convicted) gets no
          part and no grant.
        """
        closed = [i for i in range(n_devices) if i not in exclude and
                  self.breaker(i).state == resilience.CLOSED]
        probation: List[int] = []
        for i in range(n_devices):
            if i in closed or i in exclude:
                continue
            if len(probation) >= n_parts:
                break  # later devices keep their grants for next time
            if self.breaker(i).allow():
                probation.append(i)
        out: List[Optional[int]] = []
        ci = 0
        for j in range(n_parts):
            if j < len(probation):
                out.append(probation[j])
            elif closed:
                out.append(closed[ci % len(closed)])
                ci += 1
            else:
                out.append(None)
        return out

    def quarantined(self, n: int) -> List[int]:
        """Open device indices among ``0..n-1`` (consumes no half-open
        grant)."""
        with self._lock:
            items = list(self._breakers.items())
        return sorted(i for i, br in items
                      if i < n and br.state == resilience.OPEN)

    # ---------------- history / observability ----------------

    def _note_transition(self, idx: int, old: str, new: str) -> None:
        with self._lock:
            self._seq += 1
            self._history.append({"seq": self._seq, "device": idx,
                                  "from": old, "to": new})
        _metrics.gauge(f"crypto.verify.device.{idx}.breaker.state").set(new)
        _metrics.counter("crypto.verify.device.breaker.transitions").inc()

    def _note_event(self, idx: int, event: str, reason: str) -> None:
        with self._lock:
            self._seq += 1
            self._history.append({"seq": self._seq, "device": idx,
                                  "event": event, "reason": reason})

    def history(self, limit: Optional[int] = None) -> List[dict]:
        """Transition and event records, oldest first (bounded ring)."""
        with self._lock:
            out = list(self._history)
        return out if limit is None else out[-limit:]

    def snapshot(self) -> dict:
        """Breaker states, quarantined indices and audit tallies."""
        with self._lock:
            items = sorted(self._breakers.items())
            seq = self._seq
            audits = {k: dict(v) for k, v in self._audits.items()}
        return {
            "devices": {str(i): br.snapshot() for i, br in items},
            "quarantined": [i for i, br in items
                            if br.state == resilience.OPEN],
            "transitions_total": seq,
            "audits": audits,
        }
