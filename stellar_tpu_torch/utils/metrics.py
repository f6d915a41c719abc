"""Metrics registry — the port's copy of the part of
``stellar_tpu/utils/metrics.py`` that its tracing, watchdog, pipeline
timeline and engine write: counters, gauges, meters and timers keyed by
dotted names, and the ``timer_totals`` snapshot that
:func:`stellar_tpu_torch.utils.tracing.span_totals` reads.

The names are the reference's: ``span.<name>`` (a span's inclusive
time), ``span.attr.<name>`` (a phase's time flushed by its blocking
root), ``crypto.verify.dispatch.deadline_miss``,
``crypto.verify.dispatch.short_circuit``, ``crypto.pipeline.*``.

Every read-modify-write holds the metric's lock: metrics are written
from watchdog workers, the probe thread and breaker callbacks at once.

Left out (ROADMAP.md): timer percentiles (the reservoir), the
Prometheus export, the time-series ring with its anomaly watcher, and
the SLO burn-window helpers.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

__all__ = ["Counter", "Meter", "Timer", "Gauge", "MetricsRegistry",
           "registry"]

# sliding window of a meter's rate, seconds (the reference's default)
WINDOW_SECONDS = 300.0


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def inc(self, n: int = 1):
        with self._lock:
            self.count += n

    def to_dict(self):
        return {"type": "counter", "count": self.count}


class Meter:
    """Event count and its rate over the last ``WINDOW_SECONDS``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._events: List[float] = []

    def mark(self, n: int = 1):
        now = time.monotonic()
        cutoff = now - WINDOW_SECONDS
        with self._lock:
            self.count += n
            self._events.append(now)
            while self._events and self._events[0] < cutoff:
                self._events.pop(0)

    def windowed_rate(self) -> float:
        return len(self._events) / WINDOW_SECONDS

    def to_dict(self):
        return {"type": "meter", "count": self.count,
                "window_s": WINDOW_SECONDS,
                "rate": round(self.windowed_rate(), 4)}


class Timer:
    """Durations in ms: count, sum, min, max."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._sum = 0.0
        self.min_ms = math.inf
        self.max_ms = 0.0

    def update_ms(self, ms: float):
        with self._lock:
            self.count += 1
            self._sum += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)

    def record_total(self, count: int, sum_ms: float):
        """Fold an aggregated (count, sum) pair into the totals — the
        flush of tracing's root-attributed phase collectors
        (``span.attr.*``); min and max take the batch mean."""
        n = int(count)
        if n <= 0:
            return
        mean = sum_ms / n
        with self._lock:
            self.count += n
            self._sum += sum_ms
            self.min_ms = min(self.min_ms, mean)
            self.max_ms = max(self.max_ms, mean)

    def sum_ms(self) -> float:
        with self._lock:
            return self._sum

    def to_dict(self):
        with self._lock:
            count, s, mn, mx = self.count, self._sum, self.min_ms, \
                self.max_ms
        return {"type": "timer", "count": count,
                "min_ms": 0.0 if math.isinf(mn) else round(mn, 3),
                "mean_ms": round(s / count if count else 0.0, 3),
                "max_ms": round(mx, 3),
                "sum_ms": round(s, 3)}


class Gauge:
    """The last value written (a number or a label such as a breaker
    state)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def set(self, value):
        with self._lock:
            self.value = value

    def to_dict(self):
        return {"type": "gauge", "value": self.value}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def to_dict(self) -> dict:
        return self.find("")

    def find(self, prefix: str) -> dict:
        """Rendered snapshot of every metric whose name starts with
        ``prefix``."""
        with self._lock:
            items = sorted((name, m) for name, m in self._metrics.items()
                           if name.startswith(prefix))
        return {name: m.to_dict() for name, m in items}

    def timer_totals(self) -> Dict[str, dict]:
        """``{name: {"count", "sum_ms"}}`` for every timer."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: {"count": m.count, "sum_ms": m.sum_ms()}
                for name, m in items if isinstance(m, Timer)}


# the process-wide registry
registry = MetricsRegistry()
