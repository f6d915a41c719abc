"""Metrics registry — the port's copy of the part of
``stellar_tpu/utils/metrics.py`` that its tracing, watchdog, pipeline
timeline and engine write: counters, gauges, meters and timers keyed by
dotted names, and the ``timer_totals`` snapshot that
:func:`stellar_tpu_torch.utils.tracing.span_totals` reads.

The names are the reference's: ``span.<name>`` (a span's inclusive
time), ``span.attr.<name>`` (a phase's time flushed by its blocking
root), ``crypto.verify.dispatch.deadline_miss``,
``crypto.verify.dispatch.short_circuit``, ``crypto.pipeline.*``,
``crypto.transfer.*``, ``crypto.resident.*``.

Timers are histograms: beside count, sum, min, max and stddev they keep
a reservoir sample (``RESERVOIR_SIZE``, replaced with probability k/n by
a seeded per-timer RNG), from which ``to_dict`` and
:meth:`MetricsRegistry.to_prometheus` give p50, p90 and p99.
``to_prometheus`` is the reference's text exposition, line for line.

Every read-modify-write holds the metric's lock: metrics are written
from watchdog workers, the probe thread and breaker callbacks at once.

The SLO burn-window helpers (:func:`fresh_burn_window`,
:func:`trim_burn_window`, :func:`push_burn_window`) hold the event-count
sliding window that the verify service's lane monitor and the tenant
monitor share.

Left out (ROADMAP.md, queue 1): the time-series ring with its anomaly
watcher, which serves the fleet and the ingress; ``Meter.one_minute_rate``,
the reference's older name of ``windowed_rate``.
"""

from __future__ import annotations

import math
import random
import re
import threading
import time
from collections import deque
from typing import Dict, List

__all__ = ["Counter", "Meter", "Timer", "Gauge", "MetricsRegistry",
           "registry", "RESERVOIR_SIZE", "fresh_burn_window",
           "push_burn_window", "trim_burn_window"]

# sliding window of a meter's rate, seconds (the reference's default)
WINDOW_SECONDS = 300.0

# reservoir sample size of a timer's percentiles; read at update time,
# so a change before traffic starts sizes every timer
RESERVOIR_SIZE = 512


# ---------------- SLO burn-window helpers ----------------
# One implementation of the event-count sliding window of an error
# budget (a deque of 0/1 and running bad/total counters), shared by the
# verify service's per-lane SloMonitor and the per-tenant
# TenantSloMonitor. Pure functions of the dict: the owning monitor holds
# its lock around every call.


def fresh_burn_window() -> dict:
    return {"events": deque(), "bad": 0, "total": 0, "bad_total": 0}


def trim_burn_window(st: dict, window: int) -> None:
    while len(st["events"]) > window:
        st["bad"] -= st["events"].popleft()


def push_burn_window(st: dict, bad: bool, n: int, window: int) -> None:
    flag = 1 if bad else 0
    for _ in range(n):
        st["events"].append(flag)
    st["bad"] += flag * n
    st["total"] += n
    st["bad_total"] += flag * n
    trim_burn_window(st, window)


def _interp_percentile(data: List[float], q: float) -> float:
    """Linear-interpolated percentile of an already sorted sample; 0.0
    when it is empty."""
    if not data:
        return 0.0
    k = (len(data) - 1) * (q / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return data[int(k)]
    return data[f] + (data[c] - data[f]) * (k - f)


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
    """Durations in ms: count, sum, min, max, stddev, and a reservoir
    sample for p50, p90 and p99. The reservoir replaces an entry with
    probability k/n, drawn from a per-timer RNG seeded as the
    reference's, so two timers fed the same sequence hold the same
    sample and the process RNG is never touched."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._sum = 0.0
        self._sum2 = 0.0
        self.min_ms = math.inf
        self.max_ms = 0.0
        self._reservoir: List[float] = []
        self._rng = random.Random(0x5EED)

    def _sample_locked(self, ms: float, size: int) -> None:
        # a shrunken RESERVOIR_SIZE truncates, so no stale tail stays in
        # the percentiles
        if len(self._reservoir) > size:
            del self._reservoir[size:]
        if len(self._reservoir) < size:
            self._reservoir.append(ms)
        else:
            j = self._rng.randrange(self.count)
            if j < size:
                self._reservoir[j] = ms

    def update_ms(self, ms: float):
        size = max(1, int(RESERVOIR_SIZE))
        with self._lock:
            self.count += 1
            self._sum += ms
            self._sum2 += ms * ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)
            self._sample_locked(ms, size)

    def record_total(self, count: int, sum_ms: float):
        """Fold an aggregated (count, sum) pair into the totals — the
        flush of tracing's root-attributed phase collectors
        (``span.attr.*``); min, max and the reservoir take the batch mean
        once a flush (an aggregate has no per-event percentiles)."""
        n = int(count)
        if n <= 0:
            return
        mean = sum_ms / n
        size = max(1, int(RESERVOIR_SIZE))
        with self._lock:
            self.count += n
            self._sum += sum_ms
            self._sum2 += mean * mean * n
            self.min_ms = min(self.min_ms, mean)
            self.max_ms = max(self.max_ms, mean)
            self._sample_locked(mean, size)

    def mean_ms(self) -> float:
        return self._sum / self.count if self.count else 0.0

    def stddev_ms(self) -> float:
        if self.count < 2:
            return 0.0
        m = self.mean_ms()
        return math.sqrt(max(0.0, self._sum2 / self.count - m * m))

    def sum_ms(self) -> float:
        with self._lock:
            return self._sum

    def percentiles_ms(self, qs) -> List[float]:
        """Linear-interpolated percentiles (each q in [0, 100]) from one
        locked, sorted snapshot of the reservoir."""
        with self._lock:
            data = sorted(self._reservoir)
        return [_interp_percentile(data, q) for q in qs]

    def percentile_ms(self, q: float) -> float:
        return self.percentiles_ms((q,))[0]

    def to_dict(self):
        # one locked snapshot: no count and sum torn by an update
        with self._lock:
            count, s, s2, mn, mx = self.count, self._sum, self._sum2, \
                self.min_ms, self.max_ms
            data = sorted(self._reservoir)
        mean = s / count if count else 0.0
        var = max(0.0, s2 / count - mean * mean) if count >= 2 else 0.0
        p50, p90, p99 = (_interp_percentile(data, q) for q in (50, 90, 99))
        return {"type": "timer", "count": count,
                "min_ms": 0.0 if math.isinf(mn) else round(mn, 3),
                "mean_ms": round(mean, 3),
                "max_ms": round(mx, 3),
                "stddev_ms": round(math.sqrt(var), 3),
                "sum_ms": round(s, 3),
                "p50_ms": round(p50, 3),
                "p90_ms": round(p90, 3),
                "p99_ms": round(p99, 3)}


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


# Prometheus names may only be [a-zA-Z_:][a-zA-Z0-9_:]*: a dotted name's
# dots (and any other byte) become underscores
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_label_escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


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

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the whole
        registry, the reference's line for line: counters as counters,
        meters as a ``_total`` counter and a ``_rate`` gauge, timers as
        summaries (quantile samples, ``_sum``, ``_count``), gauges as
        gauges (a value that is not a number becomes a ``value``
        label)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            base = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {base} counter")
                lines.append(f"{base} {m.count}")
            elif isinstance(m, Meter):
                lines.append(f"# TYPE {base}_total counter")
                lines.append(f"{base}_total {m.count}")
                lines.append(f"# TYPE {base}_rate gauge")
                lines.append(f"{base}_rate {m.windowed_rate():.6f}")
            elif isinstance(m, Timer):
                lines.append(f"# TYPE {base}_ms summary")
                for q, v in zip((50, 90, 99),
                                m.percentiles_ms((50, 90, 99))):
                    lines.append(
                        f'{base}_ms{{quantile="{q / 100}"}} {v:.6f}')
                lines.append(f"{base}_ms_sum {m.sum_ms():.6f}")
                lines.append(f"{base}_ms_count {m.count}")
            elif isinstance(m, Gauge):
                v = m.value
                lines.append(f"# TYPE {base} gauge")
                if isinstance(v, bool):
                    lines.append(f"{base} {int(v)}")
                elif isinstance(v, (int, float)) and not (
                        isinstance(v, float) and math.isnan(v)):
                    lines.append(f"{base} {v}")
                elif v is None:
                    lines.append(f'{base}{{value="none"}} 1')
                else:
                    lines.append(
                        f'{base}{{value="{_prom_label_escape(str(v))}"'
                        f"}} 1")
        return "\n".join(lines) + "\n"


# the process-wide registry
registry = MetricsRegistry()
