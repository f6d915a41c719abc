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

:class:`TimeSeriesRing` (the module's ``timeseries``) keeps a bounded
history of every ``crypto.`` metric at a fixed interval, with an EWMA
z-score watcher that counts a sustained excursion and dumps the flight
recorder.
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
           "registry", "RESERVOIR_SIZE", "TimeSeriesRing", "timeseries",
           "fresh_burn_window", "push_burn_window", "trim_burn_window"]

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

    def dec(self, n: int = 1):
        with self._lock:
            self.count -= n

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

    # the reference's older name of the windowed rate
    one_minute_rate = windowed_rate

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

    def time(self):
        """``with timer.time(): ...`` adds the block's duration."""
        t0 = time.perf_counter()
        timer = self

        class _Ctx:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                timer.update_ms((time.perf_counter() - t0) * 1000.0)
                return False
        return _Ctx()

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

    def clear(self):
        with self._lock:
            self._metrics.clear()


# the process-wide registry
registry = MetricsRegistry()


# ---------------- in-process time-series ring ----------------
# Counters and exports answer "how much so far" and "what now"; the ring
# keeps a bounded fixed-interval history per metric, so a live node can
# show a lane's p99 trajectory, and an EWMA z-score watcher catches a
# sustained excursion while it happens (dumping the flight recorder, so
# the spans leading into it survive).

# the reference's defaults; set through TimeSeriesRing.configure()
TIMESERIES_SAMPLES = 512
TIMESERIES_INTERVAL_S = 1.0
ANOMALY_Z = 6.0          # |z| threshold per sample
ANOMALY_SUSTAIN = 3      # consecutive excursions before firing
ANOMALY_MIN_SAMPLES = 32  # EWMA warm-up before any alerting
_EWMA_ALPHA = 0.1
# hard cap on tracked series: per-lane meters can mint names, and the
# ring stays bounded whatever happens; overflow is counted
# (``dropped_series`` in the snapshot), never silent. A ring may set its
# own cap (TimeSeriesRing.configure(max_series=...)); the tenant layer
# publishes its burn rates under rank-keyed names
# (crypto.verify.tenant.topk.<rank>.*) so tenant churn never races it
MAX_SERIES = 1024

# series timestamps: monotonic seconds since module import (no wall
# clock — same policy as the tracing epoch)
_TS_EPOCH = time.monotonic()


class TimeSeriesRing:
    """Bounded per-metric history of fixed-interval snapshots, plus
    the EWMA z-score anomaly watcher.

    What each metric type contributes per tick:

    * counters / meters — the per-interval DELTA (a cumulative count's
      z-score is meaningless; its rate's is exactly what an anomaly
      watcher wants);
    * gauges — the numeric value (non-numeric gauges are skipped);
    * timers — ``p50`` / ``p99`` from the reservoir plus the count
      delta.

    Every mutation and every read snapshot happens under the instance
    lock (one tick appends to all series atomically), so a reader
    sampling concurrently with a resolving engine can never see a torn
    window — and a window that simply has not filled yet is MARKED
    (``partial: true``), never silently averaged."""

    def __init__(self, reg: MetricsRegistry,
                 prefixes=("crypto.",)):
        self._registry = reg
        self._prefixes = tuple(prefixes)
        self._lock = threading.Lock()
        self._series: Dict[str, List] = {}   # name -> [(t_s, value)]
        self._last_raw: Dict[str, float] = {}
        self._anom: Dict[str, dict] = {}
        self._anomalies: List[dict] = []
        self._samples = TIMESERIES_SAMPLES
        self._z = ANOMALY_Z
        self._sustain = ANOMALY_SUSTAIN
        self._min_samples = ANOMALY_MIN_SAMPLES
        self._interval_s = TIMESERIES_INTERVAL_S
        self._ticks = 0
        self._dropped_series = 0
        # None = follow the module-level MAX_SERIES default
        self._max_series = None
        self._thread = None
        self._stop_evt = threading.Event()

    def configure(self, samples=None, interval_s=None, z=None,
                  sustain=None, min_samples=None,
                  max_series=None) -> None:
        """Set the ring's knobs (the reference's METRICS_TIMESERIES_* and
        METRICS_ANOMALY_* options); None keeps the current value.
        ``max_series`` overrides the module-level hard cap for this ring
        (never below 8: the cap is a guard, not an off switch)."""
        with self._lock:
            if samples is not None:
                self._samples = max(8, int(samples))
                for buf in self._series.values():
                    if len(buf) > self._samples:
                        del buf[:len(buf) - self._samples]
            if interval_s is not None:
                self._interval_s = max(0.01, float(interval_s))
            if z is not None:
                self._z = max(1.0, float(z))
            if sustain is not None:
                self._sustain = max(1, int(sustain))
            if min_samples is not None:
                self._min_samples = max(2, int(min_samples))
            if max_series is not None:
                self._max_series = max(8, int(max_series))

    # ---------------- sampling ----------------

    def sample_once(self) -> int:
        """One snapshot tick over every matching metric; returns the
        number of series updated. Called directly or by :meth:`start`'s
        daemon thread."""
        t = time.monotonic() - _TS_EPOCH
        with self._registry._lock:
            items = [(n, m) for n, m in self._registry._metrics.items()
                     if n.startswith(self._prefixes)]
        # render OUTSIDE the registry lock (per-metric locks suffice)
        points: List[tuple] = []   # (series, raw, is_cumulative)
        for name, m in items:
            if isinstance(m, (Counter, Meter)):
                points.append((name + ".count", float(m.count), True))
            elif isinstance(m, Gauge):
                v = m.value
                if isinstance(v, bool):
                    points.append((name, float(v), False))
                elif isinstance(v, (int, float)) and not (
                        isinstance(v, float) and math.isnan(v)):
                    points.append((name, float(v), False))
            elif isinstance(m, Timer):
                p50, p99 = m.percentiles_ms((50, 99))
                points.append((name + ".p50_ms", p50, False))
                points.append((name + ".p99_ms", p99, False))
                points.append((name + ".count", float(m.count), True))
        fired: List[dict] = []
        updated = 0
        with self._lock:
            self._ticks += 1
            for series, raw, cumulative in points:
                if cumulative:
                    prev = self._last_raw.get(series)
                    self._last_raw[series] = raw
                    value = raw - prev if prev is not None else 0.0
                else:
                    value = raw
                buf = self._series.get(series)
                if buf is None:
                    cap = self._max_series if self._max_series \
                        is not None else MAX_SERIES
                    if len(self._series) >= cap:
                        self._dropped_series += 1
                        continue
                    buf = self._series[series] = []
                buf.append((round(t, 3), round(value, 6)))
                if len(buf) > self._samples:
                    del buf[:len(buf) - self._samples]
                updated += 1
                a = self._check_anomaly_locked(series, value, t)
                if a is not None:
                    fired.append(a)
        for a in fired:
            self._fire_anomaly(a)
        return updated

    def _check_anomaly_locked(self, series: str, value: float,
                              t: float):
        """EWMA mean/variance z-score per series; returns an anomaly
        record when a deviation has SUSTAINED (>= sustain consecutive
        excursions past the z threshold, after warm-up), exactly once
        per excursion (re-arms when the series normalizes)."""
        st = self._anom.get(series)
        if st is None:
            st = self._anom[series] = {
                "mu": value, "var": 0.0, "n": 1, "streak": 0,
                "alerting": False}
            return None
        st["n"] += 1
        sd = math.sqrt(st["var"])
        z = None
        if st["n"] > self._min_samples:
            if sd > 0:
                z = (value - st["mu"]) / sd
            elif value != st["mu"]:
                # a jump off a perfectly constant baseline: variance 0
                # would leave z undefined exactly when the deviation
                # is most obvious — capped, not infinite (JSON-safe)
                z = 1e9 if value > st["mu"] else -1e9
        out = None
        excursion = z is not None and abs(z) > self._z
        if excursion:
            st["streak"] += 1
            if st["streak"] >= self._sustain and not st["alerting"]:
                st["alerting"] = True
                out = {"series": series, "t_s": round(t, 3),
                       "value": value, "mu": round(st["mu"], 6),
                       "z": round(z, 2)}
                self._anomalies.append(out)
                del self._anomalies[:-32]
        else:
            st["streak"] = 0
            st["alerting"] = False
        # EWMA update AFTER the test (the sample being judged must not
        # have already dragged the baseline toward itself), and
        # excursion samples fold in at 1/10 weight: full weight would
        # let the first outlier inflate the variance enough to mask
        # the rest of a sustained excursion, while zero weight would
        # freeze the baseline and alert on a true level shift forever
        alpha = _EWMA_ALPHA * (0.1 if excursion else 1.0)
        d = value - st["mu"]
        st["mu"] += alpha * d
        st["var"] = (1 - alpha) * (st["var"] + alpha * d * d)
        return out

    def _fire_anomaly(self, rec: dict) -> None:
        """A sustained deviation: count it and dump the flight
        recorder so the spans/events leading into the excursion
        survive to be read (same policy as breaker trips and shed
        onsets). The tracing import is lazy — tracing imports this
        module at load time, and the sampler only ever runs long after
        both are imported."""
        registry.counter("metrics.timeseries.anomalies").inc()
        try:
            from stellar_tpu_torch.utils import tracing
            tracing.flight_recorder.dump(
                f"timeseries-anomaly:{rec['series']}")
        except ImportError:  # pragma: no cover — import-order edge
            pass

    # ---------------- sampler thread ----------------

    def start(self, interval_s=None) -> "TimeSeriesRing":
        """Spawn the fixed-interval sampler daemon (idempotent)."""
        with self._lock:
            if interval_s is not None:
                self._interval_s = max(0.01, float(interval_s))
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, args=(self._stop_evt,),
                daemon=True, name="metrics-timeseries")
        self._thread.start()
        return self

    def _run(self, stop_evt) -> None:
        while not stop_evt.wait(self._interval_s):
            self.sample_once()

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
            evt = self._stop_evt
        evt.set()
        if t is not None:
            t.join(timeout=5.0)

    # ---------------- introspection ----------------

    def snapshot(self, series=None, limit: int = 0) -> dict:
        """The reference's ``timeseries`` admin payload. ``series`` filters
        by name prefix; ``limit`` bounds samples per series (0 = all
        retained). Partial windows are marked, never hidden. A sample is
        the ring's own ``(t_s, value)`` tuple, which nothing mutates: the
        lists are copies, the samples are shared (the same JSON as the
        reference's ``[t_s, value]`` lists, without a list built a
        sample under the lock)."""
        limit = max(0, int(limit))
        with self._lock:
            names = sorted(n for n in self._series
                           if series is None or n.startswith(series))
            out_series = {}
            for n in names:
                buf = self._series[n]
                pts = buf[-limit:] if limit else list(buf)
                out_series[n] = {
                    "n": len(buf),
                    "window": self._samples,
                    "partial": len(buf) < self._samples,
                    "samples": pts,
                }
            running = self._thread is not None and \
                self._thread.is_alive()
            return {
                "series": out_series,
                "anomalies": [dict(a) for a in self._anomalies],
                "sampling": {"running": running,
                             "interval_s": self._interval_s,
                             "ticks": self._ticks,
                             "window": self._samples,
                             "tracked_series": len(self._series),
                             "max_series": self._max_series
                             if self._max_series is not None
                             else MAX_SERIES,
                             "dropped_series": self._dropped_series,
                             "z": self._z,
                             "sustain": self._sustain,
                             "min_samples": self._min_samples},
            }

    def _reset_for_testing(self) -> None:
        self.stop()
        with self._lock:
            self._series.clear()
            self._last_raw.clear()
            self._anom.clear()
            self._anomalies = []
            self._ticks = 0
            self._dropped_series = 0


# the process-wide ring over the process-wide registry (its sampler runs
# only once started; sample_once ticks it by hand)
timeseries = TimeSeriesRing(registry)
