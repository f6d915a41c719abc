"""Pipeline timeline: each resolve's per-device busy and idle time — the
port's copy of ``stellar_tpu/utils/timeline.py``'s ``PipelineTimeline``.

The engine (:mod:`stellar_tpu_torch.parallel.batch_engine`) stamps
every committed launch (:meth:`PipelineTimeline.note_dispatch`), the one
point where it accepts a part's result or gives the part up
(:meth:`PipelineTimeline.note_delivery`), and its host work (encode and
padding, the wait for a result, the audit) as intervals
(:meth:`PipelineTimeline.host_phase`). Each resolve yields a record:

* per-device **busy intervals**, ``[launch, delivery]``: the window the
  host has work in flight on that device. This is occupancy as the
  HOST sees it (it includes time queued on the card), not a profiler
  trace of the card;
* **bubbles**, the idle gaps of each device inside the resolve, each
  classed by what the host was doing: ``prep`` (encoding, padding),
  ``fetch`` (waiting on another device's result), ``audit``,
  ``host_fallback`` (never written by the port, which has no host
  failover; kept so a record has the reference's keys), ``queue_wait``
  (unattributed time before the device's first launch, as an injected
  stall makes) and ``gap`` (unattributed time after it);
* ``busy_frac`` = busy / (devices x wall), ``overlap_frac`` = prep time
  concurrent with in-flight work / prep time, and ``reconciliation``
  (busy plus classed bubbles over devices x wall, about 1.0 when every
  hook fired);
* ``transfer``: the resolve's transfer-ledger record
  (:mod:`stellar_tpu_torch.utils.transfer_ledger`), its round trips and
  bytes each way, so one record carries bytes and occupancy.

Records land in a bounded ring and in running totals, and set the
``crypto.pipeline.*`` metrics. The engine ends a resolve's token with
:meth:`PipelineTimeline.close`, which stamps the end and queues the
token: its record is built the next time records or totals are read, so
a resolve pays a stamp and a lock, not the record's build (which would
otherwise be the largest piece of a blocking call that no phase span
covers). :meth:`PipelineTimeline.finish`, the reference's call, builds
at once and returns the record. Stamps are the span clock
(:func:`stellar_tpu_torch.utils.tracing._now_ms`). All state changes
under the instance lock.

:meth:`PipelineTimeline.chrome_counter_events` renders the ring as Chrome
counter tracks (a device's work in flight, ``busy_frac``, cumulative
transfer bytes), merged into
:meth:`stellar_tpu_torch.utils.tracing.FlightRecorder.to_chrome_trace`.

:meth:`PipelineTimeline.configure` sizes the ring.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from stellar_tpu_torch.utils import tracing
from stellar_tpu_torch.utils.metrics import registry

__all__ = ["PipelineTimeline", "ResolveTimeline", "pipeline_timeline",
           "BUBBLE_CLASSES", "HOST_KINDS"]

_NS = "crypto.pipeline"

# records kept in the ring
DEFAULT_RESOLVES = 256

# host work-interval kinds the engine records, in gap-attribution
# priority order: a gap overlapping a prep interval is a prep bubble
# before anything else (the host was demonstrably busy encoding)
HOST_KINDS = ("prep", "fetch", "audit", "host_fallback")
# every bubble class a record reports (zero-ms classes included, so a
# consumer never key-errors on a clean resolve)
BUBBLE_CLASSES = ("queue_wait", "prep", "fetch", "audit",
                  "host_fallback", "gap")

# per-device busy intervals kept in one record; beyond the cap only the
# aggregate survives, and the record says so (`intervals_capped`)
MAX_INTERVALS_PER_DEVICE = 64


def _merge(intervals: List[List[float]]) -> List[List[float]]:
    """Union of possibly-overlapping [t0, t1] intervals (a survivor
    device serving several re-sharded sub-chunks has overlapping
    in-flight windows)."""
    out: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _overlap_ms(seg0: float, seg1: float,
                intervals: List[List[float]]) -> float:
    """Total overlap of [seg0, seg1] with a sorted interval list."""
    total = 0.0
    for t0, t1 in intervals:
        lo = max(seg0, t0)
        hi = min(seg1, t1)
        if hi > lo:
            total += hi - lo
    return total


def _subtract(segments: List[List[float]],
              intervals: List[List[float]]) -> List[List[float]]:
    """Remove ``intervals`` from ``segments`` (both sorted, merged)."""
    out: List[List[float]] = []
    for s0, s1 in segments:
        cur = s0
        for t0, t1 in intervals:
            if t1 <= cur or t0 >= s1:
                continue
            if t0 > cur:
                out.append([cur, t0])
            cur = max(cur, t1)
            if cur >= s1:
                break
        if cur < s1:
            out.append([cur, s1])
    return out


class ResolveTimeline:
    """Accumulator for ONE resolve's pipeline events (opaque token:
    the engine threads it through dispatch and fetch closures; all
    fields mutate under the owning profiler's lock)."""

    __slots__ = ("ns", "t0", "host", "open_parts", "parts",
                 "delivered", "finished", "transfer")

    def __init__(self, ns: str, t0: float):
        self.ns = ns
        self.t0 = t0
        # host work intervals: (kind, t0, t1)
        self.host: List[tuple] = []
        # device -> FIFO of open dispatch stamps (a device can hold
        # several in-flight sub-chunks under degraded re-shard)
        self.open_parts: Dict[int, List[float]] = {}
        # closed busy intervals: (device, t_dispatch, t_close, ok)
        self.parts: List[tuple] = []
        self.delivered = 0
        self.finished = False
        # the resolve's transfer-ledger record, given at close
        self.transfer: Optional[dict] = None


class _HostPhase:
    """Duration-blind context manager for one host work interval —
    the engine never sees a clock value."""

    __slots__ = ("_pl", "_tok", "_kind", "_t0")

    def __init__(self, pl: "PipelineTimeline",
                 tok: Optional[ResolveTimeline], kind: str):
        self._pl = pl
        self._tok = tok
        self._kind = kind

    def __enter__(self):
        self._t0 = self._pl._now()
        return self

    def __exit__(self, *exc):
        if self._tok is not None:
            self._pl._record_host(self._tok, self._kind, self._t0,
                                  self._pl._now())
        return False


class PipelineTimeline:
    """Process-wide pipeline profiler: running totals + a bounded ring
    of per-resolve busy/bubble records."""

    def __init__(self, resolves: int = DEFAULT_RESOLVES):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(4, int(resolves)))
        # closed tokens whose records are not built yet: (token, t_end)
        self._pending: List[tuple] = []
        self._resolves = 0
        self._device_wall_ms = 0.0
        self._busy_ms = 0.0
        self._prep_ms = 0.0
        self._overlap_ms = 0.0
        self._bubble_ms = {c: 0.0 for c in BUBBLE_CLASSES}
        self._bubble_count = 0
        self._largest_bubble_ms = 0.0
        self._largest_bubble_class: Optional[str] = None
        self._parts = 0
        self._delivered = 0

    # the one clock read: tests patch it for scripted timelines; it is
    # the span clock, so records and spans share one time axis
    def _now(self) -> float:
        return tracing._now_ms()

    def configure(self, resolves: Optional[int] = None) -> None:
        """Set how many resolves the ring keeps (the reference's
        PIPELINE_TIMELINE_RESOLVES, at least 4); None keeps it."""
        if resolves is None:
            return
        cap = max(4, int(resolves))
        with self._lock:
            if cap != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=cap)

    # ---------------- per-resolve recording ----------------

    def begin(self, ns: str) -> ResolveTimeline:
        """Open a per-resolve token (not registered anywhere until
        :meth:`close` or :meth:`finish` — a resolver the caller drops is
        just garbage-collected)."""
        return ResolveTimeline(ns, self._now())

    def host_phase(self, tok: Optional[ResolveTimeline],
                   kind: str) -> _HostPhase:
        """``with pipeline_timeline.host_phase(tok, "prep"): ...`` —
        record one host work interval (duration-blind for the
        caller)."""
        return _HostPhase(self, tok, kind)

    def _record_host(self, tok: ResolveTimeline, kind: str,
                     t0: float, t1: float) -> None:
        with self._lock:
            if not tok.finished:
                tok.host.append((kind, t0, t1))

    def note_dispatch(self, tok: Optional[ResolveTimeline],
                      device: Optional[int]) -> None:
        """One committed kernel call on ``device`` (None = the
        single-device path) — opens a busy interval."""
        if tok is None:
            return
        t = self._now()
        d = -1 if device is None else int(device)
        with self._lock:
            if not tok.finished:
                tok.open_parts.setdefault(d, []).append(t)

    def note_delivery(self, tok: Optional[ResolveTimeline],
                      device: Optional[int],
                      delivered: bool = True) -> None:
        """The engine stopped waiting on one of ``device``'s in-flight
        parts: a result was ACCEPTED at the single delivery point
        (``delivered=True``) or the part failed/was abandoned
        (deadline miss, fetch exception, breaker short-circuit of an
        already-dispatched part). Closes the OLDEST open interval —
        FIFO, matching the engine's in-order part walk."""
        if tok is None:
            return
        t = self._now()
        d = -1 if device is None else int(device)
        with self._lock:
            if tok.finished:
                return
            stamps = tok.open_parts.get(d)
            if not stamps:
                return
            t0 = stamps.pop(0)
            tok.parts.append((d, t0, t, delivered))
            if delivered:
                tok.delivered += 1

    def close(self, tok: Optional[ResolveTimeline],
              transfer: Optional[dict] = None) -> None:
        """End a resolve's token (idempotent) without building its
        record: the end is stamped, ``transfer`` (the resolve's
        transfer-ledger record) kept on the token, and the token queued;
        the record is built the next time records or totals are read
        (the oldest one at once when a ring's worth waits unread). The
        engine's resolve pays a stamp and a lock here, not the record's
        build."""
        if tok is None:
            return
        t_end = self._now()
        with self._lock:
            if tok.finished:
                return
            self._end_locked(tok, t_end, transfer)
            self._pending.append((tok, t_end))
            # unread for a ring's worth of resolves: build the oldest
            rec = self._fold_locked(*self._pending.pop(0)) \
                if len(self._pending) > self._ring.maxlen else None
        if rec is not None:
            self._publish(rec)

    def finish(self, tok: Optional[ResolveTimeline],
               transfer: Optional[dict] = None) -> Optional[dict]:
        """End a resolve's token and return its record: reconstruct the
        per-device timeline, classify bubbles, fold into totals and
        metrics, and append the record to the ring (idempotent — a
        resolver resolved twice records once). ``transfer`` is the
        resolve's transfer-ledger record, carried in the record."""
        if tok is None:
            return None
        t_end = self._now()
        with self._lock:
            if tok.finished:
                return None
            self._end_locked(tok, t_end, transfer)
        self._drain()
        with self._lock:
            rec = self._fold_locked(tok, t_end)
        self._publish(rec)
        return rec

    def _end_locked(self, tok: ResolveTimeline, t_end: float,
                    transfer: Optional[dict]) -> None:
        tok.finished = True
        tok.transfer = transfer
        # abandoned in-flight parts (resolver dropped mid-fetch):
        # closed at the resolve end, never delivered
        for d, stamps in tok.open_parts.items():
            for t0 in stamps:
                tok.parts.append((d, t0, t_end, False))
        tok.open_parts.clear()

    def _drain(self) -> None:
        """Build the records of the closed tokens, oldest first."""
        with self._lock:
            recs = [self._fold_locked(tok, t_end)
                    for tok, t_end in self._pending]
            self._pending.clear()
        for rec in recs:
            self._publish(rec)

    def _fold_locked(self, tok: ResolveTimeline, t_end: float) -> dict:
        rec = self._build_record_locked(tok, t_end)
        self._ring.append(rec)
        self._resolves += 1
        self._parts += rec["parts"]
        self._delivered += rec["delivered"]
        self._prep_ms += rec["prep_ms"]
        if rec["n_devices"]:
            self._device_wall_ms += rec["device_wall_ms"]
            self._busy_ms += rec["busy_ms"]
            self._overlap_ms += rec["overlap_ms"]
            for c in BUBBLE_CLASSES:
                self._bubble_ms[c] += rec["bubbles"][c]
            self._bubble_count += rec["bubble_count"]
            if rec["largest_bubble_ms"] > self._largest_bubble_ms:
                self._largest_bubble_ms = rec["largest_bubble_ms"]
                self._largest_bubble_class = rec["largest_bubble_class"]
        return rec

    def _publish(self, rec: dict) -> None:
        """A record's metrics, outside the profiler lock (the registry
        locks itself)."""
        registry.counter(f"{_NS}.resolves").inc()
        if rec["n_devices"]:
            registry.gauge(f"{_NS}.busy_frac").set(rec["busy_frac"])
            if rec["overlap_frac"] is not None:
                registry.gauge(f"{_NS}.overlap_frac").set(
                    rec["overlap_frac"])
            registry.counter(f"{_NS}.bubbles").inc(rec["bubble_count"])
            every = registry.timer(f"{_NS}.bubble_ms")
            for cls, ms in rec["gap_list"]:
                every.update_ms(ms)
                registry.timer(f"{_NS}.bubble.{cls}").update_ms(ms)

    def _build_record_locked(self, tok: ResolveTimeline,
                             t_end: float) -> dict:
        wall = max(0.0, t_end - tok.t0)
        host_by_kind = {k: _merge([[t0, t1] for kind, t0, t1 in tok.host
                                   if kind == k])
                        for k in HOST_KINDS}
        prep_ms = sum(t1 - t0 for t0, t1 in host_by_kind["prep"])
        by_dev: Dict[int, List[List[float]]] = {}
        for d, t0, t1, _ok in tok.parts:
            by_dev.setdefault(d, []).append([t0, t1])
        all_busy = _merge([iv for ivs in by_dev.values() for iv in ivs])
        overlap = sum(_overlap_ms(t0, t1, all_busy)
                      for t0, t1 in host_by_kind["prep"])
        devices = {}
        busy_total = 0.0
        bubbles_total = {c: 0.0 for c in BUBBLE_CLASSES}
        gap_list: List[tuple] = []   # (class, ms) per attributed gap
        bubble_count = 0
        largest = 0.0
        largest_class: Optional[str] = None
        capped = False
        for d in sorted(by_dev):
            merged = _merge(by_dev[d])
            busy = sum(t1 - t0 for t0, t1 in merged)
            busy_total += busy
            first_dispatch = merged[0][0]
            # the complement of busy within [t0, t_end] — the bubbles
            gaps = _subtract([[tok.t0, t_end]], merged)
            dev_bubbles = {c: 0.0 for c in BUBBLE_CLASSES}
            dev_largest = 0.0
            dev_largest_class = None
            for g0, g1 in gaps:
                segs = [[g0, g1]]
                attributed: List[tuple] = []
                for kind in HOST_KINDS:
                    ivs = host_by_kind[kind]
                    if not ivs:
                        continue
                    covered = sum(_overlap_ms(s0, s1, ivs)
                                  for s0, s1 in segs)
                    if covered > 0.0:
                        attributed.append((kind, covered))
                        segs = _subtract(segs, ivs)
                rest = sum(s1 - s0 for s0, s1 in segs)
                if rest > 0.0:
                    rest_cls = "queue_wait" if g0 < first_dispatch \
                        else "gap"
                    attributed.append((rest_cls, rest))
                for cls, ms in attributed:
                    dev_bubbles[cls] += ms
                    bubbles_total[cls] += ms
                    gap_list.append((cls, ms))
                    bubble_count += 1
                    if ms > dev_largest:
                        dev_largest, dev_largest_class = ms, cls
                    if ms > largest:
                        largest, largest_class = ms, cls
            if len(merged) > MAX_INTERVALS_PER_DEVICE:
                merged = merged[:MAX_INTERVALS_PER_DEVICE]
                capped = True
            devices[str(d)] = {
                "busy_ms": round(busy, 3),
                "intervals": [[round(a, 3), round(b, 3)]
                              for a, b in merged],
                "bubbles": {c: round(v, 3)
                            for c, v in dev_bubbles.items()},
                "largest_bubble_ms": round(dev_largest, 3),
                "largest_bubble_class": dev_largest_class,
            }
        n_dev = len(by_dev)
        device_wall = n_dev * wall
        attributed_ms = busy_total + sum(bubbles_total.values())
        rec = {
            "ns": tok.ns,
            "t0_ms": round(tok.t0, 3),
            "t1_ms": round(t_end, 3),
            "wall_ms": round(wall, 3),
            "n_devices": n_dev,
            "devices": devices,
            "parts": len(tok.parts),
            "delivered": tok.delivered,
            "busy_ms": round(busy_total, 3),
            "busy_frac": round(busy_total / device_wall, 4)
            if device_wall > 0 else None,
            "prep_ms": round(prep_ms, 3),
            "overlap_ms": round(overlap, 3),
            "overlap_frac": round(overlap / prep_ms, 4)
            if prep_ms > 0 else None,
            "bubbles": {c: round(v, 3)
                        for c, v in bubbles_total.items()},
            "bubble_count": bubble_count,
            "largest_bubble_ms": round(largest, 3),
            "largest_bubble_class": largest_class,
            "device_wall_ms": round(device_wall, 3),
            # busy + attributed bubbles vs n_devices x wall: ~1.0 when
            # every hook fired and the interval math is consistent
            "reconciliation": round(attributed_ms / device_wall, 4)
            if device_wall > 0 else None,
            "intervals_capped": capped,
            "gap_list": gap_list,
        }
        if tok.transfer is not None:
            rec["transfer"] = {
                k: tok.transfer.get(k, 0)
                for k in ("round_trips", "bytes_h2d", "bytes_d2h",
                          "redundant_constant_bytes")}
        return rec

    # ---------------- introspection ----------------

    def totals(self) -> dict:
        """Running process totals."""
        self._drain()
        with self._lock:
            device_wall = self._device_wall_ms
            busy = self._busy_ms
            prep = self._prep_ms
            overlap = self._overlap_ms
            bubbles = dict(self._bubble_ms)
            return {
                "resolves": self._resolves,
                "parts": self._parts,
                "delivered": self._delivered,
                "device_wall_ms": round(device_wall, 3),
                "busy_ms": round(busy, 3),
                "busy_frac": round(busy / device_wall, 4)
                if device_wall > 0 else None,
                "prep_ms": round(prep, 3),
                "overlap_ms": round(overlap, 3),
                "overlap_frac": round(overlap / prep, 4)
                if prep > 0 else None,
                "bubble_ms": {c: round(v, 3)
                              for c, v in bubbles.items()},
                "bubble_count": self._bubble_count,
                "largest_bubble_ms": round(self._largest_bubble_ms, 3),
                "largest_bubble_class": self._largest_bubble_class,
            }

    def recent(self, limit: int = 8) -> list:
        """The most recent per-resolve records (``gap_list`` working
        field stripped); ``limit=0`` means none."""
        limit = max(0, int(limit))
        self._drain()
        with self._lock:
            tail = list(self._ring)[-limit:] if limit else []
        return [{k: v for k, v in r.items() if k != "gap_list"}
                for r in tail]

    def snapshot(self, limit: int = 8) -> dict:
        """Process totals and the most recent per-resolve records."""
        out = self.totals()
        out["ring_capacity"] = self._ring.maxlen
        out["recent"] = self.recent(limit)
        return out

    def chrome_counter_events(self) -> List[dict]:
        """Chrome ``trace_event`` counter samples (``ph: "C"``) from the
        ring: a device's in-flight track (1 inside each busy interval, 0
        outside), a ``busy_frac`` track a resolve, and cumulative
        transfer bytes at each resolve's end, on the span clock, so one
        trace shows spans, bytes and occupancy together."""
        self._drain()
        with self._lock:
            recs = [dict(r) for r in self._ring]
        events: List[dict] = []

        def counter(name, ts_ms, **vals):
            events.append({"name": name, "ph": "C", "pid": 1,
                           "tid": 0, "ts": round(ts_ms * 1000.0, 1),
                           "args": vals})

        cum_h2d = cum_d2h = 0
        for rec in recs:
            for d, dev in sorted(rec.get("devices", {}).items()):
                for t0, t1 in dev["intervals"]:
                    counter(f"pipeline.dev{d}.inflight", t0, inflight=1)
                    counter(f"pipeline.dev{d}.inflight", t1, inflight=0)
            if rec.get("busy_frac") is not None:
                counter("pipeline.busy_frac", rec["t1_ms"],
                        busy_frac=rec["busy_frac"])
            tr = rec.get("transfer")
            if tr:
                cum_h2d += tr.get("bytes_h2d", 0)
                cum_d2h += tr.get("bytes_d2h", 0)
                counter("transfer.bytes", rec["t1_ms"],
                        h2d=cum_h2d, d2h=cum_d2h)
        events.sort(key=lambda e: e["ts"])
        return events

    def _reset_for_testing(self) -> None:
        """Fresh profiler state (ring + totals). Cumulative registry
        metrics are untouched."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._resolves = 0
            self._device_wall_ms = 0.0
            self._busy_ms = 0.0
            self._prep_ms = 0.0
            self._overlap_ms = 0.0
            self._bubble_ms = {c: 0.0 for c in BUBBLE_CLASSES}
            self._bubble_count = 0
            self._largest_bubble_ms = 0.0
            self._largest_bubble_class = None
            self._parts = 0
            self._delivered = 0


# the process-wide profiler
pipeline_timeline = PipelineTimeline()
