"""Structured tracing: spans, zones and the flight recorder — the port's
copy of ``stellar_tpu/utils/tracing.py``.

* A :class:`span` times one phase of work. On entry it draws a
  process-unique ``span_id``, links to the innermost live span of its
  thread as ``parent_id`` and registers an open record with the
  :class:`FlightRecorder`; on exit it adds its inclusive time to the
  registry timer ``span.<name>`` and moves the record into the
  recorder's bounded ring. :class:`zone` is the same with the timer
  prefix ``zone.``.
* A span opened with ``_collect=names`` is a blocking root: the spans of
  those names opened under it on its own thread fold their time into it,
  and it flushes the totals into ``span.attr.<name>`` timers when it
  exits. :func:`span_totals` snapshots the timers;
  ``stellar_tpu_torch.parallel.batch_engine.phase_attribution`` turns two
  snapshots into the time of each phase of a blocking call.
* Across threads: :func:`current_context` captures the caller's
  innermost span id, :class:`span_context` installs it as the parent on
  another thread. ``resilience.WatchdogPool`` does this for every
  guarded call, so a span opened inside a guarded fetch links to the
  resolve that waits on it: a hung fetch shows in a recorder dump under
  the call that started it.
* The :class:`FlightRecorder` keeps the last N closed spans and every
  open one; ``dump(reason)`` snapshots both when the engine charges a
  watchdog timeout, a quarantine or an audit mismatch;
  ``to_chrome_trace()`` renders them as Chrome ``trace_event`` JSON
  (``chrome://tracing``, Perfetto) with the pipeline timeline's counter
  tracks.

Times are monotonic milliseconds since this module was imported
(:func:`_now_ms`); they feed metrics and the recorder, never a
decision.

``trace_timeline`` stitches one trace's records across the wire, the
fleet router and the replicas (``stitch``), and ``to_chrome_trace
(by_replica=True)`` puts each fleet replica on a process track of its
own. :func:`current_zones` lists the live span names of a thread;
:func:`frame_mark` marks the ``frame.ledger_close`` meter once a closed
ledger.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from stellar_tpu_torch.utils.metrics import registry

__all__ = ["span", "zone", "LogSlowExecution", "current_zones",
           "current_context", "span_context", "frame_mark",
           "FlightRecorder", "flight_recorder", "span_totals",
           "trace_matches"]

_log = logging.getLogger("stellar_tpu_torch.perf")

_tls = threading.local()

# process-unique, increasing span ids (next() on a count is one C call)
_ids = itertools.count(1)

# the origin of span start stamps
_EPOCH = time.perf_counter()


def _now_ms() -> float:
    return (time.perf_counter() - _EPOCH) * 1000.0


def _stack() -> list:
    s = getattr(_tls, "zones", None)
    if s is None:
        s = _tls.zones = []
    return s


def current_zones() -> List[str]:
    """The live zone and span names of this thread (innermost last);
    context anchors are invisible."""
    return [e.name for e in _stack() if e.name is not None]


def current_context() -> Optional[int]:
    """The innermost live span id of this thread (None outside any
    span): hand it to another thread through :class:`span_context`."""
    s = _stack()
    return s[-1].span_id if s else None


def trace_matches(rec: dict, trace_id: int) -> bool:
    """True when a span or event record carries ``trace_id`` in its
    ``traces`` ranges: ``[lo, hi)`` pairs
    (``batch_engine.trace_ranges``), exact, never truncated."""
    attrs = rec.get("attrs")
    if not attrs:
        return False
    for pair in attrs.get("traces") or ():
        try:
            lo, hi = pair
        except (TypeError, ValueError):
            continue
        if lo <= trace_id < hi:
            return True
    return False


class FlightRecorder:
    """Bounded ring of span records and the set of open spans, dumped
    when a fault is charged.

    Records are dicts ``{"id", "parent", "name", "thread", "start_ms",
    "dur_ms"}`` with optional ``attrs``, ``event``, ``open`` and
    ``abandoned``. ``dur_ms`` is None while a span is open, so a dump
    shows where each thread is parked, linked to the call that got it
    there. All state changes under the instance lock."""

    DEFAULT_CAPACITY = 4096

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        self._active: Dict[int, dict] = {}
        self._dumps: deque = deque(maxlen=8)
        self._dumps_total = 0
        self._recorded_total = 0

    def configure(self, capacity: Optional[int] = None) -> None:
        """Set the ring's capacity (the reference's FLIGHT_RECORDER_SPANS,
        at least 16); None keeps it. The newest records stay."""
        if capacity is None:
            return
        cap = max(16, int(capacity))
        with self._lock:
            if cap != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=cap)

    # ---------------- span lifecycle ----------------

    def start_span(self, rec: dict) -> None:
        with self._lock:
            self._active[rec["id"]] = rec

    def finish_span(self, rec: dict) -> None:
        with self._lock:
            self._active.pop(rec["id"], None)
            self._ring.append(rec)
            self._recorded_total += 1

    def abandon_span(self, rec: dict) -> None:
        """A span whose ``__exit__`` never ran (found by an outer span's
        pop): closed into the ring, flagged ``abandoned``, no duration."""
        rec["abandoned"] = True
        self.finish_span(rec)

    def note(self, name: str, **attrs) -> None:
        """An instant event (duration 0) under the caller's live span."""
        rec = {"id": next(_ids), "parent": current_context(),
               "name": name,
               "thread": threading.current_thread().name,
               "start_ms": round(_now_ms(), 3), "dur_ms": 0.0,
               "event": True}
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            self._ring.append(rec)
            self._recorded_total += 1

    # ---------------- dumps and introspection ----------------

    def dump(self, reason: str, limit: int = 256) -> dict:
        """Snapshot the open spans and the ring's tail under ``reason``;
        kept in a bounded list and counted in
        ``tracing.recorder.dumps``."""
        limit = max(0, int(limit))
        with self._lock:
            open_spans = [dict(r, open=True)
                          for r in self._active.values()]
            tail = list(self._ring)[-limit:] if limit else []
            d = {"reason": reason, "seq": self._dumps_total + 1,
                 "open_spans": open_spans,
                 "spans": [dict(r) for r in tail]}
            self._dumps.append(d)
            self._dumps_total += 1
        registry.counter("tracing.recorder.dumps").inc()
        _log.warning("flight recorder dump (%s): %d open spans, "
                     "%d recent records", reason, len(open_spans),
                     len(d["spans"]))
        return d

    def dumps(self) -> List[dict]:
        with self._lock:
            return list(self._dumps)

    def stats(self) -> dict:
        """Accounting only: no record copies."""
        with self._lock:
            return {"capacity": self._ring.maxlen,
                    "recorded_total": self._recorded_total,
                    "dumps_total": self._dumps_total,
                    "dump_reasons": [d["reason"] for d in self._dumps]}

    def snapshot(self, limit: int = 128) -> dict:
        """Open spans, the ``limit`` most recent records (0: none) and
        the dump accounting."""
        limit = max(0, int(limit))
        with self._lock:
            tail = list(self._ring)[-limit:] if limit else []
            return {
                "active": [dict(r) for r in self._active.values()],
                "recent": [dict(r) for r in tail],
                "capacity": self._ring.maxlen,
                "recorded_total": self._recorded_total,
                "dumps_total": self._dumps_total,
                "dump_reasons": [d["reason"] for d in self._dumps],
            }

    def trace_timeline(self, trace_id: int) -> dict:
        """Every record of the ring, the open spans and the dumps whose
        ``traces`` ranges hold ``trace_id``, by start time, the count and
        total time of each span name among them, the service's milestones
        (``summary``: queue wait, coalesce, dispatch to verdict, the
        tenant, a drop) and the cross-replica ``stitch``: which segments
        of the wire -> route -> replica -> verdict path are present, the
        replica hops, and whether every handoff was followed by a
        re-admission (``seamless``). The ring is bounded, so an old trace
        comes back in part (``found`` is True when anything matched)."""
        tid = int(trace_id)
        with self._lock:
            recs = {r["id"]: dict(r) for r in self._ring
                    if trace_matches(r, tid)}
            for r in self._active.values():
                if trace_matches(r, tid):
                    recs.setdefault(r["id"], dict(r, open=True))
            for d in self._dumps:
                for r in d["spans"] + d["open_spans"]:
                    if trace_matches(r, tid):
                        recs.setdefault(r["id"], dict(r))
        records = sorted(recs.values(),
                         key=lambda r: (r["start_ms"], r["id"]))

        def first(name):
            for r in records:
                if r["name"] == name:
                    return r
            return None

        phases: Dict[str, dict] = {}
        for r in records:
            if r.get("event") or r.get("dur_ms") is None:
                continue
            p = phases.setdefault(r["name"],
                                  {"count": 0, "total_ms": 0.0})
            p["count"] += 1
            p["total_ms"] = round(p["total_ms"] + r["dur_ms"], 3)
        summary = {}
        enq = first("service.enqueue")
        coal = first("service.coalesce")
        verdict = first("service.verdict")
        disp = first("span.service.dispatch")
        # tenant attribution: the enqueue milestone carries
        # the submitting tenant, so one item's queue wait is
        # attributable to its principal from the trace route alone
        # (shed/reject milestones carry it too — the fallback covers
        # items refused before any enqueue was recorded)
        for rec in (enq, first("service.shed"),
                    first("service.reject")):
            tenant = (rec or {}).get("attrs", {}).get("tenant")
            if tenant is not None:
                summary["tenant"] = tenant
                break
        if enq and coal:
            summary["queue_wait_ms"] = round(
                coal["start_ms"] - enq["start_ms"], 3)
        if disp and verdict:
            summary["dispatch_to_verdict_ms"] = round(
                verdict["start_ms"] - disp["start_ms"], 3)
        if enq and verdict:
            summary["enqueue_to_verdict_ms"] = round(
                verdict["start_ms"] - enq["start_ms"], 3)
        shed = first("service.shed") or first("service.reject")
        if shed is not None:
            summary["dropped"] = shed["name"]

        # cross-replica stitch summary: which segments of
        # the wire -> route -> replica -> verdict path are present,
        # the replica hop sequence (one entry per fleet.route, with
        # the rendezvous score; handoff re-routes flagged), and the
        # seam check — every service.handoff must be followed by a
        # re-admission on a survivor, so a re-homed trace's timeline
        # reads handoff -> route -> enqueue -> verdict with no gap.
        def every(name):
            return [r for r in records if r["name"] == name]

        routes = every("fleet.route")
        handoffs = every("service.handoff")
        enqueues = every("service.enqueue")
        terminal = (first("service.verdict") or first("service.shed")
                    or first("service.reject")
                    or first("fleet.refuse"))
        hops = [{"replica": r.get("attrs", {}).get("replica"),
                 "score": r.get("attrs", {}).get("score"),
                 "handoff": bool(r.get("attrs", {}).get("handoff"))}
                for r in routes]
        order = {r["id"]: i for i, r in enumerate(records)}
        seamless = all(
            any(order[e["id"]] > order[h["id"]] for e in enqueues)
            for h in handoffs)
        stitch = {
            "wire": bool(first("ingress.frame")),
            "route": bool(routes),
            "enqueue": bool(enqueues),
            "terminal": terminal["name"] if terminal else None,
            "hops": hops,
            "handoffs": len(handoffs),
            "seamless": seamless,
            "end_to_end": (bool(first("ingress.frame"))
                           and bool(routes) and terminal is not None
                           and seamless),
        }
        return {"trace": tid, "found": bool(records),
                "records": records, "phases": phases,
                "summary": summary, "stitch": stitch}

    def to_chrome_trace(self, by_replica: bool = False) -> dict:
        """The recorder as Chrome ``trace_event`` JSON: a thread-named
        track each (``M`` events), closed spans as nested ``B``/``E``
        pairs, instant events and open or abandoned spans as ``i``
        instants (an open span has no duration yet: the instant marks
        where it is parked), and the pipeline timeline's counter tracks
        (``C``) on the same clock. Nesting follows the records' parent
        links on one thread, and a child's interval is clamped inside
        its parent's, so rounding never crosses a begin/end pair.

        ``by_replica=True`` is the whole fleet's view: records of a fleet
        replica (a ``replica`` attribute, or a ``verify-service/<i>``
        dispatcher thread) move to a process track of their own (pid
        ``2 + i``, named by ``process_name`` metadata), everything else
        stays on the host track (pid 1). Every track shares the one
        recorder clock, so the order across replicas is real."""
        with self._lock:
            done = [dict(r) for r in self._ring]
            open_ = [dict(r, open=True) for r in self._active.values()]
        spans = [r for r in done
                 if not r.get("event") and r.get("dur_ms") is not None]
        instants = [r for r in done
                    if r.get("event") or r.get("dur_ms") is None]
        instants += open_
        tids: Dict[str, int] = {}
        seen_tracks: Dict[tuple, str] = {}

        def tid_of(thread: str) -> int:
            if thread not in tids:
                tids[thread] = len(tids) + 1
            return tids[thread]

        def pid_of(r) -> int:
            if not by_replica:
                return 1
            rep = (r.get("attrs") or {}).get("replica")
            if rep is None:
                th = r.get("thread", "")
                if th.startswith("verify-service/"):
                    tail = th.rsplit("/", 1)[1]
                    if tail.isdigit():
                        rep = int(tail)
            try:
                return 1 if rep is None else 2 + int(rep)
            except (TypeError, ValueError):
                return 1

        def track(pid: int, r) -> int:
            tid = tid_of(r["thread"])
            seen_tracks.setdefault((pid, tid), r["thread"])
            return tid

        by_id = {r["id"]: r for r in spans}
        children: Dict[int, list] = {}
        roots: Dict[str, list] = {}
        for r in spans:
            p = r.get("parent")
            if p in by_id and by_id[p]["thread"] == r["thread"]:
                children.setdefault(p, []).append(r)
            else:
                roots.setdefault(r["thread"], []).append(r)
        events: List[dict] = []

        def emit(r, lo_ms: float, hi_ms: float, pid: int) -> float:
            """One span's B/E pair and its subtree, clamped to the
            parent's [lo_ms, hi_ms]; returns the span's end, so a
            sibling cannot overlap it. The subtree keeps the root's pid:
            nesting stays within one track."""
            t0 = min(max(r["start_ms"], lo_ms), hi_ms)
            t1 = min(max(t0, r["start_ms"] + r["dur_ms"]), hi_ms)
            tid = track(pid, r)
            args = {"id": r["id"]}
            if r.get("attrs"):
                args.update(r["attrs"])
            events.append({"name": r["name"], "ph": "B", "pid": pid,
                           "tid": tid, "ts": round(t0 * 1000.0, 1),
                           "args": args})
            cursor = t0
            for c in sorted(children.get(r["id"], []),
                            key=lambda x: (x["start_ms"], x["id"])):
                cursor = emit(c, max(cursor, t0), t1, pid)
            events.append({"name": r["name"], "ph": "E", "pid": pid,
                           "tid": tid, "ts": round(t1 * 1000.0, 1)})
            return t1

        for thread, rs in sorted(roots.items()):
            cursor = 0.0
            for r in sorted(rs, key=lambda x: (x["start_ms"], x["id"])):
                cursor = emit(r, max(cursor, r["start_ms"]), float("inf"),
                              pid_of(r))
        for r in instants:
            args = {"id": r["id"]}
            if r.get("attrs"):
                args.update(r["attrs"])
            if r.get("open"):
                args["open"] = True
            if r.get("abandoned"):
                args["abandoned"] = True
            pid = pid_of(r)
            events.append({"name": r["name"], "ph": "i", "pid": pid,
                           "tid": track(pid, r), "s": "t",
                           "ts": round(r["start_ms"] * 1000.0, 1),
                           "args": args})
        # imported here: the timeline imports this module at load time
        from stellar_tpu_torch.utils.timeline import pipeline_timeline
        events += pipeline_timeline.chrome_counter_events()
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": thread}}
                for (pid, tid), thread in sorted(seen_tracks.items())]
        if by_replica:
            pids = sorted({pid for pid, _tid in seen_tracks})
            meta += [{"name": "process_name", "ph": "M", "pid": pid,
                      "tid": 0,
                      "args": {"name": ("host" if pid == 1 else
                                        f"replica {pid - 2}")}}
                     for pid in pids]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def clear(self) -> None:
        """Drop every record, open span, dump and count."""
        with self._lock:
            self._ring.clear()
            self._active.clear()
            self._dumps.clear()
            self._dumps_total = 0
            self._recorded_total = 0


# the process-wide recorder
flight_recorder = FlightRecorder()


class span:
    """``with span("verify.fetch", device=3): ...`` — inclusive wall time
    into the timer ``span.<name>`` and a recorder record with the span
    id, parent link, thread and attrs.

    ``_collect`` makes the span a blocking root: same-thread spans under
    it whose names are in the set fold their inclusive time into it, and
    it flushes the totals into ``span.attr.<name>`` timers only when it
    exits. A phase entered again inside a call that has not finished
    (a part moved to another device) therefore adds nothing to the
    attribution until its root ends, and a snapshot taken mid-call
    never counts a phase whose root is still open."""

    _PREFIX = "span"
    __slots__ = ("name", "attrs", "span_id", "parent_id", "_t0",
                 "_rec", "_collect", "_collected")

    def __init__(self, name: str, _collect=None, **attrs):
        self.name = name
        self.attrs = attrs
        self._collect = None if _collect is None else frozenset(_collect)
        self._collected = None if _collect is None else {}

    def __enter__(self):
        # the span's time runs from here: its own set-up is part of it,
        # and start_ms + dur_ms is where its exit began
        self._t0 = time.perf_counter()
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        self.span_id = next(_ids)
        self._rec = {"id": self.span_id, "parent": self.parent_id,
                     "name": f"{self._PREFIX}.{self.name}",
                     "thread": threading.current_thread().name,
                     "start_ms": round((self._t0 - _EPOCH) * 1000.0, 3),
                     "dur_ms": None}
        if self.attrs:
            self._rec["attrs"] = dict(self.attrs)
        st.append(self)
        flight_recorder.start_span(self._rec)
        return self

    def __exit__(self, *exc):
        if self._rec.get("abandoned"):
            # already swept into the ring by an outer pop: a late exit
            # must not invent a duration or append the record again
            return False
        # the look-ups come before the stamp, so the span's time includes
        # finding its timer and the root that collects it: a phase's
        # time is as much of its with-block as the span can measure
        timer = registry.timer(f"{self._PREFIX}.{self.name}")
        root = None
        for e in reversed(_stack()):
            if e is self:
                continue
            coll = getattr(e, "_collect", None)
            if coll is not None and self.name in coll:
                root = e
                break
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        timer.update_ms(dt_ms)
        self._rec["dur_ms"] = round(dt_ms, 3)
        flight_recorder.finish_span(self._rec)
        if root is not None:
            # the root's dict is touched only from its own thread (the
            # stack is thread-local), so it needs no lock
            tot = root._collected.get(self.name)
            if tot is None:
                root._collected[self.name] = [1, dt_ms]
            else:
                tot[0] += 1
                tot[1] += dt_ms
        if self._collect is not None and self._collected:
            # after the root's own timer: a snapshot racing the flush
            # sees the root without its phases, never phases without it
            for name, (cnt, sum_ms) in self._collected.items():
                registry.timer(f"span.attr.{name}").record_total(
                    cnt, sum_ms)
        # pop back to this span: entries above it (a span entered by
        # hand and never exited) are closed as abandoned, so no orphan
        # poisons the parent links of later spans on this thread
        st = _stack()
        if any(e is self for e in st):
            while st:
                top = st.pop()
                if top is self:
                    break
                top._abandon()
        return False

    def _abandon(self):
        rec = getattr(self, "_rec", None)
        if rec is not None and rec.get("dur_ms") is None:
            flight_recorder.abandon_span(rec)


class zone(span):
    """A span with the timer prefix ``zone.``."""

    _PREFIX = "zone"
    __slots__ = ()


class _Anchor:
    """A stack entry holding a parent span id borrowed from another
    thread: invisible to :func:`current_zones`, never timed."""

    __slots__ = ("span_id", "name")

    def __init__(self, span_id: int):
        self.span_id = span_id
        self.name = None

    def _abandon(self):
        pass


class span_context:
    """Install ``parent_id`` as this thread's innermost span, so spans
    opened here link under a span of another thread:

        ctx = tracing.current_context()      # caller's thread
        with tracing.span_context(ctx): ...  # worker thread

    ``parent_id=None`` does nothing. On exit the stack is popped back to
    the anchor even when the body raised, so a pooled worker carries no
    stale parent into its next job."""

    __slots__ = ("_anchor",)

    def __init__(self, parent_id: Optional[int]):
        self._anchor = _Anchor(parent_id) if parent_id is not None \
            else None

    def __enter__(self):
        if self._anchor is not None:
            _stack().append(self._anchor)
        return self

    def __exit__(self, *exc):
        if self._anchor is not None:
            st = _stack()
            if any(e is self._anchor for e in st):
                while st:
                    top = st.pop()
                    if top is self._anchor:
                        break
                    top._abandon()
        return False


def span_totals() -> Dict[str, dict]:
    """``{timer_name: {"count", "sum_ms"}}`` of every registry timer:
    the input of ``batch_engine.phase_attribution``, taken before and
    after the calls it attributes."""
    return registry.timer_totals()


class LogSlowExecution:
    """Warn (and count ``slow.<name>``) when a scope outlasts
    ``threshold_ms``."""

    __slots__ = ("name", "threshold_ms", "_t0")

    def __init__(self, name: str, threshold_ms: float = 1000.0):
        self.name = name
        self.threshold_ms = threshold_ms

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        if dt_ms > self.threshold_ms:
            registry.counter(f"slow.{self.name}").inc()
            _log.warning("'%s' hung for %.0f ms (threshold %.0f ms)",
                         self.name, dt_ms, self.threshold_ms)
        return False


def frame_mark() -> None:
    """A closed ledger's frame boundary (the reference's ``FrameMark`` at
    the end of closeLedger, ``LedgerManagerImpl.cpp:1121``)."""
    registry.meter("frame.ledger_close").mark()
