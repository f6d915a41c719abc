"""Resident verify service: continuous batching with admission control,
priority lanes and deterministic load-shed under overload — the port's
copy of ``stellar_tpu/crypto/verify_service.py``.

A node does not call the blocking batch API directly: Herder TxSet
validation, SCP envelope verification and overlay peer auth reach
``PubKeyUtils::verifySig`` as a continuous stream. This module is the
standing stream processor over
:class:`stellar_tpu_torch.crypto.batch_verifier.BatchVerifier`:

* **priority lanes** (``scp`` > ``auth`` > ``bulk``, the reference's
  Herder/overlay split): consensus-critical SCP envelopes and overlay
  peer auth are admitted and scheduled ahead of tx-flood backlog, so a
  flood cannot stall the committee;
* **continuous batching**: one dispatcher thread coalesces queued
  submissions into the verifier's buckets (up to ``MAX_BATCH`` items a
  dispatch, up to ``PIPELINE_DEPTH`` dispatches in flight), overlapping
  the host prep of the next batch with the card's work on the current
  one;
* **admission control and backpressure**: every lane has a queue-depth
  and an in-flight byte budget; work past a budget is refused at ingress
  with a typed :class:`stellar_tpu_torch.utils.resilience.Overloaded`
  instead of buffering without bound;
* **deterministic load-shed ladder**: under backlog or dispatch-degraded
  pressure the service sheds the lowest-priority queued work first, the
  rows chosen by the content-seeded rule
  :func:`stellar_tpu_torch.crypto.audit.keep_under_shed`, so replicas
  under identical pressure shed identical rows with no clock or RNG.
  Every shed is counted and ticketed back to its caller, and the first
  onset dumps the flight recorder
  (:func:`stellar_tpu_torch.crypto.batch_verifier.note_shed_onset`).

**Starvation-proofing** is sequence-based, not clock-based: every
``AGING_EVERY``-th collected batch serves the lane whose head submission
is globally oldest (smallest admission sequence number) whatever its
priority, so the bulk lane always drains.

**Multi-tenant QoS** (:mod:`stellar_tpu_torch.crypto.tenant`):
``submit(lane=..., tenant=...)`` keys every submission to a principal.
Per-tenant depth and byte quotas nest inside the lane budgets (refused
at ingress with ``Overloaded(tenant=...)``, reasons ``"tenant-depth"``
and ``"tenant-bytes"``); within a lane, queued tenants are served by a
deterministic weighted-fair scheduler (start-time fair queueing over
sequence-based virtual time); the shed ladder draws tenant-keyed, with a
flooding tenant's keep fraction scaled down by how far it sits over its
own quota high-water; and every scheduling and shed decision lands in
the flight recorder (``service.schedule`` and ``service.shed`` events)
and in a bounded in-order decision log (:meth:`VerifyService.
decision_log`): two replicas fed the same arrival order emit identical
decision sequences. Per-tenant work conservation holds exactly
(:meth:`VerifyService.tenant_snapshot`).

**Work conservation law**: for every lane,

    submitted == verified + rejected + shed + failed + handoff
                 + pending

with ``failed == 0`` in healthy operation: no item is ever dropped
silently, and ``snapshot()["conservation_gap"]`` reads 0 at all times.
``handoff`` counts items drained with :meth:`VerifyService.drain_handoff`
for re-submission elsewhere (:mod:`stellar_tpu_torch.crypto.fleet`).
The port's engine has no host failover: a part whose card fails, or
misses ``DEADLINE_MS``, moves to another device, and with none left the
resolve raises, so those items count ``failed`` where the reference
verifies them on the host.

**Closed-loop control** (:mod:`stellar_tpu_torch.crypto.controller`):
with a :class:`~stellar_tpu_torch.crypto.controller.VerifyController`
attached (``controller=`` or ``CONTROL_ENABLED``), the dispatcher assembles an
event-count telemetry window every ``CONTROL_EVERY`` collected batches
and the controller adapts ``max_batch``, ``pipeline_depth`` and the
shed-ladder entry high-water within clamped, hysteresis-guarded bounds.
Knobs are applied under the service's condition variable
(:meth:`VerifyService._apply_control_locked`), every move is a
``service.control`` flight-recorder event carrying its input window, and
the trajectory lands in the controller's bounded ``control_log()``,
replayable bit for bit.

Clock reads in this module are confined to latency stamps feeding the
per-lane wait-time histograms (``crypto.verify.service.lane.<lane>.
wait_ms``); which rows verify or shed never depends on them.
"""

from __future__ import annotations

import hashlib
import inspect
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Dict, Optional, Sequence

import numpy as np

from stellar_tpu_torch.crypto import audit as audit_mod
from stellar_tpu_torch.crypto import batch_verifier
from stellar_tpu_torch.crypto import controller as controller_mod
from stellar_tpu_torch.crypto import tenant as tenant_mod
from stellar_tpu_torch.utils import metrics as metrics_mod
from stellar_tpu_torch.utils import resilience
from stellar_tpu_torch.utils.metrics import registry
from stellar_tpu_torch.utils.tracing import span

__all__ = ["VerifyService", "VerifyTicket", "Overloaded", "LANES",
           "SHED_LADDER", "configure_service", "default_service",
           "running_service", "service_verified", "service_health",
           "lane_latencies", "SloMonitor", "slo_monitor",
           "configure_slo", "slo_health", "tenant_health",
           "control_health"]

# re-export: the typed admission verdict lives with the resilience
# primitives so TrickleBatcher can raise it without a module cycle
Overloaded = resilience.Overloaded

# priority order, highest first. scp = SCP envelope verification
# (consensus-critical), auth = overlay peer-auth handshakes, bulk =
# tx-flood / catchup backlog.
LANES = ("scp", "auth", "bulk")

# ---------------- service policy knobs ----------------
# Module constants, read from no environment option: a node pushes
# its Config knobs through configure_service() at setup (same pattern
# as batch_engine.configure_dispatch).

LANE_DEPTH = 512
LANE_BYTES = 16_000_000
MAX_BATCH = 2048
PIPELINE_DEPTH = 4
AGING_EVERY = 4
# bounded in-order log of scheduling + shed decisions: the
# replica-determinism surface — two services fed identical arrival
# order must produce identical logs
DECISION_LOG = 8192

# Degradation ladder: pressure level -> {lane: keep_fraction}. A lane
# absent from a level is NEVER shed at that level; scp is absent from
# every level — consensus work is only ever rejected by its own
# ingress budgets, never dropped from the queue.
#   level 1 (backlog): the bulk queue crossed its high-water mark —
#     shed half the flood by content so the queue stays drainable;
#   level 2 (dispatch-degraded, batch_engine.dispatch_degraded): the
#     probe reads dead or no device of the default verify engine admits
#     work; keep an eighth of bulk and half of auth so the priority
#     lanes stay live.
SHED_LADDER = {
    1: {"bulk": 0.5},
    2: {"bulk": 0.125, "auth": 0.5},
}
# fraction of LANE_DEPTH at which the bulk queue counts as backlogged
SHED_HIGHWATER_FRAC = 0.75

_defaults_lock = threading.Lock()

# ---------------- per-lane SLO definitions ----------------
# Service-level objectives per lane, pushed through configure_slo():
# a LATENCY objective ("<target> of items complete their lane wait
# under <bound> ms") and a COMPLETION objective ("at most
# <shed budget> of items may be shed/rejected/failed"). The bulk
# lane's generous shed budget is DESIGN, not tolerance — the ladder
# sheds flood backlog on purpose; scp's near-zero budget is the
# consensus-lane contract (the ladder never sheds it, only its own
# ingress bounds can reject). Burn rate = observed bad fraction over
# the sliding window / budgeted bad fraction: 1.0 = burning exactly
# at budget, >1 = the error budget is being consumed faster than the
# objective allows (SRE burn-rate semantics).

SLO_WAIT_BOUND_MS = {
    "scp": 5000.0,
    "auth": 8000.0,
    "bulk": 30000.0,
}
SLO_LATENCY_TARGET = 0.99
SLO_SHED_BUDGET = {
    "scp": 0.001,   # consensus lane: effectively zero tolerance
    "auth": 0.05,
    "bulk": 0.5,
}
SLO_WINDOW = 2048


class SloMonitor:
    """Sliding-window error-budget accounting per lane.

    Windows are EVENT-COUNT sliding windows (the last ``window``
    items), not wall-clock buckets: rotation is deterministic in
    arrival order with zero clock reads, which keeps this module's
    nondet posture unchanged — the only clock-derived input is the
    per-item ``wait_ms`` already stamped for the lane histograms
    (allowlisted), and SLO verdicts feed dashboards/burn-rate gauges
    only, never a verify/shed decision.

    A window that has not filled yet is MARKED (``partial: true``) in
    every snapshot — a half-empty window's bad fraction is reported
    with its denominator, never silently presented as a full-window
    rate."""

    def __init__(self, window: Optional[int] = None):
        self._lock = threading.Lock()
        self._window = SLO_WINDOW if window is None \
            else max(8, int(window))
        # lane -> {"events": deque of 0/1 (1 = bad), "bad": int,
        #          "total": int, "bad_total": int}
        self._lat = {ln: self._fresh() for ln in LANES}
        self._comp = {ln: self._fresh() for ln in LANES}

    # window-state machinery is the shared metrics helpers (ONE
    # implementation for the lane and tenant monitors)
    _fresh = staticmethod(metrics_mod.fresh_burn_window)

    def configure(self, window: Optional[int] = None) -> None:
        if window is None:
            return
        with self._lock:
            self._window = max(8, int(window))
            for table in (self._lat, self._comp):
                for st in table.values():
                    self._trim_locked(st)

    def _trim_locked(self, st: dict) -> None:
        metrics_mod.trim_burn_window(st, self._window)

    def _push_locked(self, st: dict, bad: bool, n: int) -> None:
        metrics_mod.push_burn_window(st, bad, n, self._window)

    def note_latency(self, lane: str, wait_ms: float,
                     n: int = 1) -> None:
        """``n`` items of ``lane`` completed with this lane wait."""
        bad = wait_ms > SLO_WAIT_BOUND_MS.get(lane, math_inf)
        with self._lock:
            st = self._lat[lane]
            self._push_locked(st, bad, n)
            burn = self._burn_locked(
                st, max(1e-9, 1.0 - SLO_LATENCY_TARGET))
        # gauge refresh at the FEED site (outside the monitor lock):
        # the Prometheus exposition and the time-series ring must
        # carry live burn rates even when nothing polls the slo route
        registry.gauge(
            f"crypto.verify.service.slo.{lane}.latency_burn_rate"
        ).set(burn)

    def note_completion(self, lane: str, ok: bool,
                        n: int = 1) -> None:
        """``n`` items of ``lane`` reached a terminal state:
        ``ok=False`` for shed / ingress-rejected / failed items (they
        consume the lane's shed budget), True for verified ones."""
        with self._lock:
            st = self._comp[lane]
            self._push_locked(st, not ok, n)
            burn = self._burn_locked(
                st, max(1e-9, SLO_SHED_BUDGET.get(lane, 0.05)))
        registry.gauge(
            f"crypto.verify.service.slo.{lane}.shed_burn_rate"
        ).set(burn)

    @staticmethod
    def _burn_locked(st: dict, budget_frac: float) -> float:
        n = len(st["events"])
        return round((st["bad"] / n) / budget_frac, 4) if n else 0.0

    def snapshot(self) -> dict:
        """The ``slo`` admin-route payload: per lane, both objectives
        with window accounting and burn rates. Also refreshes the
        ``crypto.verify.service.slo.<lane>.*`` burn-rate gauges so
        the Prometheus exposition (and the time-series ring) carry
        live burn rates."""
        with self._lock:
            lanes = {}
            for ln in LANES:
                lat, comp = self._lat[ln], self._comp[ln]
                lat_budget = max(1e-9, 1.0 - SLO_LATENCY_TARGET)
                shed_budget = max(1e-9, SLO_SHED_BUDGET.get(ln, 0.05))
                lanes[ln] = {
                    "latency": self._objective_locked(
                        lat, lat_budget,
                        bound_ms=SLO_WAIT_BOUND_MS.get(ln),
                        target=SLO_LATENCY_TARGET),
                    "completion": self._objective_locked(
                        comp, shed_budget, budget=shed_budget),
                }
            window = self._window
        for ln, obj in lanes.items():
            registry.gauge(
                f"crypto.verify.service.slo.{ln}.latency_burn_rate"
            ).set(obj["latency"]["burn_rate"])
            registry.gauge(
                f"crypto.verify.service.slo.{ln}.shed_burn_rate"
            ).set(obj["completion"]["burn_rate"])
        return {"window": window, "lanes": lanes}

    def _objective_locked(self, st: dict, budget_frac: float,
                          **extra) -> dict:
        n = len(st["events"])
        bad_frac = (st["bad"] / n) if n else 0.0
        return {
            "n": n,
            "window": self._window,
            "partial": n < self._window,
            "bad": st["bad"],
            "bad_frac": round(bad_frac, 6),
            "budget_frac": round(budget_frac, 6),
            "burn_rate": round(bad_frac / budget_frac, 4),
            "total": st["total"],
            "bad_total": st["bad_total"],
            **extra,
        }

    def _reset_for_testing(self) -> None:
        with self._lock:
            self._lat = {ln: self._fresh() for ln in LANES}
            self._comp = {ln: self._fresh() for ln in LANES}


# inf without importing math at call sites (this module avoids new
# imports on the hot path; float("inf") is a constant)
math_inf = float("inf")

# process-wide monitor (every service instance feeds it, like the
# registry meters — one node per process in production)
slo_monitor = SloMonitor()


def configure_slo(scp_p99_ms: Optional[float] = None,
                  auth_p99_ms: Optional[float] = None,
                  bulk_p99_ms: Optional[float] = None,
                  latency_target: Optional[float] = None,
                  bulk_shed_budget: Optional[float] = None,
                  window: Optional[int] = None) -> None:
    """Push SLO knobs (Config / tests); None keeps the current
    value."""
    global SLO_LATENCY_TARGET
    with _defaults_lock:
        if scp_p99_ms is not None:
            SLO_WAIT_BOUND_MS["scp"] = float(scp_p99_ms)
        if auth_p99_ms is not None:
            SLO_WAIT_BOUND_MS["auth"] = float(auth_p99_ms)
        if bulk_p99_ms is not None:
            SLO_WAIT_BOUND_MS["bulk"] = float(bulk_p99_ms)
        if latency_target is not None:
            SLO_LATENCY_TARGET = min(0.999999,
                                     max(0.0, float(latency_target)))
        if bulk_shed_budget is not None:
            SLO_SHED_BUDGET["bulk"] = min(1.0, max(
                1e-6, float(bulk_shed_budget)))
    slo_monitor.configure(window=window)


def slo_health() -> dict:
    """The ``slo`` admin-route payload (served directly — overload is
    exactly when burn rates matter)."""
    return slo_monitor.snapshot()

# ---------------- trace IDs ----------------
# Every submitted item gets a process-unique trace ID at ingress; a
# submission's items take one CONTIGUOUS block so exemplar ranges stay
# compact (batch_verifier.trace_ranges). IDs ride lane queuing, batch
# coalescing, engine sub-chunking, re-shard, audit and host failover —
# and survive shed/reject in the Overloaded ticket. A plain guarded
# counter: no clock, no RNG (this module is nondet-lint scoped).

_trace_lock = threading.Lock()
_trace_next = 1


def _alloc_trace_block(n: int) -> int:
    """Reserve ``n`` contiguous trace IDs; returns the first."""
    global _trace_next
    with _trace_lock:
        lo = _trace_next
        _trace_next += max(1, n)
    return lo


def allocated_traces() -> int:
    """One past the highest trace ID ever issued (IDs start at 1) —
    the typed ``trace?id=`` error path uses it to tell a
    ``never-admitted`` ID from one that was issued but has
    ``expired`` out of the bounded recorder ring."""
    with _trace_lock:
        return _trace_next


def configure_service(lane_depth: Optional[int] = None,
                      lane_bytes: Optional[int] = None,
                      max_batch: Optional[int] = None,
                      pipeline_depth: Optional[int] = None,
                      aging_every: Optional[int] = None) -> None:
    """Push service-policy knobs (Config / tests); None keeps the
    current value. Instances read these at construction — push before
    :func:`default_service` (the Application does)."""
    global LANE_DEPTH, LANE_BYTES, MAX_BATCH, PIPELINE_DEPTH, \
        AGING_EVERY
    with _defaults_lock:
        if lane_depth is not None:
            LANE_DEPTH = max(1, int(lane_depth))
        if lane_bytes is not None:
            LANE_BYTES = max(1, int(lane_bytes))
        if max_batch is not None:
            MAX_BATCH = max(1, int(max_batch))
        if pipeline_depth is not None:
            PIPELINE_DEPTH = max(1, int(pipeline_depth))
        if aging_every is not None:
            AGING_EVERY = max(0, int(aging_every))


class VerifyTicket:
    """Handle for one admitted submission: ``result(timeout)`` blocks
    for the per-item bool array (libsodium-identical decisions, same
    order as the submitted items). Raises
    :class:`Overloaded` with ``kind="shed"`` when the load-shed ladder
    dropped the submission, or the verifier's own exception if the
    batch failed — an admitted submission ALWAYS resolves to exactly
    one of verified / shed / failed, never silence."""

    __slots__ = ("lane", "tenant", "n_items", "trace_lo", "_items",
                 "_nbytes", "_digest", "_seq", "_t_enq", "_fut",
                 "_vstart", "_vfinish")

    def __init__(self, lane: str, items, nbytes: int, digest: bytes,
                 seq: int, t_enq: float, trace_lo: int = 0,
                 tenant: str = tenant_mod.DEFAULT_TENANT):
        from concurrent.futures import Future
        self.lane = lane
        self.tenant = tenant
        self.n_items = len(items)
        self.trace_lo = trace_lo
        self._items = items
        self._nbytes = nbytes
        self._digest = digest
        self._seq = seq
        self._t_enq = t_enq
        self._fut = Future()
        # stamped by the lane's weighted-fair queue at admission
        self._vstart = 0
        self._vfinish = 0

    @property
    def trace_ids(self) -> range:
        """This submission's per-item trace IDs (aligned with the
        submitted items) — the handle the ``trace`` admin route takes
        to reconstruct one item's end-to-end timeline."""
        return range(self.trace_lo, self.trace_lo + self.n_items)

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self._fut.result(timeout)


class VerifyService:
    """The resident stream processor (module docstring). One instance
    owns one dispatcher thread; production uses the process-wide
    :func:`default_service`. ``verifier`` may be any object with the
    ``submit(items) -> resolver`` contract of
    :class:`~stellar_tpu_torch.crypto.batch_verifier.BatchVerifier`; None
    resolves to the default verifier at :meth:`start`."""

    def __init__(self, verifier=None,
                 lane_depth: Optional[int] = None,
                 lane_bytes: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 aging_every: Optional[int] = None,
                 shed_highwater_frac: Optional[float] = None,
                 controller=None,
                 control_every: Optional[int] = None,
                 replica: Optional[int] = None):
        self._verifier = verifier
        # fleet replica identity: stamped into every
        # decision tuple and Overloaded refusal so fleet-level
        # evidence (divergence conviction, refusal attribution) names
        # the replica that produced it; None = single-service deploy
        self.replica = replica
        # ``lane_depth`` accepts a per-lane dict: a
        # replicated fleet concentrates each (lane, tenant) key on
        # ONE replica (rendezvous affinity), so a replica fronting
        # the whole scp key needs a deeper scp queue than its bulk
        # lanes — asymmetric depth is a fleet-sizing knob, not a
        # scheduling change (admission only; shed dynamics key off
        # the bulk depth as before)
        if lane_depth is None:
            self._lane_depth = LANE_DEPTH
        elif isinstance(lane_depth, dict):
            self._lane_depth = {
                ln: max(1, int(lane_depth.get(ln, LANE_DEPTH)))
                for ln in LANES}
        else:
            self._lane_depth = max(1, int(lane_depth))
        self._lane_bytes = LANE_BYTES if lane_bytes is None \
            else max(1, int(lane_bytes))
        self._max_batch = MAX_BATCH if max_batch is None \
            else max(1, int(max_batch))
        self._pipeline_depth = PIPELINE_DEPTH if pipeline_depth is None \
            else max(1, int(pipeline_depth))
        self._aging_every = AGING_EVERY if aging_every is None \
            else max(0, int(aging_every))
        # shed-ladder entry threshold, PER INSTANCE: the
        # closed-loop controller adapts it within clamped bounds
        self._shed_highwater_frac = SHED_HIGHWATER_FRAC \
            if shed_highwater_frac is None \
            else min(1.0, max(0.01, float(shed_highwater_frac)))
        # closed-loop controller: explicit instance wins;
        # None auto-attaches one iff CONTROL_ENABLED, seeded
        # with THIS instance's configured knobs as the relax baseline
        if controller is None and controller_mod.CONTROL_ENABLED:
            controller = controller_mod.VerifyController(
                self._max_batch, self._pipeline_depth,
                self._shed_highwater_frac)
        self._controller = controller
        self._control_every = max(1, controller_mod.CONTROL_EVERY
                                  if control_every is None
                                  else int(control_every))
        self._control_next = self._control_every
        self._cv = threading.Condition()
        self._queues: Dict[str, tenant_mod.TenantLaneQueue] = {
            ln: tenant_mod.TenantLaneQueue() for ln in LANES}
        self._queued_items = {ln: 0 for ln in LANES}
        self._queued_bytes = {ln: 0 for ln in LANES}
        self._inflight_bytes = {ln: 0 for ln in LANES}
        # per-(lane, tenant) in-flight bytes: the tenant byte quota
        # nests inside the lane's queued+in-flight budget, so it must
        # charge the same window — queued alone would let a tenant
        # hold (pipeline_depth+1)x its quota of lane capacity
        self._tenant_inflight = {ln: {} for ln in LANES}
        self._inflight_items = 0
        self._counts = {ln: {"submitted": 0, "verified": 0,
                             "rejected": 0, "shed": 0, "failed": 0,
                             "handoff": 0}
                        for ln in LANES}
        # per-tenant conservation counters: submitted ==
        # verified + rejected + shed + failed + pending PER TENANT;
        # bounded by the tenant tracking cap (overflow folds into the
        # reserved OTHER_TENANT rollup, counted — never silent)
        self._tenant_counts: Dict[str, dict] = {}
        # bounded in-order scheduling/shed decision log
        self._decisions: deque = deque(maxlen=max(16, DECISION_LOG))
        # unified system journal feed: one bounded,
        # in-order admission/terminal event log keyed by a monotone
        # per-component seq (the reference's journal merges these
        # feeds across replicas into the fleet-wide journal).
        # The aggregate totals are plain integers that never evict,
        # so the journal completeness law stays checkable even after
        # the bounded row log wraps.
        self._journal: deque = deque(maxlen=max(16, DECISION_LOG))
        self._jseq = 0
        self._journal_totals = {"submitted": 0, "verified": 0,
                                "failed": 0, "rejected": 0,
                                "shed": 0, "handoff": 0}
        self._seq = 0
        self._batches = 0
        self._pressure = 0
        self._shed_seen = False
        self._running = False
        self._stop = False
        self._drain = True
        self._traceful = False
        self._thread: Optional[threading.Thread] = None

    # ---------------- public API ----------------

    def start(self) -> "VerifyService":
        """Spawn the dispatcher thread (idempotent) and register the
        service's health snapshot with ``dispatch_health()``."""
        with self._cv:
            if self._running:
                return self
            if self._verifier is None:
                self._verifier = batch_verifier.default_verifier()
            # trace-ID propagation rides verifiers whose
            # submit accepts trace_ids (the real engine); duck-typed
            # stand-ins keep working without them
            try:
                self._traceful = "trace_ids" in inspect.signature(
                    self._verifier.submit).parameters
            except (TypeError, ValueError):
                self._traceful = False
            self._running = True
            self._stop = False
            self._drain = True
            # a fleet replica's dispatcher carries its identity in
            # the thread name: flight-recorder records tag
            # the emitting thread, so the stitched timeline and the
            # per-replica Chrome tracks can tell replicas apart even
            # though they share one process-wide recorder
            tname = ("verify-service" if self.replica is None
                     else f"verify-service/{self.replica}")
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=tname)
        self._thread.start()
        batch_verifier.register_service_health(self.snapshot)
        global _tenant_provider, _control_provider
        with _service_lock:
            # the tenant/control routes serve the last-started
            # instance (same policy as register_service_health: an
            # embedded service still gets an admin surface)
            _tenant_provider = self.tenant_snapshot
            _control_provider = self.control_snapshot
        return self

    def submit(self, items: Sequence[tuple], lane: str = "bulk",
               tenant: Optional[str] = None,
               trace_lo: Optional[int] = None) -> VerifyTicket:
        """Admit one submission of (pk, msg, sig) triples into
        ``lane`` on behalf of ``tenant`` (None = the quota-exempt
        default tenant). Raises :class:`Overloaded`
        (``kind="rejected"``) at ingress when the lane's queue-depth
        or byte budget is exhausted, the tenant's own depth/byte
        quota inside the lane is exhausted (``reason="tenant-depth"``
        / ``"tenant-bytes"``, ``tenant`` set on the exception), or
        the service is stopping — rejected work never enters a queue,
        so memory stays bounded no matter the offered load.

        ``trace_lo`` lets the fleet router re-submit
        drained work under its ORIGINAL trace block — a handoff keeps
        the items' trace IDs intact; leave None for fresh work."""
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r} (one of {LANES})")
        tenant = tenant_mod.validate_tenant(tenant)
        weight, t_depth, t_bytes = tenant_mod.tenant_policy(tenant)
        items = list(items)
        n = len(items)
        nbytes = 0
        h = hashlib.sha256()   # shed digest: incremental, zero copies
        for pk, msg, sig in items:
            nbytes += len(pk) + len(msg) + len(sig)
            h.update(pk)
            h.update(msg)
            h.update(sig)
        digest = h.digest()
        # per-item trace IDs (one contiguous block per submission):
        # assigned BEFORE admission so a rejected submission's trace
        # still exists — tagged in the Overloaded ticket and the
        # recorder's service.reject event. A fleet handoff passes the
        # original block in, so a re-submitted item's trace survives
        # its first replica's death.
        if trace_lo is None:
            trace_lo = _alloc_trace_block(n)
        trange = [[trace_lo, trace_lo + n]] if n else []
        # clock read: latency stamp only — feeds the lane wait-time
        # histogram, never a verify/shed decision (nondet allowlist)
        t_enq = time.monotonic()
        registry.meter("crypto.verify.service.submitted").mark(n)
        registry.meter(
            f"crypto.verify.service.lane.{lane}.submitted").mark(n)
        with self._cv:
            self._counts[lane]["submitted"] += n
            tc = self._tenant_counts_locked(tenant)
            tc["submitted"] += n
            reason = None
            if self._stop or not self._running:
                reason = "stopped"
            elif len(self._queues[lane]) >= self._depth_of(lane):
                reason = "queue-depth"
            elif (self._queued_bytes[lane] + self._inflight_bytes[lane]
                  + nbytes) > self._lane_bytes:
                reason = "bytes"
            # per-tenant quotas NEST inside the lane budgets: one tenant exhausts its own slice of the lane and
            # gets a typed, tenant-attributed refusal while in-quota
            # tenants keep submitting
            elif t_depth and \
                    self._queues[lane].depth(tenant) >= t_depth:
                reason = "tenant-depth"
            elif t_bytes and (self._queues[lane].queued_bytes(tenant)
                              + self._tenant_inflight[lane].get(
                                  tenant, 0)
                              + nbytes) > t_bytes:
                reason = "tenant-bytes"
            if reason is not None:
                self._counts[lane]["rejected"] += n
                tc["rejected"] += n
                registry.meter(
                    "crypto.verify.service.rejected").mark(n)
                registry.meter(
                    f"crypto.verify.service.lane.{lane}.rejected"
                ).mark(n)
                if reason.startswith("tenant-"):
                    tc["quota_rejected"] += n
                    registry.meter(
                        "crypto.verify.service.tenant.quota_rejected"
                    ).mark(n)
                # a rejected item is a completion-SLO miss: it
                # consumed the lane's shed/reject budget
                # and the tenant's own budget
                slo_monitor.note_completion(lane, ok=False, n=n)
                tenant_mod.tenant_slo.note_completion(tenant, ok=False,
                                                      n=n)
                batch_verifier.note_trace_event(
                    "service.reject", lane=lane, reason=reason,
                    tenant=tenant, traces=trange, items=n)
                self._journal_note_locked(
                    "rejected", lane, tenant, self._seq, trace_lo, n,
                    reason=reason)
                raise Overloaded(
                    f"verify service {lane} lane over budget "
                    f"({reason})", kind="rejected", lane=lane,
                    reason=reason, tenant=tenant,
                    trace_ids=range(trace_lo, trace_lo + n),
                    replica=self.replica)
            tkt = VerifyTicket(lane, items, nbytes, digest,
                               self._seq, t_enq, trace_lo=trace_lo,
                               tenant=tenant)
            self._seq += 1
            if n == 0:
                tkt._fut.set_result(np.zeros(0, dtype=bool))
                return tkt
            self._queues[lane].push(tkt, weight)
            tc["pending"] += n
            self._queued_items[lane] += n
            self._queued_bytes[lane] += nbytes
            self._publish_lane_gauges_locked(lane)
            # trace milestone: admitted into the lane queue (recorder
            # write routed through the engine — the tracing fence
            # keeps this module duration-blind). Emitted BEFORE the
            # notify, like service.reject above: once the dispatcher
            # wakes it may coalesce and record service.coalesce /
            # service.verdict for these traces, and the reconstructed
            # timeline (trace_timeline) must never see a verdict
            # before its enqueue.
            batch_verifier.note_trace_event(
                "service.enqueue", lane=lane, tenant=tenant,
                traces=trange, seq=tkt._seq, items=n)
            self._journal_note_locked(
                "enqueue", lane, tenant, tkt._seq, trace_lo, n)
            self._cv.notify_all()
        return tkt

    def verify(self, items: Sequence[tuple], lane: str = "bulk",
               timeout: Optional[float] = None,
               tenant: Optional[str] = None) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(items, lane=lane,
                           tenant=tenant).result(timeout)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the dispatcher. ``drain=True`` (default) keeps
        dispatching until the queues are empty — but the shed ladder
        still applies while draining: a shutdown under persistent
        overload pressure (dispatch degraded / backlog) must
        bound its own duration, so low-priority backlog may still
        shed (counted + ticketed, like any shed) rather than hold the
        node open. ``drain=False`` sheds the whole queued backlog
        (reason ``"stopped"``) and only finishes work already in
        flight. New submissions are rejected (``"stopped"``) from the
        moment stop is called.

        Terminal guarantee: every client-visible ticket
        held across a stop resolves — verified, failed, or a typed
        ``Overloaded`` — even when the dispatcher thread itself died
        (the ``_run`` finally sheds any stranded backlog with reason
        ``"stopped"``), so a wire-ingress responder or a fleet
        ``kill_replica`` composed with a connection close never
        leaves a pending item without a documented terminal."""
        with self._cv:
            if not self._running:
                return
            self._stop = True
            self._drain = drain
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        with self._cv:
            self._running = False

    def drain_handoff(self) -> list:
        """Fleet drain protocol: atomically extract every
        QUEUED submission so the router can re-submit each one to a
        surviving replica with its trace IDs intact. Extracted items
        move to the ``handoff`` terminal of this replica's
        conservation law (they are no longer this replica's to finish
        — they will be counted exactly once more, at the survivor
        that admits them), so both the per-replica and the fleet
        residuals stay exactly 0 through a kill. In-flight work is
        NOT touched: the dispatcher finishes it during the drain stop
        that follows. Returns the extracted tickets with their
        futures still pending — the router chains each future to its
        re-submission, so callers never observe the handoff."""
        out = []
        with self._cv:
            for ln in LANES:
                for tkt in self._queues[ln].drain_if(None):
                    self._queued_items[ln] -= tkt.n_items
                    self._queued_bytes[ln] -= tkt._nbytes
                    self._counts[ln]["handoff"] += tkt.n_items
                    tc = self._tenant_counts_locked(tkt.tenant)
                    tc["handoff"] += tkt.n_items
                    tc["pending"] -= tkt.n_items
                    registry.meter(
                        "crypto.verify.service.handoff"
                    ).mark(tkt.n_items)
                    batch_verifier.note_trace_event(
                        "service.handoff", lane=ln, tenant=tkt.tenant,
                        replica=self.replica,
                        traces=[[tkt.trace_lo,
                                 tkt.trace_lo + tkt.n_items]])
                    self._journal_note_locked(
                        "handoff", ln, tkt.tenant, tkt._seq,
                        tkt.trace_lo, tkt.n_items)
                    out.append(tkt)
                self._publish_lane_gauges_locked(ln)
        return out

    def snapshot(self) -> dict:
        """Health surface (``dispatch_health()["service"]`` / the
        ``service`` admin route): per-lane depths, budgets, the
        conservation-law counters, wait-time percentiles, pressure
        level. ``conservation_gap`` is the law's residual and must
        always read 0."""
        with self._cv:
            lanes = {}
            totals = {"submitted": 0, "verified": 0, "rejected": 0,
                      "shed": 0, "failed": 0, "handoff": 0}
            for ln in LANES:
                c = dict(self._counts[ln])
                for k in totals:
                    totals[k] += c[k]
                t = registry.timer(
                    f"crypto.verify.service.lane.{ln}.wait_ms")
                p50, p99 = t.percentiles_ms((50, 99))
                lanes[ln] = {
                    "queued_submissions": len(self._queues[ln]),
                    "queued_items": self._queued_items[ln],
                    "queued_bytes": self._queued_bytes[ln],
                    "inflight_bytes": self._inflight_bytes[ln],
                    "wait_ms": {"count": t.count,
                                "p50": round(p50, 3),
                                "p99": round(p99, 3)},
                    **c,
                }
            pending = (sum(self._queued_items[ln] for ln in LANES)
                       + self._inflight_items)
            return {
                "running": self._running and not self._stop,
                "pressure": self._pressure,
                "shed_onset_seen": self._shed_seen,
                "batches": self._batches,
                "pending_items": pending,
                "lanes": lanes,
                "totals": totals,
                "conservation_gap": (
                    totals["submitted"] - totals["verified"]
                    - totals["rejected"] - totals["shed"]
                    - totals["failed"] - totals["handoff"] - pending),
                "knobs": {"lane_depth": self._lane_depth,
                          "lane_bytes": self._lane_bytes,
                          "max_batch": self._max_batch,
                          "pipeline_depth": self._pipeline_depth,
                          "aging_every": self._aging_every},
                "control": {
                    "enabled": self._controller is not None,
                    "shed_highwater_frac": self._shed_highwater_frac,
                },
            }

    def tenant_snapshot(self) -> dict:
        """Per-tenant accounting surface (the ``tenant`` admin route):
        the conservation counters per tracked tenant, each
        tenant's residual (must read 0 — the per-tenant work
        conservation law), and decision-log accounting. Tenants past
        the tracking cap fold into the reserved ``~other`` rollup
        (counted, never silent)."""
        with self._cv:
            tenants = {t: dict(c)
                       for t, c in self._tenant_counts.items()}
            n_decisions = len(self._decisions)
        gaps = {}
        for t, c in tenants.items():
            c["conservation_gap"] = (
                c["submitted"] - c["verified"] - c["rejected"]
                - c["shed"] - c["failed"] - c.get("handoff", 0)
                - c["pending"])
            if c["conservation_gap"] != 0:
                gaps[t] = c["conservation_gap"]
        return {"tenants": tenants,
                "tracked": len(tenants),
                "track_cap": tenant_mod.TENANT_TRACK_CAP,
                "conservation_violations": gaps,
                "decision_log_len": n_decisions}

    def decision_log(self, limit: int = 0) -> list:
        """The bounded in-order scheduling/shed decision log:
        ``("dispatch", lane, tenant, seq, vfinish, replica)`` per
        weighted-fair pop and ``("shed", lane, tenant, seq, level,
        replica)`` per shed row (``replica`` is this service's fleet
        identity — None outside a fleet). Two replicas fed
        identical arrival order produce identical logs — the
        bit-identical surface replicas are held to.
        ``limit`` bounds the tail returned (0 = all retained)."""
        with self._cv:
            log = list(self._decisions)
        return log[-limit:] if limit else log

    def journal_log(self, limit: int = 0) -> list:
        """The bounded journal feed: one dict row per
        admission (``enqueue``) and per terminal (``verified`` /
        ``failed`` / ``rejected`` / ``shed`` / ``handoff``), each
        carrying a monotone per-component ``seq``, the ticket seq,
        the trace block ``(trace_lo, n)`` and — for refusals/sheds —
        the typed reason. Pure content, no clock reads: two replicas
        fed identical arrival order produce identical feeds. ``limit``
        bounds the tail returned (0 = all retained)."""
        with self._cv:
            log = [dict(r) for r in self._journal]
        return log[-limit:] if limit else log

    def journal_totals(self) -> dict:
        """Never-evicting aggregate counts behind the journal feed:
        items enqueued plus each terminal kind. These reconcile
        EXACTLY with the per-lane conservation counters (``submitted
        == journal.submitted + journal.rejected``; every terminal
        matches), which is half of the journal completeness law —
        :func:`stellar_tpu_torch.utils.journal.completeness` checks it."""
        with self._cv:
            return dict(self._journal_totals)

    def control_log(self, limit: int = 0) -> list:
        """The attached controller's bounded knob-trajectory log
       ; empty when no controller is attached."""
        ctl = self._controller
        return ctl.control_log(limit) if ctl is not None else []

    def control_snapshot(self) -> dict:
        """The ``control`` admin-route payload: the controller's
        knob/clamp/hysteresis state plus the tail of its trajectory
        log, and the LIVE values the service is currently applying."""
        ctl = self._controller
        with self._cv:
            live = {"max_batch": self._max_batch,
                    "pipeline_depth": self._pipeline_depth,
                    "shed_highwater_frac": self._shed_highwater_frac,
                    "control_every": self._control_every}
        if ctl is None:
            return {"enabled": False, "live": live}
        return {"enabled": True, "live": live,
                "controller": ctl.snapshot(),
                "log_tail": ctl.control_log(limit=32)}

    # ---------------- dispatcher internals ----------------
    # _locked helpers are called with self._cv held (the repo-wide
    # naming contract the lock lint encodes).

    def _journal_note_locked(self, kind: str, lane: str, tenant,
                             seq: int, trace_lo, n: int,
                             **extra) -> None:
        """Append one row to this replica's journal feed (called with
        the cv held). Rows are pure functions of admission content and
        queue state — no clock reads, no RNG — so the feed is
        bit-identical across replicas under identical arrival order.
        The aggregate totals update on the same append path, so the
        bounded row log and the totals can never disagree."""
        row = {"seq": self._jseq, "kind": kind, "lane": lane,
               "tenant": tenant, "ticket": seq,
               "trace_lo": trace_lo, "n": n}
        if extra:
            row.update(extra)
        self._jseq += 1
        self._journal.append(row)
        tot = self._journal_totals
        if kind == "enqueue":
            tot["submitted"] += n
        elif kind in tot:
            tot[kind] += n

    def _tenant_counts_locked(self, tenant: str) -> dict:
        """Get-or-create one tenant's conservation counters, folding
        into the reserved OTHER_TENANT rollup once the tracking cap is
        reached — a tenant folded at submit keeps folding at every
        later transition (entries are never removed), so the rollup's
        own conservation stays exact."""
        tc = self._tenant_counts.get(tenant)
        if tc is None:
            if len(self._tenant_counts) >= \
                    tenant_mod.TENANT_TRACK_CAP and \
                    tenant != tenant_mod.OTHER_TENANT:
                return self._tenant_counts_locked(
                    tenant_mod.OTHER_TENANT)
            tc = self._tenant_counts[tenant] = {
                "submitted": 0, "verified": 0, "rejected": 0,
                "quota_rejected": 0, "shed": 0, "failed": 0,
                "handoff": 0, "pending": 0}
        return tc

    def _publish_lane_gauges_locked(self, ln: str) -> None:
        """Live backlog gauges: queue depth and
        queued+in-flight bytes per lane ride the Prometheus
        exposition, so an operator sees backlog BUILDING before the
        shed ladder fires — the wait histograms only show it after
        the fact."""
        registry.gauge(
            f"crypto.verify.service.lane.{ln}.depth").set(
            len(self._queues[ln]))
        registry.gauge(
            f"crypto.verify.service.lane.{ln}.bytes").set(
            self._queued_bytes[ln] + self._inflight_bytes[ln])

    def _depth_of(self, lane: str) -> int:
        """Admission depth for ``lane`` — scalar or per-lane dict."""
        d = self._lane_depth
        return d[lane] if isinstance(d, dict) else d

    def _pressure_locked(self) -> tuple:
        """(level, why): 2 = dispatch degraded (global breaker open /
        no device admits work), 1 = bulk
        backlog over high-water, 0 = healthy."""
        if batch_verifier.dispatch_degraded():
            return 2, "dispatch-degraded"
        hw = max(1, int(self._depth_of("bulk")
                        * self._shed_highwater_frac))
        if len(self._queues["bulk"]) >= hw:
            return 1, "backlog"
        return 0, ""

    def _shed_pass_locked(self) -> Optional[str]:
        """Apply the shed ladder to the queues at the current pressure
        level. Row selection is the content-seeded rule
        (:func:`stellar_tpu_torch.crypto.audit.keep_under_shed`) with the
        TENANT key mixed in, and each tenant's effective
        keep fraction is the ladder fraction scaled down by how far
        that tenant sits over its own quota high-water
        (:func:`stellar_tpu_torch.crypto.tenant.shed_keep_fraction`) — a
        flooding tenant's rows shed first, in-quota tenants keep the
        lane fraction, and replicas under identical arrival order
        still shed identical rows (all inputs are queue state +
        content, no clocks). Every shed is counted, ticketed, logged
        in the decision log. Returns the pressure reason when THIS
        pass was the first-ever shed (the caller fires the
        flight-recorder dump outside the lock), else None."""
        level, why = self._pressure_locked()
        self._pressure = level
        registry.gauge("crypto.verify.service.pressure").set(level)
        ladder = SHED_LADDER.get(level)
        if not ladder:
            return None
        onset = None
        for ln, keep in ladder.items():
            q = self._queues[ln]
            if not q:
                continue
            # per-tenant effective keep fractions, computed ONCE per
            # pass from the queue state this pass sees
            eff = {}
            for t, subs in q.tenant_depths().items():
                _w, t_depth, _b = tenant_mod.tenant_policy(t)
                eff[t] = tenant_mod.shed_keep_fraction(
                    keep, subs, t_depth, level=level)

            def _keep(tkt):
                return audit_mod.keep_under_shed(
                    tkt._digest, eff[tkt.tenant],
                    tenant=tenant_mod.shed_key(tkt.tenant))

            for tkt in q.drain_if(_keep):
                self._queued_items[ln] -= tkt.n_items
                self._queued_bytes[ln] -= tkt._nbytes
                self._counts[ln]["shed"] += tkt.n_items
                tc = self._tenant_counts_locked(tkt.tenant)
                tc["shed"] += tkt.n_items
                tc["pending"] -= tkt.n_items
                self._decisions.append(
                    ("shed", ln, tkt.tenant, tkt._seq, level,
                     self.replica))
                registry.meter(
                    "crypto.verify.service.shed").mark(tkt.n_items)
                registry.meter(
                    f"crypto.verify.service.lane.{ln}.shed"
                ).mark(tkt.n_items)
                slo_monitor.note_completion(ln, ok=False,
                                            n=tkt.n_items)
                tenant_mod.tenant_slo.note_completion(
                    tkt.tenant, ok=False, n=tkt.n_items)
                if not self._shed_seen:
                    self._shed_seen = True
                    onset = why
                self._journal_note_locked(
                    "shed", ln, tkt.tenant, tkt._seq, tkt.trace_lo,
                    tkt.n_items, reason=why, level=level)
                batch_verifier.note_trace_event(
                    "service.shed", lane=ln, reason=why, level=level,
                    tenant=tkt.tenant,
                    keep_fraction=round(eff[tkt.tenant], 6),
                    traces=[[tkt.trace_lo,
                             tkt.trace_lo + tkt.n_items]])
                tkt._fut.set_exception(Overloaded(
                    f"shed under overload (level {level}: {why})",
                    kind="shed", lane=ln, reason=why,
                    tenant=tkt.tenant, trace_ids=tkt.trace_ids,
                    replica=self.replica))
            self._publish_lane_gauges_locked(ln)
        return onset

    def _abort_queues_locked(self) -> None:
        """Non-drain stop: shed every queued submission (counted,
        ticketed — reason ``"stopped"``, never silent)."""
        for ln in LANES:
            for tkt in self._queues[ln].drain_if(None):
                self._queued_items[ln] -= tkt.n_items
                self._queued_bytes[ln] -= tkt._nbytes
                self._counts[ln]["shed"] += tkt.n_items
                tc = self._tenant_counts_locked(tkt.tenant)
                tc["shed"] += tkt.n_items
                tc["pending"] -= tkt.n_items
                registry.meter(
                    "crypto.verify.service.shed").mark(tkt.n_items)
                registry.meter(
                    f"crypto.verify.service.lane.{ln}.shed"
                ).mark(tkt.n_items)
                slo_monitor.note_completion(ln, ok=False,
                                            n=tkt.n_items)
                tenant_mod.tenant_slo.note_completion(
                    tkt.tenant, ok=False, n=tkt.n_items)
                batch_verifier.note_trace_event(
                    "service.shed", lane=ln, reason="stopped",
                    tenant=tkt.tenant,
                    traces=[[tkt.trace_lo,
                             tkt.trace_lo + tkt.n_items]])
                self._journal_note_locked(
                    "shed", ln, tkt.tenant, tkt._seq, tkt.trace_lo,
                    tkt.n_items, reason="stopped")
                tkt._fut.set_exception(Overloaded(
                    "service stopped without drain", kind="shed",
                    lane=ln, reason="stopped", tenant=tkt.tenant,
                    trace_ids=tkt.trace_ids, replica=self.replica))
            self._publish_lane_gauges_locked(ln)

    def _pick_lane_locked(self) -> Optional[str]:
        """Priority order, with sequence-based aging: every
        ``aging_every``-th batch serves the lane whose head submission
        is globally oldest, so the bulk lane cannot starve behind a
        sustained priority stream. Clock-free and deterministic in
        arrival order."""
        nonempty = [ln for ln in LANES if self._queues[ln]]
        if not nonempty:
            return None
        if len(nonempty) > 1 and self._aging_every > 0 and \
                self._batches % self._aging_every == \
                self._aging_every - 1:
            return min(nonempty,
                       key=lambda ln: self._queues[ln].oldest_seq())
        return nonempty[0]

    def _collect_locked(self):
        """Coalesce queued submissions of ONE lane into a batch of up
        to ``max_batch`` items (continuous batching into the
        verifier's buckets), serving tenants in deterministic
        weighted-fair order within the lane. An oversize
        single submission rides alone — the verifier chunks it.
        Returns (lane, items, parts, tids, decisions) or None; parts
        are (ticket, item_offset) pairs, decisions the weighted-fair
        pop records (the caller emits them as ``service.schedule``
        flight-recorder events outside this lock)."""
        ln = self._pick_lane_locked()
        if ln is None:
            return None
        q = self._queues[ln]
        items: list = []
        parts = []
        tids: list = []
        decisions: list = []
        while q:
            head = q.peek()
            if items and len(items) + head.n_items > self._max_batch:
                break
            tkt, dec = q.pop(head)
            dec["traces"] = [[tkt.trace_lo,
                              tkt.trace_lo + tkt.n_items]]
            decisions.append(dec)
            self._decisions.append(
                ("dispatch", ln, tkt.tenant, tkt._seq, tkt._vfinish,
                 self.replica))
            parts.append((tkt, len(items)))
            items.extend(tkt._items)
            tids.extend(tkt.trace_ids)
            self._queued_items[ln] -= tkt.n_items
            self._queued_bytes[ln] -= tkt._nbytes
            self._inflight_bytes[ln] += tkt._nbytes
            ti = self._tenant_inflight[ln]
            ti[tkt.tenant] = ti.get(tkt.tenant, 0) + tkt._nbytes
        self._inflight_items += len(items)
        self._batches += 1
        self._publish_lane_gauges_locked(ln)
        return (ln, items, parts, tids, decisions)

    def _resolve_one(self, ln: str, parts, resolver,
                     traces=None) -> None:
        """Block on one in-flight dispatch and complete its tickets.
        Counters update BEFORE futures complete, so a caller that
        wakes on its ticket already sees consistent accounting."""
        out = None
        err: Optional[BaseException] = None
        rs_attrs = {"lane": ln}
        if traces:
            rs_attrs["traces"] = traces
        with span("service.resolve", **rs_attrs):
            try:
                out = np.asarray(resolver())
            except BaseException as e:  # ticketed, never silent
                err = e
        if err is not None:
            # a failed resolve (a device fault or a missed deadline
            # with no device left) takes the dispatch failure's path
            self._resolve_failed(ln, parts, err, traces=traces)
            return
        n = sum(t.n_items for t, _ in parts)
        nbytes = sum(t._nbytes for t, _ in parts)
        tenants = _part_tenants(parts)
        with self._cv:
            self._inflight_items -= n
            self._inflight_bytes[ln] -= nbytes
            self._counts[ln]["verified"] += n
            self._tenant_terminal_locked(ln, parts, "verified")
            self._publish_lane_gauges_locked(ln)
        registry.meter("crypto.verify.service.verified").mark(n)
        registry.meter(
            f"crypto.verify.service.lane.{ln}.verified").mark(n)
        slo_monitor.note_completion(ln, ok=True, n=n)
        # trace milestone: each verdict carries its trace — the END of
        # the trace route's reconstructed timeline
        batch_verifier.note_trace_event(
            "service.verdict", lane=ln, tenants=tenants,
            traces=traces or [], items=n)
        # clock read: wait-time histogram stamp only (nondet allowlist)
        now = time.monotonic()
        timer = registry.timer(
            f"crypto.verify.service.lane.{ln}.wait_ms")
        for tkt, off in parts:
            wait_ms = (now - tkt._t_enq) * 1000.0
            timer.update_ms(wait_ms)
            # SLO accounting: the lane AND tenant
            # latency objectives read the SAME allowlisted stamp the
            # histogram does; the verdict below never depends on it
            slo_monitor.note_latency(ln, wait_ms, n=tkt.n_items)
            tenant_mod.tenant_slo.note_latency(
                tkt.tenant, wait_ms, n=tkt.n_items)
            tenant_mod.tenant_slo.note_completion(
                tkt.tenant, ok=True, n=tkt.n_items)
            tkt._fut.set_result(
                np.array(out[off:off + tkt.n_items], dtype=bool))

    def _tenant_terminal_locked(self, ln: str, parts,
                                outcome: str) -> None:
        """Move every part's items from pending to a terminal
        per-tenant counter and release the tenant's in-flight bytes
        (called with the cv held)."""
        ti = self._tenant_inflight[ln]
        for tkt, _off in parts:
            tc = self._tenant_counts_locked(tkt.tenant)
            tc[outcome] += tkt.n_items
            tc["pending"] -= tkt.n_items
            self._journal_note_locked(
                outcome, ln, tkt.tenant, tkt._seq, tkt.trace_lo,
                tkt.n_items)
            left = ti.get(tkt.tenant, 0) - tkt._nbytes
            if left > 0:
                ti[tkt.tenant] = left
            else:
                ti.pop(tkt.tenant, None)

    # ---------------- closed-loop control ----------------

    def _control_window_locked(self) -> dict:
        """The deterministic half of one telemetry window (called with
        the cv held): batch/pressure counters, per-lane backlog, and
        the scp head-of-line SEQUENCE age — the clock-free latency
        proxy (how many submissions were admitted after the oldest
        queued scp submission)."""
        scp_head = self._queues["scp"].oldest_seq()
        lanes = {ln: {
            "queued_submissions": len(self._queues[ln]),
            "queued_items": self._queued_items[ln],
        } for ln in LANES}
        return {
            "batches": self._batches,
            "pressure": self._pressure,
            # the controller reasons about the BULK admission depth
            # (its highwater knob keys off it); per-lane dicts stay
            # a service-local sizing detail
            "lane_depth": self._depth_of("bulk"),
            "scp_hol_age": (self._seq - scp_head)
            if scp_head is not None else 0,
            "lanes": lanes,
            "knobs": {"max_batch": self._max_batch,
                      "pipeline_depth": self._pipeline_depth,
                      "shed_highwater_frac":
                          self._shed_highwater_frac},
        }

    def _apply_control_locked(self, knobs: dict) -> None:
        """THE knob application point (called with the cv held): the
        controller's clamped values become the scheduling knobs the
        next collect/pressure pass reads — one consistent set, never
        a half-applied mix."""
        self._max_batch = max(1, int(knobs["max_batch"]))
        self._pipeline_depth = max(1, int(knobs["pipeline_depth"]))
        self._shed_highwater_frac = min(1.0, max(
            0.01, float(knobs["shed_highwater_frac"])))

    def _maybe_control(self) -> None:
        """One controller step when the batch cadence is due: assemble
        the window (deterministic half under the cv, advisory burn/
        bubble half outside it), step the controller, apply any moved
        knobs under the cv, and emit each move as a ``service.control``
        flight-recorder event carrying the full window."""
        ctl = self._controller
        if ctl is None:
            return
        with self._cv:
            if self._batches < self._control_next:
                return
            self._control_next = self._batches + self._control_every
            window = self._control_window_locked()
        _control_advisories(window)
        decisions = ctl.step(window)
        knobs = ctl.knobs()
        with self._cv:
            self._apply_control_locked(knobs)
        if decisions:
            registry.meter("crypto.verify.control.decisions").mark(
                len(decisions))
            batch_verifier.note_trace_event(
                "service.control", window=window,
                decisions=decisions)
        registry.gauge("crypto.verify.control.max_batch").set(
            knobs["max_batch"])
        registry.gauge("crypto.verify.control.pipeline_depth").set(
            knobs["pipeline_depth"])
        registry.gauge(
            "crypto.verify.control.shed_highwater_frac").set(
            knobs["shed_highwater_frac"])
        registry.gauge("crypto.verify.control.moves").set(ctl.moves)

    def _run(self) -> None:
        """Dispatcher entry: the loop body, wrapped so that EVERY
        client-visible ticket reaches a documented terminal even if
        the loop dies on an unexpected exception. On any exit — clean stop or crash — the finally block
        re-flags stop (so new submissions are rejected ``"stopped"``
        instead of queueing behind a dead dispatcher) and sheds the
        queued backlog (reason ``"stopped"``, counted + ticketed); a
        crash additionally fails every still-in-flight part's future
        with the error through the ordinary ``failed`` terminal. A
        clean drain makes both a no-op (queues and inflight are
        already empty), so the conservation law holds either way."""
        inflight: deque = deque()
        try:
            self._run_loop(inflight)
        except BaseException as err:
            while inflight:
                ln, parts, _resolver, tr = inflight.popleft()
                self._resolve_failed(ln, parts, err, traces=tr)
            raise
        finally:
            with self._cv:
                self._stop = True
                self._abort_queues_locked()

    def _run_loop(self, inflight: deque) -> None:
        # in-flight dispatches are LOCAL to the dispatcher thread (the
        # only thread that touches them); shared state stays under cv
        while True:
            onset = None
            batch = None
            stopping = False
            with self._cv:
                while True:
                    if self._stop and not self._drain:
                        self._abort_queues_locked()
                    o = self._shed_pass_locked()
                    onset = onset or o
                    batch = self._collect_locked()
                    stopping = self._stop
                    if batch is not None or inflight or stopping:
                        break
                    self._cv.wait(0.05)
            if onset:
                batch_verifier.note_shed_onset(onset)
            if batch is not None:
                ln, items, parts, tids, decisions = batch
                tenants = _part_tenants(parts)
                # every weighted-fair pop is a flight-recorder event
                # with its input window: tenant, virtual
                # times, lane vtime, candidate count, trace range —
                # the replay-testable record of the decision
                for dec in decisions:
                    batch_verifier.note_trace_event(
                        "service.schedule", lane=ln, **dec)
                tr = batch_verifier.trace_ranges(tids)
                batch_verifier.note_trace_event(
                    "service.coalesce", lane=ln, tenants=tenants,
                    traces=tr, items=len(items), tickets=len(parts))
                resolver = None
                err: Optional[BaseException] = None
                # the batch's trace-ID list rides the dispatch span as
                # exemplar ranges (compressed, exact — never truncated)
                with span("service.dispatch", lane=ln,
                          tenants=tenants, items=len(items),
                          traces=tr):
                    try:
                        if self._traceful:
                            resolver = self._verifier.submit(
                                items, trace_ids=tids)
                        else:
                            resolver = self._verifier.submit(items)
                    except BaseException as e:
                        err = e
                if err is not None:
                    self._resolve_failed(ln, parts, err, traces=tr)
                else:
                    inflight.append((ln, parts, resolver, tr))
                # closed-loop control rides the batch cadence
                # (event-count, never a timer) — evaluated after the
                # dispatch so the window sees this batch's backlog
                # drain
                self._maybe_control()
            if inflight and (batch is None or
                             len(inflight) >= self._pipeline_depth):
                self._resolve_one(*inflight.popleft())
            if stopping and batch is None and not inflight:
                break

    def _resolve_failed(self, ln: str, parts, err: BaseException,
                        traces=None) -> None:
        """A failed dispatch or resolve: ticketed + counted as failed —
        the collect already moved the items in-flight."""
        n = sum(t.n_items for t, _ in parts)
        nbytes = sum(t._nbytes for t, _ in parts)
        with self._cv:
            self._inflight_items -= n
            self._inflight_bytes[ln] -= nbytes
            self._counts[ln]["failed"] += n
            self._tenant_terminal_locked(ln, parts, "failed")
            self._publish_lane_gauges_locked(ln)
        registry.meter("crypto.verify.service.failed").mark(n)
        registry.meter(
            f"crypto.verify.service.lane.{ln}.failed").mark(n)
        slo_monitor.note_completion(ln, ok=False, n=n)
        for tkt, _off in parts:
            tenant_mod.tenant_slo.note_completion(
                tkt.tenant, ok=False, n=tkt.n_items)
        batch_verifier.note_trace_event(
            "service.verdict", lane=ln, failed=True,
            tenants=_part_tenants(parts), traces=traces or [],
            items=n)
        for tkt, _off in parts:
            tkt._fut.set_exception(err)


def _part_tenants(parts) -> list:
    """Unique tenants of a coalesced batch, in part order — the
    ``tenants`` attribute of coalesce/dispatch/verdict records, so a
    batch's queue wait is attributable to its principals from the
    admin routes alone."""
    seen: list = []
    for tkt, _off in parts:
        if tkt.tenant not in seen:
            seen.append(tkt.tenant)
    return seen


def _control_advisories(window: dict) -> None:
    """Merge the advisory half of a control window in place: per-lane
    SLO burn rates (latency + completion, from the process-wide
    monitor) and queue-wait bubble dominance from the pipeline
    timeline. These are REPORTED numbers — the controller itself
    reads no clock; replaying the logged windows reproduces the
    trajectory whatever these advisories were."""
    slo = slo_monitor.snapshot()
    for ln, objs in slo.get("lanes", {}).items():
        lane = window["lanes"].setdefault(ln, {})
        lane["latency_burn"] = objs["latency"]["burn_rate"]
        lane["shed_burn"] = objs["completion"]["burn_rate"]
    from stellar_tpu_torch.utils.timeline import pipeline_timeline
    bub = pipeline_timeline.totals().get("bubble_ms") or {}
    total = sum(bub.values())
    window["queue_wait_frac"] = round(
        bub.get("queue_wait", 0.0) / total, 4) if total else 0.0


def lane_latencies() -> Dict[str, dict]:
    """Per-lane wait-time histogram summaries (count/p50/p90/p99/sum)
    — what the smoke run's service phase prints."""
    out = {}
    for ln in LANES:
        t = registry.timer(f"crypto.verify.service.lane.{ln}.wait_ms")
        p50, p90, p99 = t.percentiles_ms((50, 90, 99))
        out[ln] = {"count": t.count, "p50_ms": round(p50, 3),
                   "p90_ms": round(p90, 3), "p99_ms": round(p99, 3),
                   "sum_ms": round(t.sum_ms(), 3)}
    return out


# ---------------- process-wide service ----------------

_service: Optional[VerifyService] = None
_service_lock = threading.Lock()
# tenant_snapshot / control_snapshot of the process-wide service, else
# the last-started instance (set under _service_lock in
# VerifyService.start)
_tenant_provider = None
_control_provider = None


def default_service(start: bool = True) -> VerifyService:
    """Process-wide resident service over the default verifier
    (created on first call; a node starts it when its Config enables
    the service)."""
    global _service
    with _service_lock:
        if _service is None:
            _service = VerifyService()
        svc = _service
    if start:
        svc.start()
    return svc


def running_service() -> Optional[VerifyService]:
    """The process-wide service IF it exists and is accepting work,
    else ``None`` — the adoption check for call sites (herder SCP
    envelopes, overlay pre-verify) that ride the priority lanes when
    the node's Config started the service but must keep
    their direct path otherwise. Never creates or starts a service
    as a side effect (that is :func:`default_service`'s job)."""
    with _service_lock:
        svc = _service
    if svc is None:
        return None
    with svc._cv:
        if svc._running and not svc._stop:
            return svc
    return None


# Wedged-dispatcher cool-down for the lane adopters: one result
# timeout (the hung-fetch signature — Overloaded fast-fails and never
# arms this) opens a bypass window so subsequent cache misses degrade
# to the direct path INSTANTLY instead of each serially paying the
# full wait — without it, a wedged dispatcher costs every cache-miss
# crank/handshake/close ``timeout`` seconds until the lane queue
# fills (depth x timeout of serial stalls), not the "degrade in one
# timeout" the adopters advertise.
ADOPTER_COOLDOWN_S = 30.0
_adopter_cooldown_until = 0.0


def _adopter_fallback(lane: str, reason: str, n: int) -> None:
    """Every ``service_verified`` fallback is counted, per lane and
    reason — a fleet silently riding the direct path (service absent,
    wedged, or throwing on a bad call) must be distinguishable from
    one riding the lanes, from metrics alone."""
    registry.meter("crypto.verify.service.adopter_fallback").mark(n)
    registry.meter(
        f"crypto.verify.service.adopter_fallback.{lane}.{reason}"
    ).mark(n)


def service_verified(items: Sequence[tuple], lane: str,
                     timeout: float = 10.0,
                     tenant: Optional[str] = None) -> Optional[list]:
    """One cache-seeding service round trip for the signature hot
    paths (herder SCP envelopes, peer auth certs, overlay tx-flood
    pre-verify — the three lane adopters share THIS block so their
    fallback/seeding semantics can never diverge): per-item bools via
    the resident service, with every verdict re-seeded into keys'
    ``verify_sig`` cache, or ``None`` when the service is absent or
    fails in ANY way — Overloaded at ingress, stop mid-call, dispatch
    failure, or the ``timeout`` expiring on an unresolved ticket. The
    wait is BOUNDED by default, and a result timeout additionally
    arms the :data:`ADOPTER_COOLDOWN_S` bypass window: a wedged
    dispatcher (a hung fetch) must degrade
    the caller to its direct path — once, not once per cache miss —
    and never park a consensus crank, a peer handshake, or a ledger
    close on a future that will not resolve. Every ``None`` is
    metered per lane+reason (``crypto.verify.service.
    adopter_fallback.*``). ``None`` means "you decide" — the direct
    path is bit-identical, so the service can only ever change
    latency, never validity. ``tenant`` attributes the round trip to
    a principal`` so real peers ride
    per-tenant quotas once ``TENANT_FROM_PEER`` is on; None —
    the default — keeps the quota-exempt un-tenanted stream)."""
    global _adopter_cooldown_until
    n = len(items)
    # clock read: cool-down bypass decides only WHICH bit-identical
    # path serves (service lane vs direct verify), never a verdict
    # (nondet allowlist)
    with _service_lock:
        cooling = time.monotonic() < _adopter_cooldown_until
    if cooling:
        _adopter_fallback(lane, "cooldown", n)
        return None
    svc = running_service()
    if svc is None:
        _adopter_fallback(lane, "absent", n)
        return None
    try:
        # the un-tenanted call keeps the legacy shape, so duck-typed
        # service stand-ins (tests, embedders) without a tenant
        # parameter keep working until they opt into tenancy
        if tenant is None:
            ok = svc.verify(items, lane=lane, timeout=timeout)
        else:
            ok = svc.verify(items, lane=lane, timeout=timeout,
                            tenant=tenant)
    except (FuturesTimeout, TimeoutError):
        with _service_lock:
            _adopter_cooldown_until = (time.monotonic()
                                       + ADOPTER_COOLDOWN_S)
        _adopter_fallback(lane, "timeout", n)
        return None
    except Overloaded:
        _adopter_fallback(lane, "overloaded", n)
        return None
    except Exception:
        # programming errors degrade too (the direct path is the safe,
        # bit-identical choice for peer auth / consensus cranks) — but
        # never silently: the "error" meter is the tripwire
        _adopter_fallback(lane, "error", n)
        return None
    from stellar_tpu_torch.crypto.keys import seed_verify_cache
    out = [bool(o) for o in ok]
    seed_verify_cache([(pk, msg, sig, o)
                       for (pk, msg, sig), o in zip(items, out)])
    return out


def service_health() -> dict:
    """The ``service`` admin-route payload: the process-wide service's
    snapshot; falls back to whichever service instance last registered
    with the dispatch layer (a node embedding its own instance still
    gets an admin surface), else ``{"running": False}``."""
    with _service_lock:
        svc = _service
    if svc is not None:
        return svc.snapshot()
    return batch_verifier.service_health_snapshot()


def control_health() -> dict:
    """The ``control`` admin-route payload: the closed-loop
    controller's knob/clamp/hysteresis state, the live values the
    service applies, and the tail of the trajectory log. Served
    directly — the controller matters exactly when the node is under
    load (same policy as ``slo``/``tenant``)."""
    with _service_lock:
        svc = _service
        provider = _control_provider
    if svc is not None:
        provider = svc.control_snapshot
    if provider is None:
        return {"enabled": False}
    return provider()


def tenant_health() -> dict:
    """The ``tenant`` admin-route payload: per-tenant SLO
    burn rates (top-K + rollup, refreshing the rank-keyed gauges) and
    the process-wide service's per-tenant conservation counters.
    Served directly — tenant isolation matters exactly when the node
    is overloaded."""
    out = {"slo": tenant_mod.tenant_slo.snapshot()}
    with _service_lock:
        svc = _service
        provider = _tenant_provider
    if svc is not None:
        provider = svc.tenant_snapshot
    out["service"] = provider() if provider is not None else {
        "tenants": {}, "tracked": 0, "conservation_violations": {},
        "decision_log_len": 0}
    return out
