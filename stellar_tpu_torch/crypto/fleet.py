"""Replicated verify fleet: N active-active
:class:`~stellar_tpu_torch.crypto.verify_service.VerifyService` replicas
behind a deterministic front-end router — the port's copy of
``stellar_tpu/crypto/fleet.py``.

Every scheduling, shed and control decision of a service is a pure
function of event-count state, identical across replicas fed the same
arrivals. The fleet spends that determinism:

**Routing** is rendezvous (highest-random-weight) hashing over the
``(lane, tenant)`` key with the same content-seeded SHA-256 draw as
:func:`stellar_tpu_torch.crypto.audit.keep_under_shed`: a candidate
replica ``i`` scores the first 8 little-endian bytes of
``sha256(len(key) || key || i)``, the highest score wins (ties to the
smaller index). No clock, no RNG: two routers built apart and given the
same submission stream route alike, and a replica's loss moves only that
replica's keys (re-hashed across the survivors); its return moves them
back exactly.

**Conservation** lifts the service's per-lane law to the fleet:

    fleet submitted == sum over replicas of (verified + rejected + shed
                       + failed + pending) + router_refused

with a residual of exactly 0 at all times (``snapshot()
["conservation_gap"]`` and ``dispatch_health()["fleet"]``). A drained
replica's queued items move to its ``handoff`` terminal, left out of the
sum above and counted once more at the survivor that re-admits them, so
the law holds through a kill (``router_refused`` counts the items the
router itself refused because no replica was admissible).

**Divergence conviction** lifts the engine's sampled audit (a corrupting
device is convicted from evidence, never trusted) from device to replica:
the router keeps a bounded ledger a replica of what it submitted
(``seq -> (lane, tenant)``) and, every ``DIVERGENCE_EVERY`` routes,
re-reads each live replica's bounded ``decision_log()`` and
``control_log()`` and checks every retained tuple against the ledger and
the tuples' own invariants (shape, kind, lane, replica stamp, integer
domains). An honest replica can never fail the check, since its log comes
from the code path that fed the ledger; a corrupted one is convicted from
its own log, its :class:`~stellar_tpu_torch.utils.resilience.
CircuitBreaker` trips, and its key range re-hashes across the survivors.
It comes back on probation after ``PROBATION`` further routes (an event
count, not a clock) and is promoted to ``active`` by surviving the next
divergence check.

**Drain and handoff** (:meth:`FleetRouter.kill_replica`): a replica can be
killed mid-run with no ticket lost. Its queued submissions are extracted
(:meth:`VerifyService.drain_handoff`), re-submitted through the router to
the survivors with their original trace IDs (``submit(trace_lo=...)``),
and each original ticket's future is chained to its re-submission, so
callers never see the move. In-flight work finishes during the drain
stop. A survivor's refusal is a typed :class:`Overloaded` naming the
refusing replica.

**Options.** The reference's ``VERIFY_FLEET_*`` environment options are
module constants here with the reference's defaults, set through
:func:`configure_fleet` or the constructor; no environment is read.

:func:`default_fleet` starts its replicas over one
:class:`SharedVerifier` of :func:`stellar_tpu_torch.crypto.batch_verifier.
default_verifier`, so the fleet runs on the card. The router reads no
clock and draws no random number; the per-replica breakers keep their
own clocks inside :mod:`~stellar_tpu_torch.utils.resilience`, a health
and metric surface only, never a routing input.
"""

from __future__ import annotations

import hashlib
import inspect
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

from stellar_tpu_torch.crypto import batch_verifier
from stellar_tpu_torch.crypto import tenant as tenant_mod
from stellar_tpu_torch.crypto import verify_service as vs_mod
from stellar_tpu_torch.utils import resilience
from stellar_tpu_torch.utils.metrics import registry

__all__ = ["FleetRouter", "SharedVerifier", "Overloaded",
           "configure_fleet", "default_fleet", "running_fleet",
           "fleet_health", "route_key", "route_score"]

# re-export: the typed admission verdict (same policy as
# verify_service — callers catch one type at every boundary)
Overloaded = resilience.Overloaded


# ---------------- knob defaults (the reference's; configure_fleet) -----

FLEET_ENABLED = False
FLEET_REPLICAS = 3
# divergence-audit cadence: one full log re-check every N router
# submissions (event-count, never a timer)
DIVERGENCE_EVERY = 64
# probation delay after a conviction, in ROUTES (event-count — a
# clock here would make two routers' candidate sets diverge)
PROBATION = 256
# per-replica submission-ledger cap (seq -> (lane, tenant)); evicted
# entries degrade the divergence check to structural-only for those
# seqs, never to silence
LEDGER = 8192
# metric-cardinality guard: per-replica gauge series only for the first
# N replicas, the rest fold into the reserved `~other` rollup
METRIC_REPLICAS = 8

_defaults_lock = threading.Lock()


def configure_fleet(enabled: Optional[bool] = None,
                    replicas: Optional[int] = None,
                    divergence_every: Optional[int] = None,
                    probation: Optional[int] = None,
                    ledger: Optional[int] = None,
                    metric_replicas: Optional[int] = None) -> None:
    """Set the fleet's knobs; None keeps the current value. Instances
    read them at construction, so set them before :func:`default_fleet`.
    """
    global FLEET_ENABLED, FLEET_REPLICAS, DIVERGENCE_EVERY, \
        PROBATION, LEDGER, METRIC_REPLICAS
    with _defaults_lock:
        if enabled is not None:
            FLEET_ENABLED = bool(enabled)
        if replicas is not None:
            FLEET_REPLICAS = max(1, int(replicas))
        if divergence_every is not None:
            DIVERGENCE_EVERY = max(1, int(divergence_every))
        if probation is not None:
            PROBATION = max(1, int(probation))
        if ledger is not None:
            LEDGER = max(16, int(ledger))
        if metric_replicas is not None:
            METRIC_REPLICAS = max(1, int(metric_replicas))


# ---------------- the deterministic draw ----------------

def route_key(lane: str, tenant: str) -> bytes:
    """Length-prefixed ``(lane, tenant)`` key material — the same
    ambiguity-free framing as :func:`audit.keep_under_shed`'s tenant
    mixing, so distinct (lane, tenant) pairs can never collide by
    concatenation."""
    lb, tb = lane.encode("utf-8"), tenant.encode("utf-8")
    return (len(lb).to_bytes(2, "little") + lb
            + len(tb).to_bytes(2, "little") + tb)


def route_score(key: bytes, replica: int) -> int:
    """Rendezvous score of one replica for one key: the first 8
    little-endian bytes of ``sha256(len(key) || key || replica)``.
    Pure content arithmetic — every router computes the same score."""
    material = (len(key).to_bytes(2, "little") + key
                + int(replica).to_bytes(8, "little"))
    return int.from_bytes(
        hashlib.sha256(material).digest()[:8], "little")


def _pick(candidates: Sequence[int], key: bytes) -> Optional[int]:
    """Highest rendezvous score among ``candidates`` (ties break to
    the smaller index — candidates iterate ascending and only a
    strictly greater score displaces the incumbent)."""
    best, best_score = None, -1
    for i in candidates:
        s = route_score(key, i)
        if s > best_score:
            best, best_score = i, s
    return best


# ---------------- shared-engine adapter ----------------

class SharedVerifier:
    """Serialize ``submit`` calls of N replica dispatcher threads on
    ONE underlying engine. :class:`~stellar_tpu_torch.crypto.batch_verifier.
    BatchVerifier.submit` mutates engine state (the signer-table partition, pinned
    buffers, ledger tokens) and is only ever entered by a single
    dispatcher in the one-service deployment; the fleet keeps that
    invariant with a lock. Resolvers are returned as-is — the resolve
    path guards its shared registries itself, so in-flight batches of
    different replicas still overlap on device."""

    def __init__(self, verifier):
        self._verifier = verifier
        self._lock = threading.Lock()
        # trace-ID propagation rides inner verifiers that accept it
        # (same duck-typing as VerifyService.start)
        try:
            self._traceful = "trace_ids" in inspect.signature(
                verifier.submit).parameters
        except (TypeError, ValueError):
            self._traceful = False

    def submit(self, items, trace_ids=None):
        with self._lock:
            if self._traceful:
                return self._verifier.submit(items,
                                             trace_ids=trace_ids)
            return self._verifier.submit(items)


def _chain_tickets(new_tkt, old_tkt) -> None:
    """Complete a handed-off ticket's future from its re-submission:
    result, shed/reject Overloaded, or the batch's own failure — the
    original caller sees exactly what a direct submitter would."""
    def _done(f):
        e = f.exception()
        if e is not None:
            old_tkt._fut.set_exception(e)
        else:
            old_tkt._fut.set_result(f.result())
    new_tkt._fut.add_done_callback(_done)


# replica lifecycle states. active/probation are routable;
# quarantined is convicted and waiting out its event-count probation;
# dead is drained and stopped (kill_replica), never routable again.
_ROUTABLE = ("active", "probation")


class FleetRouter:
    """The active-active fleet front end (module docstring). Built
    either over explicit ``services`` (tests; each is stamped with its
    replica index) or lazily at :meth:`start` as
    ``replicas`` fresh :class:`VerifyService` instances sharing one
    engine through :class:`SharedVerifier`."""

    def __init__(self, services: Optional[Sequence] = None,
                 verifier=None,
                 replicas: Optional[int] = None,
                 divergence_every: Optional[int] = None,
                 probation: Optional[int] = None,
                 ledger: Optional[int] = None,
                 metric_replicas: Optional[int] = None):
        self._lock = threading.Lock()
        self._verifier = verifier
        self._n = FLEET_REPLICAS if replicas is None \
            else max(1, int(replicas))
        self._divergence_every = DIVERGENCE_EVERY \
            if divergence_every is None else max(1, int(divergence_every))
        self._probation = PROBATION if probation is None \
            else max(1, int(probation))
        self._ledger_cap = LEDGER if ledger is None \
            else max(16, int(ledger))
        self._metric_replicas = METRIC_REPLICAS \
            if metric_replicas is None else max(1, int(metric_replicas))
        self._replicas: List[dict] = []
        self._ledgers: List[Dict[int, tuple]] = []
        if services is not None:
            self._adopt_locked(list(services))
        # fleet-level conservation & evidence counters — all
        # event-count state, mutated only under self._lock
        self._routes = 0
        self._submitted = 0
        self._router_refused = 0
        self._handoffs = 0
        self._divergence_checks = 0
        self._convictions = 0
        self._readmissions = 0
        self._conviction_log: List[dict] = []
        # the system journal's feed: one bounded, in-order
        # route/refusal log keyed by a monotone per-router seq —
        # :mod:`stellar_tpu_torch.utils.journal` merges it with the
        # replicas' feeds. Routing is a pure rendezvous draw, so two
        # routers fed the same stream produce bit-identical feeds;
        # the never-evicting totals keep the completeness law
        # checkable after the bounded row log wraps.
        self._route_log: deque = deque(maxlen=self._ledger_cap)
        self._route_seq = 0
        self._route_totals = {"routed": 0, "refused": 0,
                              "rerouted": 0}
        self._running = False

    # ---------------- construction helpers ----------------

    def _adopt_locked(self, services: list) -> None:
        """Wrap each service in its replica record; stamps the fleet
        identity into the service so its decision tuples and
        Overloaded refusals name it."""
        for i, svc in enumerate(services):
            svc.replica = i
            self._replicas.append({
                "service": svc,
                "state": "active",
                "breaker": resilience.CircuitBreaker(
                    name=f"fleet-replica-{i}", failure_threshold=1),
                "probation_due": 0,
                "convictions": 0,
                "routed_submissions": 0,
                "routed_items": 0,
            })
            self._ledgers.append({})

    # ---------------- public API ----------------

    def start(self) -> "FleetRouter":
        """Start every replica (idempotent), register the fleet
        health surface with ``dispatch_health()``."""
        with self._lock:
            if not self._running:
                if not self._replicas:
                    v = self._verifier if self._verifier is not None \
                        else batch_verifier.default_verifier()
                    shared = SharedVerifier(v)
                    self._adopt_locked([
                        vs_mod.VerifyService(verifier=shared)
                        for _ in range(self._n)])
                for rep in self._replicas:
                    rep["service"].start()
                self._running = True
        batch_verifier.register_fleet_health(self.snapshot)
        global _fleet
        with _fleet_lock:
            # the fleet route serves the last-started instance (same
            # policy as register_service_health)
            _fleet = self
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop every still-live replica (``drain`` semantics as
        :meth:`VerifyService.stop`)."""
        with self._lock:
            if not self._running:
                return
            self._running = False
            services = [rep["service"] for rep in self._replicas
                        if rep["state"] != "dead"]
        for svc in services:
            svc.stop(drain=drain, timeout=timeout)

    def route_of(self, lane: str = "bulk",
                 tenant: Optional[str] = None) -> Optional[int]:
        """Which replica WOULD serve ``(lane, tenant)`` right now —
        a pure read (no counters move, no probation re-admission),
        the surface compared across routers built apart. None = no routable
        replica."""
        if lane not in vs_mod.LANES:
            raise ValueError(
                f"unknown lane {lane!r} (one of {vs_mod.LANES})")
        tenant = tenant_mod.validate_tenant(tenant)
        with self._lock:
            cands = [i for i, rep in enumerate(self._replicas)
                     if rep["state"] in _ROUTABLE]
        return _pick(cands, route_key(lane, tenant))

    def submit(self, items: Sequence[tuple], lane: str = "bulk",
               tenant: Optional[str] = None,
               trace_lo: Optional[int] = None):
        """Route one submission to its replica and admit it there.
        Raises :class:`Overloaded` exactly as the service would (the
        exception's ``replica`` field names the refusing replica), or
        with ``reason="fleet-quarantined"`` / ``replica=None`` when
        no replica is routable at all. Returns the replica's
        :class:`VerifyTicket`.

        ``trace_lo`` is the wire ingress's pass-through: the
        ingress server allocates the trace block when the frame
        arrives, so the ``trace?id=`` timeline starts on the wire and
        the block survives routing AND any later handoff re-route
        (``_resubmit_locked`` already preserved it). None = the
        router allocates the block itself, so the routing
        decision — emitted as a ``fleet.route`` recorder event with
        its rendezvous score BEFORE the replica's ``service.enqueue``
        — is part of the stitched timeline even for direct fleet
        submissions, and a total refusal still names its traces."""
        if lane not in vs_mod.LANES:
            raise ValueError(
                f"unknown lane {lane!r} (one of {vs_mod.LANES})")
        tenant = tenant_mod.validate_tenant(tenant)
        items = list(items)
        n = len(items)
        if trace_lo is None:
            trace_lo = vs_mod._alloc_trace_block(n)
        trange = [[trace_lo, trace_lo + n]] if n else []
        with self._lock:
            if not self._running:
                raise Overloaded(
                    "verify fleet is stopped", kind="rejected",
                    lane=lane, reason="stopped", tenant=tenant,
                    trace_ids=range(trace_lo, trace_lo + n))
            self._routes += 1
            self._submitted += n
            idx = self._route_locked(lane, tenant)
            due = self._routes % self._divergence_every == 0
            if idx is None:
                # every replica convicted/dead: refuse typed — these
                # items reached no replica's counters, so they carry
                # their own conservation terminal (and their trace
                # block: the refusal IS the stitched terminal)
                self._router_refused += n
                registry.meter(
                    "crypto.verify.fleet.router_refused").mark(n)
                self._journal_note_locked(
                    "refused", lane, tenant, None, trace_lo, n,
                    reason="fleet-quarantined")
                batch_verifier.note_trace_event(
                    "fleet.refuse", lane=lane, tenant=tenant,
                    reason="fleet-quarantined", traces=trange,
                    items=n)
                raise Overloaded(
                    "no routable fleet replica (all quarantined or "
                    "dead)", kind="rejected", lane=lane,
                    reason="fleet-quarantined", tenant=tenant,
                    trace_ids=range(trace_lo, trace_lo + n))
            rep = self._replicas[idx]
            rep["routed_submissions"] += 1
            rep["routed_items"] += n
            registry.meter("crypto.verify.fleet.routed").mark(n)
            # the routing decision precedes the replica's
            # service.enqueue/service.reject in the recorder, so the
            # stitched timeline reads wire -> route -> replica in
            # causal order (tracing.trace_timeline relies on it)
            self._journal_note_locked(
                "route", lane, tenant, idx, trace_lo, n,
                score=route_score(route_key(lane, tenant), idx))
            batch_verifier.note_trace_event(
                "fleet.route", lane=lane, tenant=tenant, replica=idx,
                score=route_score(route_key(lane, tenant), idx),
                route=self._routes, traces=trange, items=n)
            try:
                tkt = rep["service"].submit(items, lane=lane,
                                            tenant=tenant,
                                            trace_lo=trace_lo)
            finally:
                # the divergence audit runs on its cadence whether or
                # not this submission was admitted — the replica's
                # reject path writes counters too
                if due:
                    self._divergence_check_locked()
            self._ledger_record_locked(idx, tkt._seq, lane, tenant)
        return tkt

    def verify(self, items: Sequence[tuple], lane: str = "bulk",
               timeout: Optional[float] = None,
               tenant: Optional[str] = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(items, lane=lane,
                           tenant=tenant).result(timeout)

    def kill_replica(self, idx: int,
                     stop_timeout: Optional[float] = None) -> int:
        """The drain/handoff protocol: mark replica ``idx`` dead
        (its key range re-hashes across survivors immediately), move
        its queued submissions to its ``handoff`` terminal and
        re-submit each one through the router with its original trace
        block, chaining the old ticket's future to the new one — zero
        lost tickets, scp lane included. In-flight work finishes
        during the drain stop. Returns the number of handed-off
        items."""
        with self._lock:
            rep = self._replicas[idx]
            if rep["state"] == "dead":
                return 0
            rep["state"] = "dead"
            svc = rep["service"]
            moved = 0
            for tkt in svc.drain_handoff():
                moved += tkt.n_items
                self._handoffs += tkt.n_items
                self._resubmit_locked(tkt)
            if moved:
                registry.meter(
                    "crypto.verify.fleet.handoff").mark(moved)
        # the drain stop blocks on the dispatcher thread — outside
        # the router lock so routing continues while it drains
        svc.stop(drain=True, timeout=stop_timeout)
        return moved

    def convict(self, idx: int, evidence) -> None:
        """Manually convict a replica (operator escape hatch / test
        seam); the standing detector calls the same path."""
        with self._lock:
            self._convict_locked(idx, ("manual", evidence))

    def divergence_check(self) -> list:
        """Run one divergence audit now (the standing detector runs
        the same audit every ``divergence_every`` routes). Returns
        the list of ``(replica, evidence)`` convictions."""
        with self._lock:
            return self._divergence_check_locked()

    def snapshot(self) -> dict:
        """The ``dispatch_health()["fleet"]`` / :func:`fleet_health`
        payload: per-replica states and counters, the fleet
        conservation law (residual must read 0), conviction evidence,
        and the knobs. Publishes the fleet gauge set under the
        metric-cardinality guard as a side effect (same policy as the
        tenant top-k publisher)."""
        with self._lock:
            reps = []
            totals = {"submitted": 0, "verified": 0, "rejected": 0,
                      "shed": 0, "failed": 0, "handoff": 0}
            pending = 0
            for i, rep in enumerate(self._replicas):
                s = rep["service"].snapshot()
                t = s["totals"]
                for k in totals:
                    totals[k] += t[k]
                pending += s["pending_items"]
                reps.append({
                    "replica": i,
                    "state": rep["state"],
                    "breaker": rep["breaker"].state,
                    "routed_submissions": rep["routed_submissions"],
                    "routed_items": rep["routed_items"],
                    "convictions": rep["convictions"],
                    "probation_due": (rep["probation_due"]
                                      if rep["state"] == "quarantined"
                                      else None),
                    "running": s["running"],
                    "pending_items": s["pending_items"],
                    "totals": t,
                    "conservation_gap": s["conservation_gap"],
                })
            gap = (self._submitted - totals["verified"]
                   - totals["rejected"] - totals["shed"]
                   - totals["failed"] - pending
                   - self._router_refused)
            snap = {
                "enabled": True,
                "running": self._running,
                "replicas": len(self._replicas),
                "active": sum(1 for rep in self._replicas
                              if rep["state"] in _ROUTABLE),
                "states": [rep["state"] for rep in self._replicas],
                "routes": self._routes,
                "submitted": self._submitted,
                "router_refused": self._router_refused,
                "handoffs": self._handoffs,
                "divergence_checks": self._divergence_checks,
                "divergence_convictions": self._convictions,
                "readmissions": self._readmissions,
                "conviction_log": list(self._conviction_log),
                "route_totals": dict(self._route_totals),
                "pending_items": pending,
                "totals": totals,
                "conservation_gap": gap,
                "per_replica": reps,
                "knobs": {
                    "divergence_every": self._divergence_every,
                    "probation": self._probation,
                    "ledger": self._ledger_cap,
                    "metric_replicas": self._metric_replicas,
                },
            }
            self._publish_metrics_locked(snap)
        return snap

    # ---------------- router internals ----------------
    # _locked helpers are called with self._lock held (the repo-wide
    # naming contract).

    def _route_locked(self, lane: str, tenant: str) -> Optional[int]:
        """One routing decision: re-admit any replica whose
        event-count probation is due, then rendezvous-pick among the
        routable candidates."""
        for rep in self._replicas:
            if rep["state"] == "quarantined" and \
                    self._routes >= rep["probation_due"]:
                rep["state"] = "probation"
        cands = [i for i, rep in enumerate(self._replicas)
                 if rep["state"] in _ROUTABLE]
        return _pick(cands, route_key(lane, tenant))

    def _journal_note_locked(self, kind: str, lane: str, tenant,
                             replica, trace_lo, n: int,
                             **extra) -> None:
        """Append one row to the router's journal feed (called with
        the router lock held). Rows are pure functions of the
        submission stream and the rendezvous draw — no clock reads —
        so two routers fed identical streams produce bit-identical
        feeds. The totals obey one exact law the completeness check
        reads: ``routed + rerouted + refused == submitted +
        handoffs`` (every submission routes or refuses; every
        drained ticket re-routes or refuses)."""
        row = {"seq": self._route_seq, "kind": kind, "lane": lane,
               "tenant": tenant, "replica": replica,
               "trace_lo": trace_lo, "n": n}
        if extra:
            row.update(extra)
        self._route_seq += 1
        self._route_log.append(row)
        tot = self._route_totals
        if kind == "route":
            tot["rerouted" if extra.get("handoff") else "routed"] \
                += n
        elif kind == "refused":
            tot["refused"] += n

    def route_log(self, limit: int = 0) -> list:
        """The bounded route/refusal journal feed: one
        dict row per routing decision (``route``, with the rendezvous
        score and ``handoff=True`` on a re-route) and per total
        refusal (``refused``), each naming the trace block it covers.
        ``limit`` bounds the tail returned (0 = all retained)."""
        with self._lock:
            log = [dict(r) for r in self._route_log]
        return log[-limit:] if limit else log

    def route_totals(self) -> dict:
        """Never-evicting aggregates behind the route feed — the
        fleet half of the journal completeness law (see
        :func:`stellar_tpu_torch.utils.journal.completeness`)."""
        with self._lock:
            return dict(self._route_totals)

    def services(self) -> list:
        """The replica services, in replica order — the journal
        collector walks them for their per-replica feeds;
        dead replicas stay listed (their journal history is exactly
        what a post-mortem needs)."""
        with self._lock:
            return [rep["service"] for rep in self._replicas]

    def _ledger_record_locked(self, idx: int, seq: int, lane: str,
                              tenant: str) -> None:
        led = self._ledgers[idx]
        led[seq] = (lane, tenant)
        while len(led) > self._ledger_cap:
            # dict preserves insertion order: evict oldest seqs first
            del led[next(iter(led))]

    def _resubmit_locked(self, tkt) -> None:
        """Re-submit one drained ticket to a survivor with its
        original trace block and chain its future. A survivor's
        refusal (or no survivor at all) lands on the original future
        as a typed Overloaded — never silence."""
        idx = self._route_locked(tkt.lane, tkt.tenant)
        if idx is None:
            self._router_refused += tkt.n_items
            registry.meter(
                "crypto.verify.fleet.router_refused"
            ).mark(tkt.n_items)
            self._journal_note_locked(
                "refused", tkt.lane, tkt.tenant, None, tkt.trace_lo,
                tkt.n_items, reason="fleet-quarantined",
                handoff=True)
            batch_verifier.note_trace_event(
                "fleet.refuse", lane=tkt.lane, tenant=tkt.tenant,
                reason="fleet-quarantined", handoff=True,
                traces=[[tkt.trace_lo, tkt.trace_lo + tkt.n_items]],
                items=tkt.n_items)
            tkt._fut.set_exception(Overloaded(
                "no routable fleet replica for handoff",
                kind="rejected", lane=tkt.lane,
                reason="fleet-quarantined", tenant=tkt.tenant,
                trace_ids=tkt.trace_ids))
            return
        rep = self._replicas[idx]
        # the handoff re-route is a first-class routing decision in
        # the stitched timeline: it lands BEFORE the
        # survivor's service.enqueue, so a re-homed trace reads
        # handoff -> route -> enqueue -> verdict with no seam
        self._journal_note_locked(
            "route", tkt.lane, tkt.tenant, idx, tkt.trace_lo,
            tkt.n_items,
            score=route_score(route_key(tkt.lane, tkt.tenant), idx),
            handoff=True)
        batch_verifier.note_trace_event(
            "fleet.route", lane=tkt.lane, tenant=tkt.tenant,
            replica=idx, handoff=True,
            score=route_score(route_key(tkt.lane, tkt.tenant), idx),
            route=self._routes,
            traces=[[tkt.trace_lo, tkt.trace_lo + tkt.n_items]],
            items=tkt.n_items)
        try:
            new = rep["service"].submit(tkt._items, lane=tkt.lane,
                                        tenant=tkt.tenant,
                                        trace_lo=tkt.trace_lo)
        except Overloaded as e:
            tkt._fut.set_exception(e)
            return
        rep["routed_submissions"] += 1
        rep["routed_items"] += tkt.n_items
        self._ledger_record_locked(idx, new._seq, tkt.lane,
                                   tkt.tenant)
        _chain_tickets(new, tkt)

    def _divergence_check_locked(self) -> list:
        """The standing integrity audit: validate every retained
        decision/control tuple of every routable replica against the
        router's ledger and the tuples' own invariants. Convictions
        quarantine; a probation replica that survives is promoted
        back to active."""
        self._divergence_checks += 1
        convicted = []
        for i, rep in enumerate(self._replicas):
            if rep["state"] not in _ROUTABLE:
                continue
            ev = _audit_log(rep["service"], i, self._ledgers[i])
            if ev is not None:
                self._convict_locked(i, ev)
                convicted.append((i, ev))
            elif rep["state"] == "probation":
                rep["state"] = "active"
                rep["breaker"].record_success()
                self._readmissions += 1
                registry.counter(
                    "crypto.verify.fleet.readmissions").inc()
        registry.counter("crypto.verify.fleet.divergence_checks").inc()
        return convicted

    def _convict_locked(self, idx: int, evidence: tuple) -> None:
        """Quarantine one replica on log evidence: hard-trip its
        breaker (the device_health discipline — an integrity
        violation gets no more chances), pull it from the candidate
        set (its keys re-hash to survivors on the very next route)
        and schedule event-count probation."""
        rep = self._replicas[idx]
        rep["state"] = "quarantined"
        rep["convictions"] += 1
        rep["probation_due"] = self._routes + self._probation
        rep["breaker"].trip()
        self._convictions += 1
        self._conviction_log.append({
            # monotone conviction seq: the journal merge
            # keys fleet conviction events by it
            "seq": self._convictions,
            "replica": idx,
            "at_route": self._routes,
            "probation_due": rep["probation_due"],
            "evidence": [repr(x) for x in evidence],
        })
        del self._conviction_log[:-32]
        registry.counter("crypto.verify.fleet.convictions").inc()
        batch_verifier.note_trace_event(
            "fleet.convict", replica=idx, reason=str(evidence[0]),
            at_route=self._routes)

    def _publish_metrics_locked(self, snap: dict) -> None:
        """Fleet gauge set under the metric-cardinality guard:
        per-replica series only for indices below the cap, the rest
        summed into the reserved ``~other`` rollup."""
        g = registry.gauge
        g("crypto.verify.fleet.replicas").set(snap["replicas"])
        g("crypto.verify.fleet.active").set(snap["active"])
        g("crypto.verify.fleet.pending_items").set(
            snap["pending_items"])
        g("crypto.verify.fleet.conservation_gap").set(
            snap["conservation_gap"])
        other = {"routed_items": 0, "verified": 0, "pending": 0,
                 "quarantined": 0}
        overflow = False
        for r in snap["per_replica"]:
            vals = {
                "routed_items": r["routed_items"],
                "verified": r["totals"]["verified"],
                "pending": r["pending_items"],
                "quarantined": 0 if r["state"] in _ROUTABLE else 1,
            }
            if r["replica"] < self._metric_replicas:
                for k, v in vals.items():
                    g(f"crypto.verify.fleet.replica."
                      f"{r['replica']}.{k}").set(v)
            else:
                overflow = True
                for k in other:
                    other[k] += vals[k]
        if overflow:
            for k, v in other.items():
                g(f"crypto.verify.fleet.replica.~other.{k}").set(v)


def _audit_log(svc, idx: int, ledger: Dict[int, tuple]):
    """Validate one replica's retained logs; returns None (clean) or
    the evidence tuple that convicts — always including the offending
    tuple itself (conviction from evidence, as the engine's audit).
    Checks are invariants of the HONEST code path, so an honest
    replica can never fail one:

    * decision tuples are ``(kind, lane, tenant, seq, aux, replica)``
      with ``kind`` in dispatch/shed, a real lane, a str tenant,
      non-negative int seq/aux, and the replica stamp equal to the
      fleet identity;
    * any seq still in the router's ledger must carry the lane and
      tenant the router submitted under (evicted seqs degrade to the
      structural check, never to silence);
    * control tuples are ``(action, seq, max_batch, pipeline_depth,
      highwater_milli, reason)`` with a known action and int/str
      domains."""
    for d in svc.decision_log():
        if not isinstance(d, tuple) or len(d) != 6:
            return ("malformed-decision", d)
        kind, ln, tenant, seq, aux, replica = d
        if kind not in ("dispatch", "shed"):
            return ("bad-decision-kind", d)
        if ln not in vs_mod.LANES:
            return ("bad-decision-lane", d)
        if not isinstance(tenant, str):
            return ("bad-decision-tenant", d)
        if not isinstance(seq, int) or isinstance(seq, bool) \
                or seq < 0:
            return ("bad-decision-seq", d)
        if not isinstance(aux, int) or isinstance(aux, bool) \
                or aux < 0:
            return ("bad-decision-aux", d)
        if replica != idx:
            return ("bad-decision-replica", d)
        want = ledger.get(seq)
        if want is not None and (ln, tenant) != want:
            return ("ledger-mismatch", d, want)
    for c in svc.control_log():
        if not isinstance(c, tuple) or len(c) != 6:
            return ("malformed-control", c)
        action, seq, mb, pd, hw, reason = c
        if action not in ("grow", "shrink", "relax", "hold"):
            return ("bad-control-action", c)
        for v in (seq, mb, pd, hw):
            if not isinstance(v, int) or isinstance(v, bool):
                return ("bad-control-int", c)
        if not isinstance(reason, str):
            return ("bad-control-reason", c)
    return None


# ---------------- process-wide default ----------------

_fleet: Optional[FleetRouter] = None
_fleet_lock = threading.Lock()


def default_fleet() -> FleetRouter:
    """Get-or-start the process-wide fleet (a node calls this when
    ``FLEET_ENABLED``): replicas over one :class:`SharedVerifier` of
    :func:`~stellar_tpu_torch.crypto.batch_verifier.default_verifier`."""
    global _fleet
    with _fleet_lock:
        if _fleet is None:
            _fleet = FleetRouter()
        f = _fleet
    return f.start()


def running_fleet() -> Optional[FleetRouter]:
    """The current fleet instance, or None — never constructs."""
    with _fleet_lock:
        return _fleet


def fleet_health() -> dict:
    """The current fleet's snapshot, or ``{"enabled": False}`` (served
    directly — replica health matters exactly when the node is
    struggling)."""
    with _fleet_lock:
        f = _fleet
    if f is None:
        return {"enabled": False}
    return f.snapshot()
