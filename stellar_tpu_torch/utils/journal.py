"""The deterministic system journal — the port's copy of
``stellar_tpu/utils/journal.py``.

Every component of the verify plane keeps a bounded, clock-free log: the
service's scheduling and shed ``decision_log()`` and its admission and
terminal journal feed, the controller's knob trajectory, the fleet
router's route and refusal feed and conviction ledger, and the wire
ingress's conservation counters. Each is identical across replicas fed
the same input. This module merges them into one event stream:

**Event model.** Every row is a plain dict with a ``component`` name, a
per-component monotone ``seq``, a ``kind`` and, wherever the row concerns
admitted work, the trace block it covers (``trace_lo``/``n``), which
joins journal rows to the flight recorder's stitched trace timeline. The
merge key is ``(component, seq)``: within a component seq order is causal
order; across components the interleave is the deterministic
``(seq, component)`` merge, and the causality of one trace is recovered
through the trace IDs (the stitched timeline), never through clocks.

**Determinism classes.** Route feeds, replica feeds, decision logs,
control logs and conviction ledgers are deterministic: two replicas (or
two collections of one frozen system) produce identical rows, so
:func:`merge` refuses conflicting payloads under one key
(:class:`JournalDivergence`), and :func:`canonical_bytes` over the
deterministic sections is a fair equality surface. The ingress's wire
counters depend on socket timing, so they ride in the separate ``nondet``
section: reconciled by the completeness law, left out of the equality.

**Completeness law** (:func:`completeness`). At any snapshot the merged
journal must reconcile exactly with the conservation counters of every
layer: per replica, journal admissions equal counted admissions and every
terminal kind matches its counter; the fleet's route totals obey
``routed + rerouted + refused == submitted + handoffs``; the ingress's
wire residual is 0; and over the retained (unwrapped) window every
admitted trace ID reaches exactly one terminal — a handoff is a hop, not
a terminal, so a re-homed trace's second admission balances its handoff.
The returned ``gap`` is the sum of the absolute residuals and must read 0.

Everything here is a pure function of the logs it is handed: no clock,
no random number.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

__all__ = ["JournalDivergence", "canonical_bytes", "collect",
           "merge", "canonical", "completeness", "stitch_fraction"]


class JournalDivergence(Exception):
    """Two journals disagree about the SAME ``(component, seq)`` key
    (or the same deterministic totals) — the merge refuses to paper
    over it, exactly like the fleet's divergence conviction: a
    deterministic component that produced two different rows for one
    seq is evidence, not noise."""


def canonical_bytes(obj) -> bytes:
    """The bit-identity surface: canonical JSON (sorted keys, no
    whitespace, ASCII) — two equal journals canonicalize to equal
    bytes, byte for byte."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=True).encode("ascii")


# ---------------- collection ----------------

def _control_rows(svc) -> List[dict]:
    """Render a service's attached-controller log as journal rows —
    the window seq is already monotone and deterministic, so it keys
    the component directly."""
    return [
        {"seq": seq, "kind": "control", "action": action,
         "max_batch": mb, "pipeline_depth": pd,
         "highwater_milli": hw, "reason": reason}
        for action, seq, mb, pd, hw, reason in svc.control_log()]


def _decision_rows(svc) -> List[dict]:
    """Render the scheduling/shed decision log as journal rows. The
    tuples carry no per-row counter, so rows are keyed by their index
    in the retained window — stable for same-window collections
    (which is what merge compares); a wrapped log shifts the base,
    which :func:`completeness` detects via the replica feed."""
    rows = []
    for i, d in enumerate(svc.decision_log()):
        if d[0] == "dispatch":
            _k, lane, tenant, seq, vfinish, replica = d
            rows.append({"seq": i, "kind": "dispatch", "lane": lane,
                         "tenant": tenant, "ticket": seq,
                         "vfinish": vfinish, "replica": replica})
        else:
            _k, lane, tenant, seq, level, replica = d
            rows.append({"seq": i, "kind": "shed", "lane": lane,
                         "tenant": tenant, "ticket": seq,
                         "level": level, "replica": replica})
    return rows


def collect(fleet=None, services: Optional[Sequence] = None,
            ingress=None) -> dict:
    """Collect one journal snapshot from live components. Any subset
    may be present: a bare service window journals alone, a fleet
    brings its replicas (``services`` overrides), the wire ingress
    adds the nondeterministic wire totals. The result is a plain
    JSON-serializable dict, what :func:`merge` consumes."""
    comps: Dict[str, List[dict]] = {}
    totals: Dict[str, dict] = {}
    nondet: Dict[str, dict] = {}
    if fleet is not None:
        fsnap = fleet.snapshot()
        comps["fleet"] = fleet.route_log()
        comps["fleet.convictions"] = [
            {"seq": c.get("seq", i + 1), "kind": "convict",
             "replica": c["replica"], "at_route": c["at_route"],
             "probation_due": c["probation_due"],
             "evidence": list(c["evidence"])}
            for i, c in enumerate(fsnap["conviction_log"])]
        totals["fleet"] = {
            "submitted": fsnap["submitted"],
            "router_refused": fsnap["router_refused"],
            "handoffs": fsnap["handoffs"],
            "pending_items": fsnap["pending_items"],
            "conservation_gap": fsnap["conservation_gap"],
            "route_totals": dict(fsnap["route_totals"]),
        }
        if services is None:
            services = fleet.services()
    for i, svc in enumerate(services or []):
        name = svc.replica if svc.replica is not None else i
        comps[f"replica/{name}"] = svc.journal_log()
        comps[f"decisions/{name}"] = _decision_rows(svc)
        ctl = _control_rows(svc)
        if ctl:
            comps[f"control/{name}"] = ctl
        snap = svc.snapshot()
        totals[f"replica/{name}"] = {
            "journal": svc.journal_totals(),
            "counts": {k: int(v) for k, v in snap["totals"].items()},
            "pending_items": snap["pending_items"],
            "conservation_gap": snap["conservation_gap"],
        }
    if ingress is not None:
        nondet["ingress"] = ingress.journal_totals()
    return {"components": comps, "totals": totals, "nondet": nondet}


# ---------------- merge ----------------

def merge(*journals: dict) -> dict:
    """Merge N collected journals into one. Events are unioned under
    their ``(component, seq)`` key; the SAME key with a DIFFERENT
    payload raises :class:`JournalDivergence` (deterministic
    components cannot honestly disagree), as do conflicting
    deterministic totals. Nondeterministic sections are not
    equality-checked (wire counters move between scrapes); the last
    journal's view wins. The merged stream is ordered by
    ``(seq, component)`` — deterministic, and order-insensitive in
    the inputs: merging the same journals in any order yields
    bit-identical output."""
    events: Dict[tuple, tuple] = {}
    totals: Dict[str, dict] = {}
    nondet: Dict[str, dict] = {}
    for j in journals:
        for comp, rows in j.get("components", {}).items():
            for row in rows:
                key = (comp, row["seq"])
                payload = canonical_bytes(row)
                prior = events.get(key)
                if prior is not None and prior[0] != payload:
                    raise JournalDivergence(
                        f"component {comp!r} seq {row['seq']}: "
                        f"conflicting rows {prior[1]!r} != {row!r}")
                events[key] = (payload, row)
        for comp, tot in j.get("totals", {}).items():
            if comp in totals and totals[comp] != tot:
                raise JournalDivergence(
                    f"component {comp!r}: conflicting totals "
                    f"{totals[comp]!r} != {tot!r}")
            totals[comp] = tot
        nondet.update(j.get("nondet", {}))
    comps: Dict[str, List[dict]] = {}
    stream: List[dict] = []
    for comp, seq in sorted(events, key=lambda k: (k[1], k[0])):
        row = events[(comp, seq)][1]
        comps.setdefault(comp, []).append(row)
        stream.append(dict(row, component=comp))
    for rows in comps.values():
        rows.sort(key=lambda r: r["seq"])
    return {"components": comps, "events": stream, "totals": totals,
            "nondet": nondet}


def canonical(journal: dict) -> bytes:
    """Canonical bytes over the DETERMINISTIC sections only
    (components + totals): the surface two independently-merged
    journals must match bit for bit."""
    return canonical_bytes({
        "components": journal.get("components", {}),
        "totals": journal.get("totals", {})})


# ---------------- the completeness law ----------------

_TERMINALS = ("verified", "failed", "rejected", "shed", "handoff")


def _sweep(deltas: Dict[int, list]) -> List[tuple]:
    """Difference-array sweep over trace-ID range endpoints: yields
    ``(width, net_admits, terminals)`` per constant segment — O(rows)
    memory no matter how many trace IDs the window covers."""
    out = []
    admits = terms = 0
    prev = None
    for point in sorted(deltas):
        if prev is not None and point > prev and (admits or terms):
            out.append((point - prev, admits, terms))
        da, dt = deltas[point]
        admits += da
        terms += dt
        prev = point
    return out


def completeness(journal: dict, drained: bool = False) -> dict:
    """Check the journal completeness law against a merged (or
    single-collection) journal. Returns ``{"gap", "checks",
    "wrapped"}`` where ``gap`` is the sum of absolute residuals —
    exactly 0 on an honest system:

    - per replica: journal admissions + journal rejections equal the
      counted submissions; every terminal kind's journal total equals
      its conservation counter; journal pending (admitted minus
      terminals) equals the counted pending items; the replica's own
      conservation residual is 0.
    - fleet: ``routed + rerouted + refused == submitted + handoffs``
      and journal refusals equal ``router_refused``; the fleet
      conservation residual is 0. When replica feeds ride along, the
      cross-layer law ``Σ replica admissions+rejections == routed +
      rerouted`` holds (same sole-client assumption as the fleet
      conservation law itself).
    - ingress (nondet): the wire-extended residual recomputed from
      the totals is 0.
    - exactly-once terminals: over the retained window — skipped per
      component once its bounded log has wrapped (reported in
      ``wrapped``, never silently) — no trace ID carries more
      terminals than net admissions (enqueues minus handoff hops);
      with ``drained=True`` (no pending work) every admitted ID must
      carry EXACTLY one.
    """
    checks: Dict[str, int] = {}
    wrapped: List[str] = []
    totals = journal.get("totals", {})
    comps = journal.get("components", {})

    replica_admit = 0
    for comp, tot in totals.items():
        if not comp.startswith("replica/"):
            continue
        jt, counts = tot["journal"], tot["counts"]
        checks[f"{comp}.admit"] = (jt["submitted"] + jt["rejected"]
                                   - counts["submitted"])
        for k in _TERMINALS:
            checks[f"{comp}.{k}"] = jt[k] - counts.get(k, 0)
        checks[f"{comp}.pending"] = (
            jt["submitted"] - jt["verified"] - jt["failed"]
            - jt["shed"] - jt["handoff"] - tot["pending_items"])
        checks[f"{comp}.conservation"] = tot["conservation_gap"]
        replica_admit += jt["submitted"] + jt["rejected"]

    ftot = totals.get("fleet")
    if ftot is not None:
        rt = ftot["route_totals"]
        checks["fleet.route_law"] = (
            rt["routed"] + rt["rerouted"] + rt["refused"]
            - ftot["submitted"] - ftot["handoffs"])
        checks["fleet.refused"] = (rt["refused"]
                                   - ftot["router_refused"])
        checks["fleet.conservation"] = ftot["conservation_gap"]
        if any(c.startswith("replica/") for c in totals):
            checks["fleet.cross_admit"] = (
                replica_admit - rt["routed"] - rt["rerouted"])

    ing = journal.get("nondet", {}).get("ingress")
    if ing is not None:
        wire = (ing["frames_received"] - ing["decoded_frames"]
                - ing["malformed_frames"])
        admit = ing["items_decoded"] - ing["accepted"] - ing["refused"]
        term = (ing["accepted"] - ing["resolved"] - ing["shed"]
                - ing["failed"] - ing["pending"])
        checks["ingress.conservation"] = (abs(wire) + abs(admit)
                                          + abs(term))

    # exactly-once terminals over the retained (unwrapped) window
    deltas: Dict[int, list] = {}

    def add(lo, n, da, dt):
        if lo is None or not n:
            return
        deltas.setdefault(lo, [0, 0])
        deltas.setdefault(lo + n, [0, 0])
        deltas[lo][0] += da
        deltas[lo][1] += dt
        deltas[lo + n][0] -= da
        deltas[lo + n][1] -= dt

    window_ok = True
    for comp, rows in comps.items():
        feed = (comp == "fleet" or comp.startswith("replica/"))
        if not feed:
            continue
        if rows and rows[0]["seq"] != 0:
            wrapped.append(comp)
            window_ok = False
            continue
        for row in rows:
            kind = row["kind"]
            if comp == "fleet":
                if kind == "refused":
                    add(row["trace_lo"], row["n"], 1, 1)
            elif kind == "enqueue":
                add(row["trace_lo"], row["n"], 1, 0)
            elif kind == "handoff":
                add(row["trace_lo"], row["n"], -1, 0)
            elif kind in ("verified", "failed", "shed"):
                add(row["trace_lo"], row["n"], 0, 1)
    violations = 0
    if window_ok:
        for width, admits, terms in _sweep(deltas):
            if drained:
                violations += width * abs(terms - admits)
            else:
                violations += width * max(0, terms - admits)
        checks["traces.exactly_once"] = violations

    gap = sum(abs(v) for v in checks.values())
    return {"gap": gap, "checks": checks, "wrapped": wrapped}


# ---------------- trace stitching ----------------

def stitch_fraction(trace_ids: Sequence[int], recorder,
                    require: Sequence[str] = ("enqueue",
                                              "terminal")) -> float:
    """The fraction of ``trace_ids`` whose stitched timeline
    (``recorder.trace_timeline(id)["stitch"]``) contains every required
    segment (``wire`` / ``route`` / ``enqueue`` / ``terminal``) AND is
    seam-free (every handoff followed by a re-admission); callers pick
    ``require`` to match the window's shape (a bare service window has
    no wire or route segments to demand). ``recorder`` is passed in
    (``tracing.flight_recorder``) rather than imported: tracing reads
    clocks, and this module stays duration-blind."""
    ids = list(trace_ids)
    if not ids:
        return 1.0
    ok = 0
    for tid in ids:
        st = recorder.trace_timeline(tid).get("stitch", {})
        if not st.get("seamless", False):
            continue
        good = True
        for seg in require:
            if seg == "terminal":
                good = good and st.get("terminal") is not None
            else:
                good = good and bool(st.get(seg))
        ok += good
    return ok / len(ids)
