"""The port's system journal and trace stitch against the reference's, on
the CPU.

The same arrivals go through the reference's and the port's fleets: never
started (the dispatchers never run, so the replay is single-threaded) and
parked (started replicas whose dispatchers block on a closed gate at
pipeline depth 1 until every arrival is admitted, as in
``tests/test_torch_service.py``). ``canonical(merge(collect(...)))`` is
equal once trace IDs are rebased to each package's first, and ``merge``,
``completeness`` and ``stitch_fraction`` give equal results. The cases of
``tests/test_journal.py`` run on the port, and the stitch cases of
``tests/test_trace_propagation.py`` (a handoff that stitches across a
kill, the per-replica Chrome tracks) hold. Stub verifiers only: no JAX
program is compiled.
"""

import json
import threading
import time

import numpy as np
import pytest

from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.crypto import fleet as jfleet
from stellar_tpu.crypto import verify_service as jvs
from stellar_tpu.utils import journal as jjournal
from stellar_tpu.utils import tracing as jtracing
from stellar_tpu.utils.resilience import Overloaded as JOverloaded
from stellar_tpu_torch.crypto import batch_verifier as bv
from stellar_tpu_torch.crypto import fleet as fleet_mod
from stellar_tpu_torch.crypto import verify_service as vs
from stellar_tpu_torch.parallel import batch_engine as pbe
from stellar_tpu_torch.utils import journal, tracing
from stellar_tpu_torch.utils.resilience import Overloaded

PKGS = {"reference": (jfleet, jvs, jjournal, jtracing, JOverloaded),
        "port": (fleet_mod, vs, journal, tracing, Overloaded)}

KEY_GRID = [("bulk", None), ("bulk", "t0"), ("bulk", "t1"),
            ("scp", None), ("scp", "t2"), ("auth", None),
            ("bulk", "t3"), ("scp", "t4")]


@pytest.fixture(autouse=True)
def clean_state():
    for *_m, tr, _o in PKGS.values():
        tr.flight_recorder.clear()
    yield
    for *_m, tr, _o in PKGS.values():
        tr.flight_recorder.clear()
    jbv._reset_dispatch_state_for_testing()
    pbe._reset_dispatch_state_for_testing()
    for fl, _vs, _j, _t, _o in PKGS.values():
        with fl._fleet_lock:
            fl._fleet = None
    jbv.register_fleet_health(None)
    bv.register_fleet_health(None)


class _Instant:
    def submit(self, items, trace_ids=None):
        n = len(items)
        return lambda: np.ones(n, dtype=bool)


class _Slow:
    """Slow enough that a kill mid-stream finds queued work."""

    def submit(self, items, trace_ids=None):
        n = len(items)

        def resolve():
            time.sleep(0.02)
            return np.ones(n, dtype=bool)
        return resolve


class _Gate:
    """Each resolver blocks on the gate, then answers all True."""

    def __init__(self):
        self.gate = threading.Event()
        self.calls = 0
        self.lock = threading.Lock()

    def submit(self, items, trace_ids=None):
        with self.lock:
            self.calls += 1
        n = len(items)

        def resolver():
            assert self.gate.wait(timeout=30), "gate never opened"
            return np.ones(n, dtype=bool)
        return resolver


def _items(i, n=2):
    pk = bytes([(i * 31 + j) % 251 + 1 for j in range(32)])
    return [(pk, b"journal-%d-%d" % (i, k),
             bytes([(i + k) % 251]) * 16) for k in range(n)]


def _wait_for(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _rebase(obj, base):
    """Every ``trace_lo`` in a journal counted from ``base``."""
    if isinstance(obj, dict):
        return {k: (v - base if k == "trace_lo" and v is not None
                    else _rebase(v, base)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_rebase(v, base) for v in obj]
    return obj


def _never_started_fleet(pkg, n=3, **knobs):
    fleet, svc_mod = PKGS[pkg][:2]
    svcs = [svc_mod.VerifyService(lane_depth=512, lane_bytes=10 ** 9)
            for _ in range(n)]
    for svc in svcs:
        svc._running = True
    fl = fleet.FleetRouter(services=svcs, **knobs)
    fl._running = True
    return fl, svcs


def _replay(pkg, count=48, kill_at=24):
    """The reference's plan on one package: trace blocks allocated once,
    replica 0 killed mid-stream, the survivors' queues collected."""
    svc_mod, overloaded = PKGS[pkg][1], PKGS[pkg][4]
    fl, svcs = _never_started_fleet(pkg)
    plan = []
    for i in range(count):
        lane, tenant = KEY_GRID[i % len(KEY_GRID)]
        plan.append((i == kill_at, lane, tenant,
                     svc_mod._alloc_trace_block(2), _items(i)))
    for kill, lane, tenant, lo, items in plan:
        if kill:
            fl.kill_replica(0, stop_timeout=0)
        try:
            fl.submit(items, lane=lane, tenant=tenant, trace_lo=lo)
        except overloaded:
            pass
    for svc in svcs[1:]:
        with svc._cv:
            svc._shed_pass_locked()
            while svc._collect_locked() is not None:
                pass
    return fl, plan[0][3]


# ---------------- the two packages on equal arrivals ----------------


def test_never_started_fleets_journal_equal_the_reference():
    """The reference's replay (same trace blocks, a kill mid-stream) in
    both packages: canonical bytes of the merged collects equal once
    rebased, merge is order-insensitive, and completeness reads the same
    (gap 0)."""
    out = {}
    for pkg in PKGS:
        jm = PKGS[pkg][2]
        fl, base = _replay(pkg)
        c1, c2 = jm.collect(fleet=fl), jm.collect(fleet=fl)
        assert jm.canonical(jm.merge(c1, c2)) == \
            jm.canonical(jm.merge(c2, c1))
        m = jm.merge(c1)
        comp = jm.completeness(m)
        assert comp["gap"] == 0, comp["checks"]
        out[pkg] = (jm.canonical(_rebase(m, base)), comp,
                    [dict(e) for e in _rebase(m["events"], base)])
    assert out["port"] == out["reference"]
    kinds = {e["kind"] for e in out["port"][2]}
    assert {"route", "enqueue", "handoff", "dispatch"} <= kinds


def _parked_run(pkg):
    """A started three-replica fleet over one gate: every replica parked
    on one scp submission, then mixed arrivals (a 4-deep bulk lane
    refuses some), one fleet-level refusal after two convictions, then
    the gate opens and the fleet drains."""
    fleet, svc_mod, jm, tr, overloaded = PKGS[pkg]
    gate = _Gate()
    svcs = [svc_mod.VerifyService(verifier=gate, lane_depth=4,
                                  lane_bytes=10 ** 9, max_batch=4,
                                  pipeline_depth=1) for _ in range(3)]
    fl = fleet.FleetRouter(services=svcs, divergence_every=10 ** 6).start()
    tkts, refusals = [], []
    try:
        parkers = {}
        for k in range(64):
            owner = fl.route_of("scp", f"park{k}")
            parkers.setdefault(owner, f"park{k}")
        assert sorted(parkers) == [0, 1, 2]
        for i in sorted(parkers):
            tkts.append(fl.submit(_items(1000 + i, 1), lane="scp",
                                  tenant=parkers[i]))
            _wait_for(lambda: gate.calls == i + 1, "a replica never parked")
        base = tkts[0].trace_lo
        for i in range(36):
            lane, tenant = KEY_GRID[i % len(KEY_GRID)]
            try:
                tkts.append(fl.submit(_items(i), lane=lane, tenant=tenant))
            except overloaded as e:
                refusals.append((e.kind, e.lane, e.reason, e.replica))
        gate.gate.set()
        outcomes = []
        for t in tkts:
            try:
                outcomes.append(t.result(timeout=30).tolist())
            except overloaded as e:
                outcomes.append((e.kind, e.lane, e.reason))
        fl.convict(1, "test-quarantine")
        fl.convict(2, "test-quarantine")
        fl.convict(0, "test-quarantine")
        with pytest.raises(overloaded):
            fl.submit(_items(99), lane="bulk")
    finally:
        fl.stop(drain=True, timeout=30)
    m = jm.merge(jm.collect(fleet=fl))
    comp = jm.completeness(m, drained=True)
    ids = [i for t in tkts for i in range(t.trace_lo, t.trace_lo + t.n_items)]
    frac = jm.stitch_fraction(ids, tr.flight_recorder,
                              require=("route", "enqueue", "terminal"))
    return (jm.canonical(_rebase(m, base)), comp, refusals, outcomes, frac,
            fl.route_totals())


def test_parked_fleets_journal_equal_the_reference():
    out = {pkg: _parked_run(pkg) for pkg in PKGS}
    assert out["port"] == out["reference"]
    canon, comp, refusals, outcomes, frac, totals = out["port"]
    assert comp["gap"] == 0, comp["checks"]
    assert refusals and all(r[2] == "queue-depth" for r in refusals)
    assert any(o[0] == "shed" for o in outcomes if isinstance(o, tuple))
    assert sum(isinstance(o, list) for o in outcomes) > len(outcomes) // 2
    assert frac == 1.0
    assert totals["refused"] == 2 and totals["routed"] > 0
    m = json.loads(canon)
    assert {"fleet.convictions", "replica/0", "decisions/2"} <= \
        set(m["components"])


def test_merge_refuses_conflicting_rows_and_totals():
    j1 = {"components": {"c": [{"seq": 0, "kind": "a"}]},
          "totals": {}, "nondet": {}}
    j2 = {"components": {"c": [{"seq": 0, "kind": "b"}]},
          "totals": {}, "nondet": {}}
    t1 = {"components": {}, "totals": {"fleet": {"submitted": 1}},
          "nondet": {}}
    t2 = {"components": {}, "totals": {"fleet": {"submitted": 2}},
          "nondet": {}}
    for jm in (journal, jjournal):
        with pytest.raises(jm.JournalDivergence):
            jm.merge(j1, j2)
        with pytest.raises(jm.JournalDivergence):
            jm.merge(t1, t2)
        assert jm.merge(j1, j1)["components"]["c"] == \
            j1["components"]["c"]
    assert journal.canonical_bytes(j1) == jjournal.canonical_bytes(j1)
    assert journal.merge(j1, t1, j1) == jjournal.merge(j1, t1, j1)


def test_completeness_flags_terminal_violations():
    double = {"components": {"replica/0": [
        {"seq": 0, "kind": "enqueue", "trace_lo": 10, "n": 2},
        {"seq": 1, "kind": "verified", "trace_lo": 10, "n": 2},
        {"seq": 2, "kind": "verified", "trace_lo": 10, "n": 2},
    ]}, "totals": {}, "nondet": {}}
    missing = {"components": {"replica/0": [
        {"seq": 0, "kind": "enqueue", "trace_lo": 10, "n": 2},
    ]}, "totals": {}, "nondet": {}}
    rehomed = {"components": {
        "replica/0": [
            {"seq": 0, "kind": "enqueue", "trace_lo": 4, "n": 1},
            {"seq": 1, "kind": "handoff", "trace_lo": 4, "n": 1}],
        "replica/1": [
            {"seq": 0, "kind": "enqueue", "trace_lo": 4, "n": 1},
            {"seq": 1, "kind": "verified", "trace_lo": 4, "n": 1}],
    }, "totals": {}, "nondet": {}}
    wire = {"components": {}, "totals": {}, "nondet": {"ingress": {
        "frames_received": 3, "decoded_frames": 2, "malformed_frames": 0,
        "items_decoded": 4, "accepted": 4, "refused": 0, "resolved": 3,
        "shed": 0, "failed": 0, "pending": 0}}}
    for j, drained, gap in ((double, False, 2), (missing, False, 0),
                            (missing, True, 2), (rehomed, True, 0),
                            (wire, False, 2)):
        got = journal.completeness(j, drained=drained)
        assert got == jjournal.completeness(j, drained=drained)
        assert got["gap"] == gap


def test_stitch_fraction_equals_the_reference():
    """Both packages' recorders, fed the same events, stitch alike: a
    whole wire -> route -> enqueue -> verdict trace, one that ends at a
    handoff (a seam), and one with no wire segment."""
    fracs = {}
    for pkg in PKGS:
        rec = PKGS[pkg][3].flight_recorder
        for name, tr in (("ingress.frame", [[1, 3]]),
                         ("fleet.route", [[1, 5]]),
                         ("service.enqueue", [[1, 5]]),
                         ("service.handoff", [[3, 5]]),
                         ("service.verdict", [[1, 3]]),
                         ("fleet.route", [[7, 8]]),
                         ("service.enqueue", [[7, 8]]),
                         ("service.verdict", [[7, 8]])):
            rec.note(name, traces=tr, replica=0)
        jm = PKGS[pkg][2]
        fracs[pkg] = [jm.stitch_fraction(ids, rec, require=req)
                      for ids, req in (
                          ([1, 2], ("wire", "route", "enqueue", "terminal")),
                          ([1, 2, 3, 4], ("enqueue", "terminal")),
                          ([7], ("wire", "route")),
                          ([7], ("route", "enqueue", "terminal")),
                          ([], ("wire",)))]
        st = {t: rec.trace_timeline(t)["stitch"] for t in (1, 3, 7)}
        fracs[pkg].append(st)
    assert fracs["port"] == fracs["reference"]
    assert fracs["port"][:5] == [1.0, 0.5, 0.0, 1.0, 1.0]


# ---------------- the reference's cases on the port ----------------


def test_completeness_law_under_mixed_terminals():
    """verified, handoff, shed, rejected and fleet-refused in one window,
    and the merged journal still reconciles exactly (gap 0, drained)."""
    svcs = [vs.VerifyService(verifier=_Slow(), lane_depth=512,
                             lane_bytes=10 ** 9, max_batch=4, replica=i)
            for i in range(3)]
    fl = fleet_mod.FleetRouter(services=svcs,
                               divergence_every=10 ** 6).start()
    outcomes = {"verified": 0, "shed": 0, "rejected": 0, "refused": 0}
    try:
        wave1 = [fl.submit(_items(i), lane="bulk", tenant="t%d" % (i % 5))
                 for i in range(20)]
        moved = fl.kill_replica(0, stop_timeout=60)
        assert moved > 0, "the kill found nothing queued to hand off"
        for t in wave1:
            assert t.result(timeout=60).all()
            outcomes["verified"] += 1
        wave2 = [fl.submit(_items(100 + i), lane="bulk",
                           tenant="t%d" % (i % 5)) for i in range(10)]
        svcs[1].stop(drain=False, timeout=60)
        for t in wave2:
            try:
                assert t.result(timeout=60).all()
                outcomes["verified"] += 1
            except Overloaded as e:
                assert e.kind == "shed"
                outcomes["shed"] += 1
        wave3 = []
        for i in range(30, 40):
            try:
                wave3.append(fl.submit(_items(i), lane="bulk",
                                       tenant="t%d" % i))
            except Overloaded as e:
                assert e.kind == "rejected"
                outcomes["rejected"] += 1
        for t in wave3:
            assert t.result(timeout=60).all()
            outcomes["verified"] += 1
        fl.convict(1, "test-quarantine")
        fl.convict(2, "test-quarantine")
        with pytest.raises(Overloaded) as ei:
            fl.submit(_items(99), lane="bulk")
        assert ei.value.reason == "fleet-quarantined"
        outcomes["refused"] += 1
    finally:
        fl.stop(drain=True, timeout=60)
    assert min(outcomes.values()) > 0, outcomes
    m = journal.merge(journal.collect(fleet=fl))
    comp = journal.completeness(m, drained=True)
    assert comp["gap"] == 0, comp["checks"]
    assert comp["wrapped"] == []
    assert {"route", "refused"} <= {r["kind"]
                                    for r in m["components"]["fleet"]}
    replica_kinds = set()
    for cname, rows in m["components"].items():
        if cname.startswith("replica/"):
            replica_kinds |= {r["kind"] for r in rows}
    assert {"enqueue", "verified", "handoff", "shed",
            "rejected"} <= replica_kinds


def test_route_precedes_enqueue_seam_order():
    svcs = [vs.VerifyService(verifier=_Instant(), lane_depth=512,
                             lane_bytes=10 ** 9, replica=i)
            for i in range(2)]
    fl = fleet_mod.FleetRouter(services=svcs,
                               divergence_every=10 ** 6).start()
    try:
        tkt = fl.submit(_items(1), lane="bulk", tenant="t0")
        assert tkt.result(timeout=30).all()
    finally:
        fl.stop(drain=True, timeout=30)
    tl = tracing.flight_recorder.trace_timeline(tkt.trace_lo)
    names = [r["name"] for r in tl["records"]]
    assert names.index("fleet.route") < names.index("service.enqueue")
    st = tl["stitch"]
    assert st["route"] and st["enqueue"] and st["seamless"]
    assert st["terminal"] == "service.verdict"
    assert tl["summary"]["tenant"] == "t0"
    assert "enqueue_to_verdict_ms" in tl["summary"]
    m = journal.merge(journal.collect(fleet=fl))
    rows = [r for r in m["components"]["fleet"]
            if r["kind"] == "route" and r["trace_lo"] == tkt.trace_lo]
    assert rows and rows[0]["replica"] is not None


def test_journal_memory_bounded_totals_exact():
    out = {}
    for pkg in PKGS:
        svc_mod, jm, overloaded = PKGS[pkg][1], PKGS[pkg][2], PKGS[pkg][4]
        svc = svc_mod.VerifyService(verifier=_Instant(), lane_depth=64,
                                    lane_bytes=10 ** 9)
        svc._running = True
        cap = svc._journal.maxlen
        admitted = rejected = 0
        for i in range(cap + 50):
            try:
                svc.submit(_items(i, 1), lane="bulk")
                admitted += 1
            except overloaded:
                rejected += 1
        assert rejected > 0 and len(svc.journal_log()) <= cap
        tot = svc.journal_totals()
        assert (tot["submitted"], tot["rejected"]) == (admitted, rejected)
        comp = jm.completeness(jm.merge(jm.collect(services=[svc])))
        assert comp["wrapped"] == ["replica/0"]
        assert comp["gap"] == 0, comp["checks"]
        assert len(svc.journal_log(limit=8)) == 8
        out[pkg] = (cap, admitted, rejected, comp, tot)
    assert out["port"] == out["reference"]


# ---------------- stitch cases of the trace propagation tests ----------


def test_handoff_trace_stitches_across_kill():
    """Every re-homed trace's stitched timeline shows the handoff hop and
    the survivor's completion with no seam."""
    svcs = [vs.VerifyService(verifier=_Slow(), lane_depth=512,
                             lane_bytes=10 ** 9, max_batch=4, replica=i)
            for i in range(2)]
    fl = fleet_mod.FleetRouter(services=svcs,
                               divergence_every=10 ** 6).start()
    try:
        batch = _items(7)
        tkts = [fl.submit(batch, lane="bulk", tenant=f"t{i % 6}")
                for i in range(24)]
        pend = [s.snapshot()["pending_items"] for s in svcs]
        victim = max(range(len(svcs)), key=lambda i: pend[i])
        moved = fl.kill_replica(victim, stop_timeout=60)
        assert moved > 0, "the kill found nothing queued to hand off"
        for t in tkts:
            assert t.result(timeout=60).all()
    finally:
        fl.stop(drain=True, timeout=60)
    hopped = 0
    for t in tkts:
        st = tracing.flight_recorder.trace_timeline(t.trace_lo)["stitch"]
        assert st["route"] and st["enqueue"], st
        assert st["terminal"] == "service.verdict", st
        assert st["seamless"], st
        if st["handoffs"] > 0:
            assert len(st["hops"]) >= 2, st
            assert st["hops"][-1]["handoff"] is True, st
            assert st["hops"][-1]["replica"] != st["hops"][0]["replica"]
            hopped += 1
    assert hopped > 0, "no re-homed trace crossed the kill"
    ids = [i for t in tkts for i in range(t.trace_lo, t.trace_lo + 2)]
    assert journal.stitch_fraction(
        ids, tracing.flight_recorder,
        require=("route", "enqueue", "terminal")) == 1.0


def _validate_chrome(trace: dict):
    """Through JSON and back, every track's B/E pairs nested."""
    out = json.loads(json.dumps(trace))
    stacks = {}
    for e in out["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append((e["name"], e["ts"]))
        elif e["ph"] == "E":
            st = stacks.get(key)
            assert st, f"E without B: {e}"
            name, ts = st.pop()
            assert name == e["name"] and e["ts"] >= ts
    assert all(not s for s in stacks.values()), "unclosed B"
    return out


def test_chrome_fleet_export_per_replica_tracks():
    svcs = [vs.VerifyService(verifier=_Instant(), replica=i)
            for i in range(2)]
    fl = fleet_mod.FleetRouter(services=svcs,
                               divergence_every=10 ** 6).start()
    try:
        tkts = [fl.submit(_items(i, 1), lane="bulk", tenant=f"t{i}")
                for i in range(8)]
        for t in tkts:
            assert t.result(timeout=30).all()
    finally:
        fl.stop(drain=True, timeout=30)
    out = _validate_chrome(
        tracing.flight_recorder.to_chrome_trace(by_replica=True))
    evs = out["traceEvents"]
    assert {2, 3} <= {e["pid"] for e in evs}
    pnames = {e["pid"]: e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert (pnames.get(1), pnames.get(2), pnames.get(3)) == \
        ("host", "replica 0", "replica 1")
    verdicts = [e for e in evs if e["name"] == "service.verdict"]
    assert verdicts and all(e["pid"] in (2, 3) for e in verdicts)
    flat = tracing.flight_recorder.to_chrome_trace()
    assert {e["pid"] for e in flat["traceEvents"]} == {1}
