"""The port's fleet router against the reference's, on the CPU.

The same arrivals go through ``stellar_tpu.crypto.fleet.FleetRouter`` and
``stellar_tpu_torch.crypto.fleet.FleetRouter``, each over its own
package's services with stub verifiers or never-started replicas (the
dispatchers never run, so a single-threaded replay is deterministic), and
their routes, route logs and totals (trace IDs rebased to each package's
first), handoff counts, refusals, convictions, snapshots and metric
rollups must be equal, exactly. The reference's fleet and service modules
import without JAX, so nothing here compiles a JAX program. This covers
the 13 cases of ``tests/test_fleet.py``, the Config and admin-route cases
held as ``configure_fleet``, ``fleet_health()`` and ``dispatch_health()
["fleet"]`` against the reference's.

Also here: three replicas over one port ``BatchVerifier`` on the CPU,
submitted to from three threads at once: the resolve path under
concurrency (verdicts equal to the oracle, the transfer ledger equal to
the engine's own tallies).
"""

import sys
import threading

import numpy as np
import pytest

from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.crypto import fleet as jfleet
from stellar_tpu.crypto import verify_service as jvs
from stellar_tpu.utils import resilience as jres
from stellar_tpu.utils import tracing as jtracing
from stellar_tpu.utils.metrics import registry as jregistry
from stellar_tpu_torch.crypto import batch_verifier as pbv
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import fleet as pfleet
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto import verify_service as pvs
from stellar_tpu_torch.parallel import batch_engine as pbe
from stellar_tpu_torch.parallel import signer_tables
from stellar_tpu_torch.utils import resilience as pres
from stellar_tpu_torch.utils import tracing as ptracing
from stellar_tpu_torch.utils.metrics import registry as pregistry
from stellar_tpu_torch.utils.transfer_ledger import transfer_ledger

PKGS = {"reference": (jfleet, jvs, jbv, jregistry, jtracing),
        "port": (pfleet, pvs, pbv, pregistry, ptracing)}

KEY_GRID = [("bulk", None), ("bulk", "t0"), ("bulk", "t1"),
            ("bulk", "t2"), ("scp", None), ("scp", "t3"),
            ("auth", None), ("auth", "t4"), ("bulk", "t5"),
            ("scp", "t6"), ("bulk", "t7"), ("auth", "t8")]


@pytest.fixture(autouse=True)
def _unregister_health():
    yield
    for fleet, _vs, bv, _reg, _tr in PKGS.values():
        bv.register_fleet_health(None)
        bv.register_service_health(None)
        with fleet._fleet_lock:
            fleet._fleet = None


class InstantVerifier:
    def submit(self, items, trace_ids=None):
        n = len(items)
        return lambda: np.ones(n, dtype=bool)


def _items(i, n=2):
    pk = bytes([(i * 13 + j) % 251 + 1 for j in range(32)])
    return [(pk, b"f%d-%d" % (i, k), bytes([(i + k) % 251]) * 64)
            for k in range(n)]


def _quiet_fleet(pkg, n=3, **knobs):
    """A router over never-started replicas: submissions queue, nothing
    dispatches."""
    fleet, vs = PKGS[pkg][:2]
    svcs = [vs.VerifyService(lane_depth=512, lane_bytes=10 ** 9)
            for _ in range(n)]
    for svc in svcs:
        svc._running = True
    fl = fleet.FleetRouter(services=svcs, **knobs)
    fl._running = True
    return fl, svcs


def _manual_drain(svc):
    with svc._cv:
        svc._shed_pass_locked()
        while svc._collect_locked() is not None:
            pass


def _rebased_log(fl):
    """The route log with trace IDs counted from the first row's."""
    log = fl.route_log()
    base = min(r["trace_lo"] for r in log)
    return [dict(r, trace_lo=r["trace_lo"] - base) for r in log]


def _both(run, *args, **kw):
    out = {pkg: run(pkg, *args, **kw) for pkg in PKGS}
    assert out["port"] == out["reference"]
    return out["port"]


# ---------------- routing determinism ----------------


def test_route_key_and_score_equal_the_reference():
    for lane, tenant in KEY_GRID + [("ab", "c"), ("a", "bc")]:
        key = pfleet.route_key(lane, tenant or "")
        assert key == jfleet.route_key(lane, tenant or "")
        for i in range(8):
            assert pfleet.route_score(key, i) == jfleet.route_score(key, i)
        assert pfleet._pick(range(5), key) == jfleet._pick(range(5), key)
    assert pfleet.route_key("ab", "c") != pfleet.route_key("a", "bc")
    k = pfleet.route_key("scp", "tenant-9")
    assert pfleet.route_score(k, 0) != pfleet.route_score(k, 1)


def test_independent_routers_route_identically():
    def run(pkg):
        fa, _ = _quiet_fleet(pkg)
        fb, _ = _quiet_fleet(pkg)
        ra = [fa.route_of(ln, t) for ln, t in KEY_GRID]
        assert ra == [fb.route_of(ln, t) for ln, t in KEY_GRID]
        return ra

    ra = _both(run)
    assert len(set(ra)) > 1


def test_hash_ring_minimal_disruption_on_loss():
    def run(pkg):
        fl, _svcs = _quiet_fleet(pkg)
        before = {k: fl.route_of(*k) for k in KEY_GRID}
        victim = before[("bulk", "t0")]
        fl.kill_replica(victim)
        after = {k: fl.route_of(*k) for k in KEY_GRID}
        for k in KEY_GRID:
            if before[k] == victim:
                assert after[k] is not None and after[k] != victim
            else:
                assert after[k] == before[k]
        return before, after

    _both(run)


def test_hash_ring_regrowth_restores_routes():
    def run(pkg):
        fl, _svcs = _quiet_fleet(pkg, divergence_every=4, probation=4)
        before = {k: fl.route_of(*k) for k in KEY_GRID}
        victim = before[("bulk", "t0")]
        fl.convict(victim, "test-seam")
        assert fl.snapshot()["states"][victim] == "quarantined"
        assert all(fl.route_of(*k) != victim for k in KEY_GRID)
        for i in range(16):
            ln, t = KEY_GRID[i % len(KEY_GRID)]
            fl.submit(_items(i), lane=ln, tenant=t)
        snap = fl.snapshot()
        assert snap["states"][victim] == "active"
        assert snap["readmissions"] == 1
        assert {k: fl.route_of(*k) for k in KEY_GRID} == before
        return snap, _rebased_log(fl), fl.route_totals()

    _both(run)


# ---------------- drain / handoff ----------------


def test_handoff_counts_and_trace_ids_equal_the_reference():
    """A quiet fleet with queued work on every replica: killing one hands
    its queued items to the survivors under their original trace blocks;
    the handoff count, the route log (re-routes flagged), the route
    totals and the snapshot equal the reference's, and the fleet's
    conservation law holds through the kill."""
    def run(pkg):
        fl, svcs = _quiet_fleet(pkg, divergence_every=10 ** 6)
        tkts = []
        for i in range(24):
            ln, t = KEY_GRID[i % len(KEY_GRID)]
            tkts.append(fl.submit(_items(i), lane=ln, tenant=t))
        base = tkts[0].trace_lo
        los = [t.trace_lo - base for t in tkts]
        victim = fl.route_of("bulk", "t0")
        moved = fl.kill_replica(victim, stop_timeout=0)
        assert moved > 0
        snap = fl.snapshot()
        assert snap["conservation_gap"] == 0
        assert snap["handoffs"] == moved == snap["totals"]["handoff"]
        rerouted = [r for r in fl.route_log() if r.get("handoff")]
        assert sum(r["n"] for r in rerouted) == moved
        # the survivors hold the handed-off blocks under the same IDs
        held = sorted(lo - base for s in svcs if s is not svcs[victim]
                      for lo in (r["trace_lo"] for r in s.journal_log()
                                 if r["kind"] == "enqueue"))
        assert {r["trace_lo"] - base for r in rerouted} <= set(held)
        return moved, los, _rebased_log(fl), fl.route_totals(), snap

    _both(run)


def test_drain_handoff_zero_loss_trace_ids_intact():
    """The reference's threaded case on the port: a kill with queued work
    behind a gate loses no ticket, the law stays exact, and the handed-off
    work keeps its trace block (the survivor's completion rides the same
    IDs)."""
    gate = threading.Event()

    class Gated:
        def submit(self, items, trace_ids=None):
            n = len(items)

            def resolver():
                gate.wait(30)
                return np.ones(n, dtype=bool)
            return resolver

    ptracing.flight_recorder.clear()
    svcs = [pvs.VerifyService(verifier=Gated(), lane_depth=64,
                              max_batch=4, pipeline_depth=1)
            for _ in range(2)]
    fl = pfleet.FleetRouter(services=svcs,
                            divergence_every=10 ** 6).start()
    try:
        tkts = []
        for i in range(12):
            ln, t = KEY_GRID[i % len(KEY_GRID)]
            tkts.append(fl.submit(_items(i), lane=ln, tenant=t))
        victim = max(range(2),
                     key=lambda i: svcs[i].snapshot()["pending_items"])
        moved = fl.kill_replica(victim, stop_timeout=30)
        gate.set()
        for t in tkts:
            assert t.result(timeout=30).all()
        snap = fl.snapshot()
        assert snap["states"][victim] == "dead"
        assert snap["conservation_gap"] == 0
        assert snap["handoffs"] == moved == snap["totals"]["handoff"]
        assert moved > 0
        recent = ptracing.flight_recorder.snapshot(limit=512)["recent"]
        handoffs = [r for r in recent if r.get("name") == "service.handoff"]
        assert handoffs
        assert all(r["attrs"]["replica"] == victim for r in handoffs)
        lo = handoffs[0]["attrs"]["traces"][0][0]
        st = ptracing.flight_recorder.trace_timeline(lo)["stitch"]
        assert st["handoffs"] >= 1 and st["seamless"], st
        assert st["terminal"] == "service.verdict", st
    finally:
        fl.stop(drain=True, timeout=30)


def test_router_refusal_is_typed_with_no_survivors():
    def run(pkg):
        fleet = PKGS[pkg][0]
        fl, _svcs = _quiet_fleet(pkg, n=1)
        fl.kill_replica(0)
        with pytest.raises(fleet.Overloaded) as ei:
            fl.submit(_items(0), lane="bulk")
        e = ei.value
        assert (e.kind, e.reason, e.replica) == \
            ("rejected", "fleet-quarantined", None)
        snap = fl.snapshot()
        assert snap["router_refused"] == 2
        assert snap["conservation_gap"] == 0
        return (e.kind, e.lane, e.reason, e.tenant, len(e.trace_ids)), \
            snap, _rebased_log(fl)

    _both(run)


def test_replica_attribution_on_service_refusal():
    def run(pkg):
        fleet, vs = PKGS[pkg][:2]
        svcs = [vs.VerifyService(lane_depth=1, lane_bytes=10 ** 9)
                for _ in range(2)]
        for svc in svcs:
            svc._running = True
        fl = fleet.FleetRouter(services=svcs, divergence_every=10 ** 6)
        fl._running = True
        owner = fl.route_of("bulk", "t0")
        fl.submit(_items(0), lane="bulk", tenant="t0")
        with pytest.raises(fleet.Overloaded) as ei:
            fl.submit(_items(1), lane="bulk", tenant="t0")
        assert ei.value.replica == owner
        assert ei.value.reason == "queue-depth"
        assert fl.snapshot()["conservation_gap"] == 0
        return owner, fl.snapshot()

    _both(run)


# ---------------- divergence conviction ----------------


def test_divergence_no_false_positive_and_true_positive():
    def run(pkg):
        fl, svcs = _quiet_fleet(pkg, divergence_every=4, probation=8)
        for i in range(24):
            ln, t = KEY_GRID[i % len(KEY_GRID)]
            fl.submit(_items(i), lane=ln, tenant=t)
        for svc in svcs:
            _manual_drain(svc)
        logs = [svc.decision_log() for svc in svcs]
        # an honest fleet: nobody convicted
        assert fl.divergence_check() == []
        assert fl.snapshot()["divergence_convictions"] == 0
        victim = max(range(3), key=lambda i: len(svcs[i].decision_log()))
        svc = svcs[victim]
        with svc._cv:
            d = svc._decisions[0]
            svc._decisions[0] = d[:5] + ((victim + 1) % 3,)
        convicted = fl.divergence_check()
        assert [idx for idx, _ev in convicted] == [victim]
        snap = fl.snapshot()
        assert snap["states"][victim] == "quarantined"
        assert snap["per_replica"][victim]["breaker"] == "open"
        assert snap["divergence_convictions"] == 1
        assert [c["replica"] for c in snap["conviction_log"]] == [victim]
        assert all(fl.route_of(*k) != victim for k in KEY_GRID)
        return logs, convicted, snap

    _both(run)


def test_ledger_mismatch_is_convicted():
    def run(pkg):
        fl, svcs = _quiet_fleet(pkg, divergence_every=10 ** 6)
        for i in range(12):
            ln, t = KEY_GRID[i % len(KEY_GRID)]
            fl.submit(_items(i), lane=ln, tenant=t)
        for svc in svcs:
            _manual_drain(svc)
        victim = max(range(3), key=lambda i: len(svcs[i].decision_log()))
        svc = svcs[victim]
        with svc._cv:
            d = svc._decisions[0]
            swapped = "scp" if d[1] != "scp" else "bulk"
            svc._decisions[0] = (d[0], swapped) + d[2:]
        convicted = fl.divergence_check()
        assert [idx for idx, _ev in convicted] == [victim]
        assert convicted[0][1][0] in ("ledger-mismatch",
                                      "bad-decision-lane")
        return convicted, fl.snapshot()

    _both(run)


# ---------------- knobs / surfaces ----------------


KNOBS = ("FLEET_ENABLED", "FLEET_REPLICAS", "DIVERGENCE_EVERY",
         "PROBATION", "LEDGER", "METRIC_REPLICAS")


def test_configure_fleet_equals_the_reference():
    """The port's knobs are the reference's defaults as module constants,
    and ``configure_fleet`` sets and clamps them as the reference's does
    (the reference's node pushes its Config through the same function)."""
    saved = {pkg: tuple(getattr(PKGS[pkg][0], k) for k in KNOBS)
             for pkg in PKGS}
    assert saved["port"] == (False, 3, 64, 256, 8192, 8)
    try:
        for kw in (dict(enabled=True, replicas=5, divergence_every=17,
                        probation=33, ledger=100, metric_replicas=2),
                   dict(replicas=0, divergence_every=0, probation=0,
                        ledger=3, metric_replicas=0),
                   dict(enabled=False)):
            for pkg in PKGS:
                PKGS[pkg][0].configure_fleet(**kw)
            got = {pkg: tuple(getattr(PKGS[pkg][0], k) for k in KNOBS)
                   for pkg in PKGS}
            assert got["port"] == got["reference"], kw
            # instances read the knobs at construction
            fls = {pkg: _quiet_fleet(pkg)[0].snapshot()["knobs"]
                   for pkg in PKGS}
            assert fls["port"] == fls["reference"]
    finally:
        for pkg in PKGS:
            vals = dict(zip(KNOBS, saved[pkg]))
            PKGS[pkg][0].configure_fleet(
                enabled=vals["FLEET_ENABLED"],
                replicas=vals["FLEET_REPLICAS"],
                divergence_every=vals["DIVERGENCE_EVERY"],
                probation=vals["PROBATION"], ledger=vals["LEDGER"],
                metric_replicas=vals["METRIC_REPLICAS"])
    assert tuple(getattr(pfleet, k) for k in KNOBS) == saved["port"]


def test_fleet_health_and_dispatch_health():
    """``dispatch_health()["fleet"]`` and ``fleet_health()`` read
    ``{"enabled": False}`` before a fleet starts, and the started fleet's
    snapshot after, with the reference's keys and values."""
    out = {}
    for pkg, (fleet, _vs, bv, _reg, _tr) in PKGS.items():
        assert bv.dispatch_health()["fleet"] == {"enabled": False}
        assert fleet.fleet_health() == {"enabled": False}
        assert fleet.running_fleet() is None
        fl = fleet.FleetRouter(verifier=InstantVerifier(),
                               replicas=2).start()
        try:
            assert fleet.running_fleet() is fl
            tkt = fl.submit(_items(0), lane="scp", tenant="t0")
            assert tkt.result(timeout=30).all()
            health = bv.dispatch_health()["fleet"]
            assert health["enabled"] is True and health["replicas"] == 2
            assert health["running"] is True
            assert fleet.fleet_health()["conservation_gap"] == 0
            out[pkg] = {k: v for k, v in health.items()
                        if k != "per_replica"}
        finally:
            fl.stop(drain=True, timeout=30)
    assert out["port"] == out["reference"]


def test_metric_cardinality_rollup():
    """Replica gauges stop at the metric_replicas cap; the rest fold into
    the ``~other`` series, in both packages' registries alike."""
    def run(pkg):
        reg = PKGS[pkg][3]
        fl, _svcs = _quiet_fleet(pkg, n=4, metric_replicas=2,
                                 divergence_every=10 ** 6)
        for i in range(16):
            ln, t = KEY_GRID[i % len(KEY_GRID)]
            fl.submit(_items(i), lane=ln, tenant=t)
        stale = reg.gauge("crypto.verify.fleet.replica.2.routed_items").value
        snap = fl.snapshot()
        per = {r["replica"]: r for r in snap["per_replica"]}
        for i in (0, 1):
            assert reg.gauge(f"crypto.verify.fleet.replica.{i}.routed_items"
                             ).value == per[i]["routed_items"]
        other = reg.gauge(
            "crypto.verify.fleet.replica.~other.routed_items").value
        assert other == per[2]["routed_items"] + per[3]["routed_items"]
        assert reg.gauge(
            "crypto.verify.fleet.replica.2.routed_items").value == stale
        assert reg.gauge("crypto.verify.fleet.replicas").value == 4
        return [reg.gauge(f"crypto.verify.fleet.replica.{i}.{k}").value
                for i in (0, 1) for k in ("routed_items", "verified",
                                          "pending", "quarantined")], other

    _both(run)


def test_fleet_overloaded_reexport():
    assert pfleet.Overloaded is pres.Overloaded
    assert pvs.Overloaded is pfleet.Overloaded
    assert jfleet.Overloaded is jres.Overloaded


# ---------------- one engine, three resolving threads ----------------


def test_three_replicas_share_one_cpu_verifier_concurrently():
    """Three replicas over one port ``BatchVerifier`` (one
    ``SharedVerifier``), three threads submitting at once on every lane:
    every verdict equals the oracle, the fleet's law is exact, and the
    transfer ledger's deltas equal the engine's own tallies, so the
    resolve path kept its shared registries whole under three resolving
    dispatcher threads (the interpreter's switch interval shortened, so
    the threads interleave often)."""
    rng = np.random.default_rng(91)
    items = vectors.edge_corpus(rng)[:10] + vectors.valid_items(rng, 6)
    want = np.array([ref.verify(*it) for it in items])
    pbe._reset_dispatch_state_for_testing()
    signer_tables.signer_table_cache._reset_for_testing()
    v = pbv.BatchVerifier(device="cpu", bucket_sizes=(16,))
    fl = pfleet.FleetRouter(verifier=v, replicas=3).start()
    assert all(isinstance(s._verifier, pfleet.SharedVerifier)
               for s in fl.services())
    t0 = transfer_ledger.totals()
    shipped0, fetched0 = v.shipped_bytes, v.fetched_bytes
    results = {}

    def client(lane):
        tk = [fl.submit(items, lane=lane, tenant=f"t{k}")
              for k in range(4)]
        results[lane] = [t.result(timeout=120) for t in tk]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(ln,))
                   for ln in pvs.LANES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        snap = fl.snapshot()
    finally:
        sys.setswitchinterval(interval)
        fl.stop(drain=True, timeout=60)
        signer_tables.signer_table_cache._reset_for_testing()
    assert sorted(results) == sorted(pvs.LANES)
    for outs in results.values():
        for got in outs:
            np.testing.assert_array_equal(got, want)
    assert snap["conservation_gap"] == 0
    assert snap["totals"]["verified"] == 12 * len(items)
    assert sum(1 for r in snap["per_replica"] if r["routed_items"]) > 1
    t1 = transfer_ledger.totals()
    assert t1["bytes_h2d"] - t0["bytes_h2d"] == v.shipped_bytes - shipped0
    assert t1["bytes_d2h"] - t0["bytes_d2h"] == v.fetched_bytes - fetched0
    assert v.fetched_bytes > fetched0
    assert v.served["hot"] > 0
