"""The port's verify service layer against the reference's, on the CPU.

The same arrival sequences go through ``stellar_tpu.crypto.
verify_service.VerifyService`` and ``stellar_tpu_torch.crypto.
verify_service.VerifyService``, each over a gate stub verifier, and their
decision logs, journals (trace IDs rebased to each service's first),
journal totals, tenant snapshots, lane counts and ingress refusals must
be equal, exactly. The reference's service modules import without JAX,
so nothing here compiles a JAX program.

Determinism: every service runs at pipeline depth 1 and is parked first:
one scp submission is collected and its resolver blocks on the closed
gate, so every later arrival is admitted against the same queue state in
both packages, and once the gate opens the dispatcher alone moves.

Also here: the level-2 shed ladder (the port's ``dispatch_degraded`` from
quarantined devices, the reference's from its tripped breaker), the
content-seeded shed draw and the burn-window helpers, the controller's
step and replay, the trickle batcher, and one end-to-end run of the port
service over the CPU verifier on the edge corpus. CPU verifier calls stay
at bucket 16.
"""

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import pytest

from stellar_tpu.crypto import audit as jaudit
from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.crypto import controller as jctl
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import tenant as jtn
from stellar_tpu.crypto import verify_service as jvs
from stellar_tpu.utils import metrics as jmetrics
from stellar_tpu_torch.crypto import audit as paudit
from stellar_tpu_torch.crypto import batch_verifier as pbv
from stellar_tpu_torch.crypto import controller as pctl
from stellar_tpu_torch.crypto import tenant as ptn
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto import verify_service as pvs
from stellar_tpu_torch.parallel import batch_engine as pbe
from stellar_tpu_torch.utils import faults
from stellar_tpu_torch.utils import metrics as pmetrics
from stellar_tpu_torch.utils import resilience as pres

PACKAGES = {"reference": (jvs, jtn), "port": (pvs, ptn)}
LANE_KEYS = ("submitted", "verified", "rejected", "shed", "failed",
             "handoff", "queued_items", "queued_submissions")


def _reset_tenants(tn):
    tn.clear_tenant_policies()
    tn.configure_tenants(depth=0, nbytes=0)
    tn.tenant_slo._reset_for_testing()


@pytest.fixture(autouse=True)
def clean_state():
    """Both packages' dispatch, tenant and SLO state as at process start,
    no fault armed, no service registered — before and after."""
    saved = (jtn.TENANT_DEPTH, jtn.TENANT_BYTES, ptn.TENANT_DEPTH,
             ptn.TENANT_BYTES)

    def reset():
        faults.clear()
        jbv._reset_dispatch_state_for_testing()
        pbe._reset_dispatch_state_for_testing()
        for vs, tn in PACKAGES.values():
            _reset_tenants(tn)
            vs.slo_monitor._reset_for_testing()
        jbv.register_service_health(None)
        pbe.register_service_health(None)

    reset()
    yield
    reset()
    jtn.configure_tenants(depth=saved[0], nbytes=saved[1])
    ptn.configure_tenants(depth=saved[2], nbytes=saved[3])


class GateVerifier:
    """Stand-in verifier: each resolver blocks on the gate (closed: a
    wedged card), then answers all True."""

    def __init__(self):
        self.gate = threading.Event()
        self.calls = 0

    def submit(self, items, trace_ids=None):
        self.calls += 1
        n = len(items)

        def resolver():
            assert self.gate.wait(timeout=30), "gate never opened"
            return np.ones(n, dtype=bool)
        return resolver


def _items(i, n=2):
    """``n`` rows whose bytes vary with ``i`` (the shed draw hashes a
    submission's bytes, so submissions must differ)."""
    pk = bytes([(i * 7 + j) % 251 + 1 for j in range(32)])
    return [(pk, b"m%d-%d" % (i, k), bytes([(i + k) % 251]) * 64)
            for k in range(n)]


def _wait_for(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _rebased(journal):
    """Journal rows with trace IDs counted from the service's first."""
    base = min(r["trace_lo"] for r in journal)
    return [dict(r, trace_lo=r["trace_lo"] - base) for r in journal]


def _park(svc, gate):
    """One scp submission collected and parked on the closed gate."""
    tkt = svc.submit(_items(10_000, 1), lane="scp")
    _wait_for(lambda: gate.calls == 1 and
              svc.snapshot()["lanes"]["scp"]["queued_submissions"] == 0,
              "the dispatcher never parked")
    return tkt


def _outcome(vs, tkt):
    try:
        return ("verified", tkt.result(timeout=30).tolist())
    except vs.Overloaded as e:
        return (e.kind, e.lane, e.reason, e.tenant)


def _record(vs, svc, refusals, tickets):
    snap = svc.snapshot()
    assert snap["conservation_gap"] == 0, snap
    assert svc.tenant_snapshot()["conservation_violations"] == {}
    return {"decisions": svc.decision_log(),
            "journal": _rebased(svc.journal_log()),
            "journal_totals": svc.journal_totals(),
            "tenants": svc.tenant_snapshot(),
            "lanes": {ln: {k: snap["lanes"][ln][k] for k in LANE_KEYS}
                      for ln in vs.LANES},
            "refusals": refusals,
            "outcomes": [_outcome(vs, t) for t in tickets]}


def _arrive(vs, svc, arrivals):
    refusals, tickets = [], []
    for lane, tenant, i, n in arrivals:
        try:
            tickets.append(svc.submit(_items(i, n), lane=lane,
                                      tenant=tenant))
        except vs.Overloaded as e:
            refusals.append((e.kind, e.lane, e.reason, e.tenant))
    return refusals, tickets


# ---------------- arrival sequences ----------------
# each: (service knobs, tenant policies, arrivals, stop without drain?)


def _multi_tenant():
    arrivals = [(ln, t, 100 * k + j, 2)
                for k in range(12) for ln in ("scp", "auth", "bulk")
                for j, t in enumerate(("gold", "plain", "bytes", None))]
    policies = {"depth": 6, "set": [("gold", dict(weight=3, depth=12)),
                                    ("bytes", dict(nbytes=700))]}
    return dict(lane_depth=64, lane_bytes=6000, max_batch=4,
                aging_every=4), policies, arrivals, False


def _flooder():
    arrivals = []
    for k in range(40):
        arrivals.append(("bulk", "flood", 1000 + k, 2))
        if k % 2 == 0:
            arrivals.append(("bulk", "calm", 2000 + k, 2))
        if k % 5 == 0:
            arrivals.append(("scp", "calm", 3000 + k, 1))
    policies = {"depth": 4, "set": [("flood", dict(depth=24)),
                                    ("calm", dict(depth=64))]}
    return dict(lane_depth=48, lane_bytes=10**7, max_batch=2,
                aging_every=4), policies, arrivals, False


def _backlog():
    arrivals = []
    for k in range(60):
        arrivals.append(("bulk", None, k, 1 + k % 3))
        if k % 4 == 0:
            arrivals.append(("scp", None, 500 + k, 1))
        if k % 7 == 0:
            arrivals.append(("auth", None, 700 + k, 1))
    return dict(lane_depth=40, lane_bytes=10**7, max_batch=6,
                aging_every=4), None, arrivals, False


def _stop_without_drain():
    arrivals = [("bulk", None, k, 2) for k in range(10)] + \
        [("auth", "t1", 50 + k, 1) for k in range(3)]
    return dict(lane_depth=64, lane_bytes=10**7, max_batch=2,
                aging_every=4), None, arrivals, True


def _aging():
    arrivals = [("bulk", None, 0, 2)] + \
        [("scp", None, 100 + k, 1) for k in range(8)] + \
        [("auth", None, 200 + k, 1) for k in range(3)] + \
        [("bulk", None, 300 + k, 1) for k in range(4)]
    return dict(lane_depth=64, lane_bytes=10**7, max_batch=2,
                aging_every=3), None, arrivals, False


SEQUENCES = {"multi_tenant": _multi_tenant, "flooder": _flooder,
             "backlog": _backlog, "stop_without_drain": _stop_without_drain,
             "aging": _aging}


def _run_sequence(vs, tn, name):
    knobs, policies, arrivals, no_drain = SEQUENCES[name]()
    if policies:
        tn.configure_tenants(depth=policies["depth"])
        for tenant, kw in policies["set"]:
            tn.set_tenant_policy(tenant, **kw)
    gate = GateVerifier()
    svc = vs.VerifyService(verifier=gate, pipeline_depth=1,
                           **knobs).start()
    tickets = [_park(svc, gate)]
    refusals, more = _arrive(vs, svc, arrivals)
    tickets += more
    if no_drain:
        svc.stop(drain=False, timeout=0.2)
        try:
            svc.submit(_items(9_999), lane="bulk")
        except vs.Overloaded as e:
            refusals.append((e.kind, e.lane, e.reason, e.tenant))
        gate.gate.set()
        svc._thread.join(timeout=20)
        assert not svc._thread.is_alive()
    else:
        gate.gate.set()
        for t in tickets:
            _outcome(vs, t)
        svc.stop(drain=True, timeout=30)
    return _record(vs, svc, refusals, tickets)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_arrival_sequence_equals_reference(name):
    ref = _run_sequence(jvs, jtn, name)
    _reset_tenants(jtn)
    port = _run_sequence(pvs, ptn, name)
    for key in ref:
        assert port[key] == ref[key], key
    # each sequence exercises what it is named for
    reasons = {r[2] for r in ref["refusals"]}
    kinds = {o[0] for o in ref["outcomes"]}
    shed = [o for o in ref["outcomes"] if o[0] == "shed"]
    want = {"multi_tenant": {"tenant-depth", "tenant-bytes", "bytes"} <=
            reasons,
            "flooder": "tenant-depth" in reasons and
            {o[3] for o in shed} == {"flood"},
            "backlog": "queue-depth" in reasons and bool(shed) and
            all(o[1] == "bulk" and o[2] == "backlog" for o in shed),
            "stop_without_drain": reasons == {"stopped"} and
            {o[2] for o in shed} == {"stopped"} and "verified" in kinds,
            "aging": not shed and not reasons}
    assert want[name], (reasons, shed)
    if name == "aging":
        # priority serves scp twice, then the aging slot takes the
        # globally oldest head: the starved bulk submission
        lanes = [d[1] for d in ref["decisions"] if d[0] == "dispatch"]
        assert lanes[:4] == ["scp", "scp", "scp", "bulk"], lanes


# ---------------- the level-2 ladder ----------------


def _quarantine_every_index():
    """A CPU verifier split over two indices, registered as a default
    verify engine, with both indices quarantined under ``fail-device``
    (one at the launch, one at the operand copy). Returns its name."""
    v = pbv.BatchVerifier(devices=["cpu"] * 2, bucket_sizes=(16,))
    v.health.configure(failure_threshold=1, backoff_min_s=60.0,
                       backoff_max_s=120.0)
    name = "verify:ladder-test"
    pbe.register_default_engine(name, v)
    assert not pbe.dispatch_degraded()
    faults.set_fault(faults.DISPATCH, "fail-device", 0)
    faults.set_fault(faults.TRANSFER, "fail-device", 1)
    try:
        with pytest.raises(RuntimeError, match="no device left"):
            v.verify_batch(vectors.valid_items(np.random.default_rng(3),
                                               2))
    finally:
        faults.clear()
    assert v.health.quarantined(2) == [0, 1]
    return name


def _ladder_run(vs):
    gate = GateVerifier()
    svc = vs.VerifyService(verifier=gate, lane_depth=256,
                           lane_bytes=10**7, max_batch=2,
                           pipeline_depth=1).start()
    tickets = [_park(svc, gate)]
    arrivals = [(ln, None, 100 * j + k, 2)
                for k in range(24) for j, ln in enumerate(vs.LANES)]
    refusals, more = _arrive(vs, svc, arrivals)
    tickets += more
    gate.gate.set()
    for t in tickets:
        _outcome(vs, t)
    svc.stop(drain=True, timeout=30)
    return _record(vs, svc, refusals, tickets)


def test_level2_ladder_equals_reference():
    """Dispatch degraded: the reference's tripped breaker, the port's
    every index quarantined. Both shed bulk at keep 1/8 and auth at 1/2,
    never scp, with equal decision logs and journals."""
    backoff = (jbv._breaker._backoff_min, jbv._breaker._backoff_max)
    jbv.configure_dispatch(backoff_min_s=30.0, backoff_max_s=60.0)
    jbv._breaker.trip()
    name = _quarantine_every_index()
    try:
        assert jbv.dispatch_degraded() and pbe.dispatch_degraded()
        ref, port = _ladder_run(jvs), _ladder_run(pvs)
    finally:
        with pbe._engines_lock:
            pbe._default_engines.pop(name)
        jbv.configure_dispatch(backoff_min_s=backoff[0],
                               backoff_max_s=backoff[1])
    assert not pbe.dispatch_degraded()
    for key in ref:
        assert port[key] == ref[key], key
    shed = [d for d in port["decisions"] if d[0] == "shed"]
    assert {d[1] for d in shed} == {"bulk", "auth"}
    assert all(d[4] == 2 for d in shed)
    assert all(o[2] == "dispatch-degraded"
               for o in port["outcomes"] if o[0] == "shed")
    assert port["lanes"]["scp"]["shed"] == 0
    assert port["lanes"]["bulk"]["shed"] > port["lanes"]["auth"]["shed"]


def test_probe_dead_is_degraded():
    pbe._device_state = "dead"
    try:
        assert pbe.dispatch_degraded()
    finally:
        pbe._reset_dispatch_state_for_testing()
    assert not pbe.dispatch_degraded()


# ---------------- shed draw, burn windows, controller ----------------


def test_keep_under_shed_equals_reference():
    rng = np.random.default_rng(61)
    for _ in range(300):
        material = rng.bytes(int(rng.integers(0, 200)))
        frac = float(rng.choice([0.0, 0.125, 0.3, 0.5, 0.99, 1.0, 1.5]))
        tenant = rng.choice([b"", b"flood", b"t-7"])
        assert paudit.keep_under_shed(material, frac, tenant=tenant) == \
            jaudit.keep_under_shed(material, frac, tenant=tenant)


def test_burn_window_helpers_equal_reference():
    rng = np.random.default_rng(62)
    for window in (8, 33):
        ours, theirs = pmetrics.fresh_burn_window(), \
            jmetrics.fresh_burn_window()
        assert ours == theirs
        for _ in range(200):
            bad, n = bool(rng.integers(0, 2)), int(rng.integers(0, 9))
            pmetrics.push_burn_window(ours, bad, n, window)
            jmetrics.push_burn_window(theirs, bad, n, window)
            assert ours == theirs and len(ours["events"]) <= window
        pmetrics.trim_burn_window(ours, 5)
        jmetrics.trim_burn_window(theirs, 5)
        assert ours == theirs and isinstance(ours["events"], deque)


def _windows(rng, n):
    """Seeded telemetry windows in blocks of 16 of one regime each:
    bulk pressure, an scp threat, healthy, and noise over every band."""
    out = []
    for k in range(n):
        regime = (k // 16) % 4
        scp_burn = [0.0, 1.5, 0.1, float(rng.choice([0, .3, .9, 1.5]))]
        bulk_burn = [2.0, 0.0, 0.1, float(rng.choice([0, .4, 1.2, 3.0]))]
        backlog = [int(rng.integers(200, 400)), 0, int(rng.integers(0, 50)),
                   int(rng.integers(0, 400))]
        out.append({
            "lanes": {
                "scp": {"latency_burn": scp_burn[regime],
                        "shed_burn": float(rng.choice([0, 0, .2])),
                        "queued_submissions": int(rng.integers(0, 3))},
                "bulk": {"shed_burn": bulk_burn[regime],
                         "queued_submissions": backlog[regime]}},
            "lane_depth": 512,
            "queue_wait_frac": float(rng.choice([0.1, 0.6])),
            "scp_hol_age": int(rng.integers(0, 600)) if regime == 3
            else 0,
            "pressure": int(rng.choice([0, 0, 1, 2])) if regime == 3
            else 0})
    return out


def test_controller_step_and_replay_equal_reference():
    windows = _windows(np.random.default_rng(63), 160)
    ours = pctl.VerifyController(2048, 4, 0.75)
    theirs = jctl.VerifyController(2048, 4, 0.75)
    for w in windows:
        assert ours.step(w) == theirs.step(w)
        assert ours.knobs() == theirs.knobs()
    assert ours.control_log() == theirs.control_log()
    assert ours.journal_log() == theirs.journal_log()
    assert ours.snapshot() == theirs.snapshot()
    actions = {e[0] for e in ours.control_log()}
    assert {"grow", "shrink", "relax", "hold"} <= actions, actions
    assert ours.replay(ours.windows()) == theirs.replay(windows) == \
        ours.control_log()


# ---------------- the trickle batcher ----------------


class _OracleBatch:
    """A ``verify_batch`` stand-in over the reference's oracle."""

    def verify_batch(self, items):
        return np.array([jref.verify(*it) for it in items])


def _concurrent(batcher, items):
    out = [None] * len(items)

    def call(i):
        try:
            out[i] = batcher.verify_sig(*items[i])
        except BaseException as e:  # noqa: BLE001 (recorded)
            out[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(items))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "a caller hangs"
    return out, time.monotonic() - t0


def test_trickle_verdicts_under_concurrent_callers():
    rng = np.random.default_rng(64)
    items = vectors.valid_items(rng, 4)
    items[1] = (items[1][0], b"tampered", items[1][2])
    items.append(vectors.edge_corpus(rng)[2])
    want = [jref.verify(*it) for it in items]
    assert want == [True, False, True, True, False]
    ours = pbv.TrickleBatcher(
        pbv.BatchVerifier(device="cpu", bucket_sizes=(16,)),
        window_ms=500.0)
    theirs = jbv.TrickleBatcher(_OracleBatch(), window_ms=500.0)
    got, _ = _concurrent(ours, items)
    assert got == want
    assert _concurrent(theirs, items)[0] == want
    assert 1 <= ours.dispatches < len(items)


def test_trickle_leader_failure_reaches_every_parked_caller():
    """A window's leader whose dispatch fails (every launch of the port's
    CPU verifier fails under ``fail-device``) sets the failure on every
    parked future: each caller raises, none hangs."""
    items = vectors.valid_items(np.random.default_rng(65), 6)
    v = pbv.BatchVerifier(device="cpu", bucket_sizes=(16,))
    batcher = pbv.TrickleBatcher(v, window_ms=300.0)
    faults.set_fault(faults.DISPATCH, "fail-device", 0)
    try:
        got, secs = _concurrent(batcher, items)
    finally:
        faults.clear()
    assert secs < 2.0
    assert all(isinstance(e, RuntimeError) and
               isinstance(e.__cause__, faults.FaultInjected) for e in got)
    assert batcher.dispatches < len(items)
    assert not batcher._pending and not batcher._leader_active

    class Failing:
        def verify_batch(self, items):
            raise RuntimeError("dispatch failed")

    ref = jbv.TrickleBatcher(Failing(), window_ms=300.0)
    ref_got, _ = _concurrent(ref, items)
    assert [type(e) for e in ref_got] == [RuntimeError] * len(items)


def _bound_and_flush(tb_cls, overloaded):
    """The bounded queue and a flush racing a window close (the
    reference's chaos shape): returns what a caller can observe."""
    class Recording:
        def __init__(self):
            self.batches = []

        def verify_batch(self, items):
            self.batches.append(len(items))
            return np.ones(len(items), dtype=bool)

    vb = Recording()
    batcher = tb_cls(vb, window_ms=60_000.0, max_batch=100, max_pending=3)
    items = _items(1, 4)
    results = [None] * 3
    threads = [threading.Thread(
        target=lambda i=i: results.__setitem__(
            i, batcher.verify_sig(*items[i]))) for i in range(3)]
    for t in threads:
        t.start()
    _wait_for(lambda: len(batcher._pending) == 3, "callers never queued")
    with pytest.raises(overloaded) as ei:
        batcher.verify_sig(*items[3])
    refused = (ei.value.kind, ei.value.lane, ei.value.reason,
               batcher.rejected)
    flushed = batcher.flush()    # the leader owns the batch: wakes it
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    fut = Future()
    with batcher._cv:
        batcher._pending.append((items[0], fut))
    claimed = batcher.flush()    # no leader: flush claims it
    return {"refused": refused, "flushed": flushed, "results": results,
            "batches": vb.batches, "claimed": claimed,
            "claimed_result": fut.result(timeout=5),
            "empty_flush": batcher.flush(),
            "dispatches": batcher.dispatches}


def test_trickle_bound_and_flush_race_equal_reference():
    ours = _bound_and_flush(pbv.TrickleBatcher, pres.Overloaded)
    theirs = _bound_and_flush(jbv.TrickleBatcher, jvs.Overloaded)
    assert ours == theirs
    assert ours["refused"] == ("rejected", "trickle", "queue-depth", 1)
    assert ours["batches"] == [3, 1] and ours["flushed"] == 0


# ---------------- end to end ----------------


def test_service_end_to_end_on_the_edge_corpus():
    """The port's service over the CPU verifier: the edge corpus split
    over the three lanes, every verdict equal to the reference oracle,
    the conservation law at 0, the service in ``dispatch_health()``."""
    items = vectors.edge_corpus(np.random.default_rng(66))
    assert len(items) == 45
    want = np.array([jref.verify(*it) for it in items])
    svc = pvs.VerifyService(
        verifier=pbv.BatchVerifier(device="cpu", bucket_sizes=(16,)),
        max_batch=16).start()
    try:
        tickets = [(svc.submit(items[i:i + 15], lane=pvs.LANES[k]), i)
                   for k, i in enumerate(range(0, len(items), 15))]
        for tkt, i in tickets:
            assert np.array_equal(tkt.result(timeout=120),
                                  want[i:i + 15]), i
        health = pbe.dispatch_health()["service"]
    finally:
        svc.stop(drain=True, timeout=30)
    assert health["conservation_gap"] == 0
    assert health["totals"]["verified"] == len(items)
    assert all(health["lanes"][ln]["verified"] > 0 for ln in pvs.LANES)
    assert svc.snapshot()["totals"]["failed"] == 0


# ---------------- the process-wide service and concurrent callers -------


class _OracleVerifier:
    """A stand-in verifier answering with the reference's oracle."""

    def submit(self, items, trace_ids=None):
        out = np.array([jref.verify(*it) for it in items], dtype=bool)
        return lambda: out


def test_service_verified_seeds_the_node_cache():
    """``service_verified`` through the process-wide service answers the
    oracle's verdicts and seeds each package's own ``keys`` cache; with
    no service it answers None and counts the fallback. The health
    payloads have the reference's shape."""
    from stellar_tpu.crypto import keys as jkeys
    from stellar_tpu_torch.crypto import keys as pkeys
    items = vectors.edge_corpus(np.random.default_rng(67))[:12]
    want = [jref.verify(*it) for it in items]
    out = {}
    for name, (vs, _tn), keys in (("reference", PACKAGES["reference"], jkeys),
                                  ("port", PACKAGES["port"], pkeys)):
        keys.flush_verify_cache()
        assert vs.running_service() is None
        assert vs.service_verified(items, lane="auth") is None
        svc = vs.VerifyService(verifier=_OracleVerifier()).start()
        saved = vs._service
        vs._service = svc
        try:
            assert vs.running_service() is svc
            got = vs.service_verified(items, lane="auth")
            cached = [keys.cached_verify_sig(*it) for it in items]
            health = (vs.service_health(), vs.tenant_health(),
                      vs.control_health(), vs.lane_latencies())
        finally:
            vs._service = saved
            svc.stop(drain=True, timeout=30)
            keys.flush_verify_cache()
        assert got == want
        assert cached == [w if len(it[0]) == 32 and len(it[2]) == 64
                          else False for it, w in zip(items, want)]
        out[name] = health
    ours, theirs = out["port"], out["reference"]
    assert set(ours[0]) == set(theirs[0])
    assert ours[0]["totals"] == theirs[0]["totals"]
    assert set(ours[1]) == set(theirs[1]) and \
        set(ours[1]["slo"]) == set(theirs[1]["slo"])
    assert ours[2] == theirs[2]
    assert set(ours[3]) == set(theirs[3]) == set(pvs.LANES)
    assert pmetrics.registry.meter(
        "crypto.verify.service.adopter_fallback.auth.absent").count > 0


def test_concurrent_submitters_conserve_work():
    """Many threads (more than cores) submit to one port service, the
    interpreter switching threads every microsecond: every item ends
    verified, and the lane and tenant conservation laws read 0."""
    import sys
    threads_n, per = 24, 40
    svc = pvs.VerifyService(verifier=GateVerifier(), lane_depth=4096,
                            max_batch=8, pipeline_depth=2)
    svc._verifier.gate.set()
    svc.start()
    errors = []

    def work(w):
        try:
            for k in range(per):
                lane = pvs.LANES[(w + k) % 3]
                svc.submit(_items(1000 * w + k, 1 + k % 3), lane=lane,
                           tenant=f"t{w % 5}").result(timeout=30)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    svc.stop(drain=True, timeout=30)
    assert not errors, errors[:3]
    snap = svc.snapshot()
    items = threads_n * sum(1 + k % 3 for k in range(per))
    assert snap["conservation_gap"] == 0
    assert snap["totals"]["submitted"] == snap["totals"]["verified"] == \
        items
    assert svc.tenant_snapshot()["conservation_violations"] == {}
    assert svc.journal_totals()["verified"] == items
