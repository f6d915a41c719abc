"""The engine's fault domains on the CPU: per-device breakers, quarantine
and re-shard over the survivors, probation healing, the sampled audit's
conviction, faults that move rows to another device and raise when none
is left (no row is ever recomputed on the host in a device's place), and
build failures that raise.

The state machines run over a cheap toy workload (the plain verify kernel
takes about a second a call here); the real verifier runs the
reference's device-domain scenarios (``tests/_device_domain_script.py``)
on four CPU indices. ``DeviceHealth``, ``CircuitBreaker`` and the audit
sampler are held against the reference's jax-free modules, driven by the
same event sequence under one fake clock."""

import time

import numpy as np
import pytest
import torch

from stellar_tpu.crypto import audit as jaudit
from stellar_tpu.parallel import device_health as jdh
from stellar_tpu.utils import resilience as jres
from stellar_tpu_torch.crypto import audit
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import native_verify, vectors
from stellar_tpu_torch.crypto.batch_verifier import (BatchVerifier,
                                                     Ed25519Workload)
from stellar_tpu_torch.ops import _build
from stellar_tpu_torch.parallel import batch_engine as be
from stellar_tpu_torch.parallel import device_health, signer_tables
from stellar_tpu_torch.parallel.batch_engine import BatchEngine, Workload
from stellar_tpu_torch.utils import faults, resilience

N_DEV = 4


@pytest.fixture(autouse=True)
def fresh_dispatch(monkeypatch):
    """Every test starts and ends with no fault armed, the signer-table
    cache empty, and the audit rate and launch retries as they were;
    breakers belong to each test's own engines."""
    monkeypatch.setattr(be, "AUDIT_RATE", be.AUDIT_RATE)
    monkeypatch.setattr(be, "DISPATCH_RETRIES", be.DISPATCH_RETRIES)
    faults.clear()
    signer_tables.signer_table_cache._reset_for_testing()
    yield
    faults.clear()
    signer_tables.signer_table_cache._reset_for_testing()


def _policy(eng, audit_rate=1.0, backoff_s=0.05):
    """The reference script's policy on ``eng``, with a short backoff: no
    launch retry, per-device threshold 2, every gate-passing row
    audited."""
    be.DISPATCH_RETRIES = 0
    be.configure_dispatch(audit_rate=audit_rate)
    eng.health.configure(failure_threshold=2, backoff_min_s=backoff_s,
                         backoff_max_s=2 * backoff_s)
    return eng


class ToyWorkload(Workload):
    """Items are ints; the 'kernel' doubles them; negative items fail
    the gate and finalize to -1."""

    variant_name = None

    def __init__(self):
        self.convicted = []

    def encode(self, items):
        arr = np.asarray(items, dtype=np.int64)[:, None]
        return arr[:, 0] >= 0, (arr,)

    def pad_rows(self):
        return (np.zeros((1, 1), np.int64),)

    def kernel_fn(self):
        return lambda x: x[:, 0] * 2

    def empty_result(self, n):
        return np.zeros(n, np.int64)

    def host_result(self, items):
        return np.asarray(items, dtype=np.int64) * 2

    def on_audit_conviction(self, items):
        self.convicted.append(list(items))

    def finalize(self, gate, out, items):
        return np.where(gate, out, -1)


def _toy(devices=N_DEV, buckets=(8,)):
    return BatchEngine(ToyWorkload(), devices=["cpu"] * devices,
                       bucket_sizes=buckets)


def _want(items):
    return np.array([2 * i if i >= 0 else -1 for i in items])


def _served_delta(engine, before):
    return {k: engine.device_served.get(k, 0) - before.get(k, 0)
            for k in range(N_DEV)}


def test_toy_split_serves_every_index():
    eng = _policy(_toy())
    items = list(range(16))  # two chunks of bucket 8: 2 rows a part
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert eng.device_served == {0: 4, 1: 4, 2: 4, 3: 4}
    assert eng.served == {"device": 16, "host": 0}
    # the audit ran on every part, clean
    assert len(eng.audit_verdicts) == 8
    assert all(v["ok"] for v in eng.audit_verdicts)


def test_pure_padding_tail_parts_are_skipped():
    eng = _toy()
    eng.compute_batch([1, 2, 3])  # bucket 8, parts of 2: two carry rows
    assert set(eng.device_served) == {0, 1}


def test_indivisible_bucket_runs_unsplit():
    eng = _toy(devices=3)
    items = list(range(7))
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert eng.device_served == {0: 7} and eng.served["device"] == 7


def test_fail_device_quarantines_only_that_index_then_heals():
    eng = _policy(_toy(), backoff_s=0.05)
    items = list(range(16))
    faults.set_fault(faults.DISPATCH, "fail-device", 1)
    # two failed launches on index 1 (one a chunk) open its breaker; each
    # time its part moves to a survivor
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert eng.health.quarantined(N_DEV) == [1]
    assert eng.device_served.get(1, 0) == 0
    assert eng.served["device"] == 16
    # degraded: the survivors take index 1's share at the same shape
    before = dict(eng.device_served)
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    delta = _served_delta(eng, before)
    assert delta[1] == 0 and sum(delta.values()) == 16
    assert all(delta[k] > 0 for k in (0, 2, 3))
    # healed: after the backoff one probation part re-closes index 1
    faults.clear()
    time.sleep(0.25)
    before = dict(eng.device_served)
    eng.compute_batch(items)
    assert eng.health.breaker(1).state == resilience.CLOSED
    eng.compute_batch(items)
    assert _served_delta(eng, before)[1] > 0
    assert eng.health.quarantined(N_DEV) == []


def test_probation_failure_reopens_with_longer_backoff():
    eng = _policy(_toy(), backoff_s=0.05)
    faults.set_fault(faults.DISPATCH, "fail-device", 2)
    eng.compute_batch(list(range(16)))
    br = eng.health.breaker(2)
    assert br.state == resilience.OPEN
    time.sleep(0.25)
    items = list(range(8))  # the probation part fails and moves
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert br.state == resilience.OPEN
    assert br.snapshot()["backoff_s"] == 0.1


def test_corrupt_device_is_convicted_and_never_surfaces():
    eng = _policy(_toy(), backoff_s=0.05)
    items = list(range(16))
    faults.set_fault(faults.RESOLVE, "corrupt-device", 2)
    got = eng.compute_batch(items)
    np.testing.assert_array_equal(got, _want(items))
    assert eng.health.quarantined(N_DEV) == [2]
    assert eng.convicted == {2}
    assert eng.audit_mismatches == 1
    assert eng._plugin.convicted == [[4, 5]]
    assert not any(v["ok"] for v in eng.audit_verdicts
                   if v["device"] == 2)
    # every row was served by a device, none by the convicted one: the
    # second chunk's part on index 2 moved without being read
    assert eng.served["device"] == 16 and eng.device_served.get(2, 0) == 0
    # a conviction is for good: past the backoff index 2 gets no
    # probation part, and the survivors serve
    faults.clear()
    time.sleep(0.25)
    before = dict(eng.device_served)
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    delta = _served_delta(eng, before)
    assert delta[2] == 0 and sum(delta.values()) == 16
    assert eng.health.quarantined(N_DEV) == [2]


def test_gate_failed_rows_are_never_audited():
    eng = _policy(_toy())
    faults.set_fault(faults.RESOLVE, "corrupt-device", 0)
    items = [-1, -2, 3, 4, 5, 6, 7, 8]  # index 0 serves two gate-False rows
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert eng.health.quarantined(N_DEV) == [] and not eng.convicted


def test_unsplit_launch_fault_raises():
    """One device and a launch fault: nothing to move the rows to, so the
    call raises; its breaker then refuses calls until the backoff, and a
    probation call after it heals."""
    eng = _policy(BatchEngine(ToyWorkload(), device="cpu",
                              bucket_sizes=(8,)), backoff_s=0.05)
    faults.set_fault(faults.DISPATCH, "raise")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no device left") as err:
            eng.compute_batch([1, 2])
        assert isinstance(err.value.__cause__, faults.FaultInjected)
    assert eng.health.breaker(0).state == resilience.OPEN
    assert eng.served["device"] == 0
    faults.clear()
    with pytest.raises(RuntimeError, match="no device left"):
        eng.compute_batch([1, 2])  # open: refused without a launch
    time.sleep(0.25)
    np.testing.assert_array_equal(eng.compute_batch([1, 2]), [2, 4])
    assert eng.health.breaker(0).state == resilience.CLOSED


def test_every_device_failing_raises():
    eng = _policy(_toy())
    faults.set_fault(faults.DISPATCH, "raise")
    with pytest.raises(RuntimeError, match="no device left"):
        eng.compute_batch(list(range(8)))
    assert eng.served["device"] == 0


def test_convicted_single_device_raises():
    """The audit convicts the only device: the call raises rather than
    return its bits or recompute them on the host, and so does every
    later call."""
    eng = _policy(BatchEngine(ToyWorkload(), device="cpu",
                              bucket_sizes=(4,)))
    faults.set_fault(faults.RESOLVE, "corrupt-device", 0)
    with pytest.raises(RuntimeError, match="no device left"):
        eng.compute_batch([1, 2, 3])
    assert eng.convicted == {0} and eng._plugin.convicted == [[1, 2, 3]]
    faults.clear()
    with pytest.raises(RuntimeError, match="no device left"):
        eng.compute_batch([1, 2, 3])
    assert eng.served["device"] == 0


def test_two_engines_share_no_breaker():
    """Breakers belong to an engine: faults that bench index 1 of one
    engine leave another engine's index 1 in service."""
    first = _policy(_toy(devices=2, buckets=(4,)))
    second = _policy(_toy())
    faults.set_fault(faults.DISPATCH, "fail-device", 1)
    for _ in range(2):
        first.compute_batch([1, 2, 3, 4])
    assert first.health.quarantined(2) == [1]
    faults.clear()
    items = list(range(8))
    np.testing.assert_array_equal(second.compute_batch(items), _want(items))
    assert second.health.quarantined(N_DEV) == []
    assert second.device_served == {0: 2, 1: 2, 2: 2, 3: 2}


def test_retry_absorbs_one_launch_failure():
    be.DISPATCH_RETRIES = 1
    eng = _toy()
    faults.set_fault(faults.DISPATCH, "failn", 1)
    items = list(range(8))
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert eng.retries == 1
    assert eng.device_served == {0: 2, 1: 2, 2: 2, 3: 2}
    assert eng.health.snapshot()["devices"]["0"]["consecutive_failures"] \
        == 0


def test_transfer_and_resolve_faults_move_to_another_device():
    eng = _policy(_toy())
    items = list(range(8))
    faults.set_fault(faults.TRANSFER, "fail-device", 3)
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert eng.device_served.get(3, 0) == 0
    faults.clear()
    faults.set_fault(faults.RESOLVE, "fail-device", 0)
    np.testing.assert_array_equal(eng.compute_batch(items), _want(items))
    assert faults.counters()[faults.RESOLVE]["fired"] == 1
    assert eng.served["device"] == 16
    # index 3's first part moved to index 0, index 0's second part to
    # index 1; index 3 served again (a success resets its streak)
    assert eng.device_served == {0: 4, 1: 6, 2: 4, 3: 2}
    failures = {k: d["consecutive_failures"]
                for k, d in eng.health.snapshot()["devices"].items()}
    assert failures["3"] == 0 and failures["0"] == 1


class BrokenBuild(ToyWorkload):
    def prepare(self, device):
        raise RuntimeError("building the kernel library failed")


def test_build_failure_raises_instead_of_failing_over():
    eng = BatchEngine(BrokenBuild(), devices=["cpu"] * 2, bucket_sizes=(4,))
    with pytest.raises(RuntimeError, match="building"):
        eng.compute_batch([1, 2, 3])
    assert eng.served["device"] == 0
    assert eng.health.snapshot()["devices"] == {}


def test_verifier_library_build_failure_raises(monkeypatch):
    """The verifier's prepare builds its library for a card before any
    dispatch: with no compiler the error reaches the caller."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        Ed25519Workload().prepare(torch.device("cuda", 0))


def test_kernel_bug_is_not_a_device_fault():
    """A ValueError (bad operands: a program error) is not a device
    fault: it raises at once and moves nothing."""
    class Bad(ToyWorkload):
        def kernel_fn(self):
            def k(x):
                raise ValueError("operands of the wrong shape")
            return k

    eng = BatchEngine(Bad(), device="cpu", bucket_sizes=(4,))
    with pytest.raises(ValueError):
        eng.compute_batch([1])
    assert eng.health.snapshot()["devices"]["0"]["consecutive_failures"] \
        == 0


# ---------------- the real verifier ----------------


def _pool_items(n, rng):
    """n items tiled from a small signed pool, most of them valid (the
    reference script's pool: good signatures, a tampered message and a
    bad key length), and the oracle's verdicts."""
    pool = vectors.valid_items(rng, 4, msg_len=lambda i: 1 + i)
    pk0, m0, s0 = pool[0]
    pool += [(pk0, m0 + b"!", s0), (pk0[:31], m0, s0)]
    want = np.array([ref.verify(*it) for it in pool])
    idx = np.arange(n) % len(pool)
    return [pool[i] for i in idx], want[idx]


def test_verifier_device_domain_scenarios():
    """The reference's device-domain scenarios on the port's verifier
    over 4 CPU indices, cache off: fail-device 1 quarantines only index
    1 and the survivors serve; after the backoff a probation sub-chunk
    heals it; corrupt-device 2 is convicted by the audit, which
    quarantines 2 for good; every verdict equals the oracle throughout
    and every row is served by a device."""
    # the breakers read a fake clock: a call of the plain kernel takes
    # seconds here, and only the clock decides when the backoff ends
    backoff = 4.0
    signer_tables.signer_table_cache.configure(enabled=False)
    v = _policy(BatchVerifier(devices=["cpu"] * N_DEV, bucket_sizes=(8,)),
                backoff_s=backoff)
    items, want = _pool_items(8, np.random.default_rng(71))
    health = v.health
    clock = FakeClock()
    for i in range(N_DEV):
        health.breaker(i)._clock = clock
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert sorted(v.device_served) == [0, 1, 2, 3]
    faults.set_fault(faults.DISPATCH, "fail-device", 1)
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert health.quarantined(N_DEV) == [] and \
        health.breaker(1).snapshot()["consecutive_failures"] == 1
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert health.quarantined(N_DEV) == [1]
    before = dict(v.device_served)
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert v.device_served[1] == before[1]
    faults.clear()
    clock.t += 1.15 * backoff  # past the backoff and its 10% jitter
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert health.breaker(1).state == resilience.CLOSED
    assert v.device_served[1] > before[1]
    faults.set_fault(faults.RESOLVE, "corrupt-device", 2)
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert health.quarantined(N_DEV) == [2]
    assert v.convicted == {2} and v.audit_mismatches == 1
    served2 = v.device_served[2]
    faults.clear()
    clock.t += 2.3 * backoff  # a conviction is for good, backoff or not
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert v.device_served[2] == served2
    # 7 calls of 8 rows, every row's part accepted from a device
    assert v.served["device"] == 7 * len(items)


def test_hot_conviction_evicts_the_signer_table():
    """A conviction over a hot-served part evicts the tables that served
    it (the reference's phases 6-7); the part moves to the survivor."""
    cache = signer_tables.signer_table_cache
    cache.configure(enabled=True)
    rng = np.random.default_rng(72)
    seed, pk = vectors.keypair(rng)
    items = [(pk, b"hot-%d" % i, ref.sign(seed, b"hot-%d" % i))
             for i in range(4)]
    v = _policy(BatchVerifier(devices=["cpu"] * 2, bucket_sizes=(4,)))
    assert v.verify_batch(items).all()
    assert v.served["hot"] == 3 and cache.lookup(pk) is not None
    faults.set_fault(faults.RESOLVE, "corrupt-device", 1)
    assert v.verify_batch(items).all()
    assert v.audit_mismatches == 1 and v.convicted == {1}
    assert cache.lookup(pk) is None
    assert v.served["hot"] == 7


def test_launch_fault_moves_verdicts_to_a_survivor():
    """Every launch on index 0 fails: its rows are verified on index 1,
    equal to the oracle on the edge corpus, and none on the host."""
    signer_tables.signer_table_cache.configure(enabled=False)
    rng = np.random.default_rng(73)
    items = vectors.edge_corpus(rng) + vectors.valid_items(rng, 3)
    want = np.array([ref.verify(*it) for it in items])
    v = _policy(BatchVerifier(devices=["cpu"] * 2, bucket_sizes=(64,)))
    faults.set_fault(faults.DISPATCH, "fail-device", 0)
    np.testing.assert_array_equal(v.verify_batch(items), want)
    assert v.device_served.get(0, 0) == 0
    assert v.served["device"] == v.device_served[1] == len(items)


@pytest.mark.parametrize("native", [True, False])
def test_host_oracle_backends_equal_the_oracle(native, monkeypatch):
    """The host oracle, through the native libcrypto batch and through
    the pure-Python fallback, gives libsodium's decision on the edge
    corpus, good signatures and tampered ones."""
    if not native:
        monkeypatch.setattr(native_verify, "available", lambda: False)
    assert native_verify.backend() == ("native" if native else "python")
    rng = np.random.default_rng(74)
    items = vectors.edge_corpus(rng) + vectors.valid_items(rng, 6)
    items += [(pk, msg + b"?", sig) for pk, msg, sig in items[-3:]]
    want = np.array([ref.verify(*it) for it in items])
    np.testing.assert_array_equal(native_verify.host_verify(items), want)
    assert want.any() and not want.all()


# ---------------- against the reference's modules ----------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _fake_rng():
    vals = iter(np.random.default_rng(75).random(1000).tolist())
    return lambda: next(vals)


def _breaker_pair(clock, **kw):
    return (resilience.CircuitBreaker(clock=clock, rng=_fake_rng(), **kw),
            jres.CircuitBreaker(clock=clock, rng=_fake_rng(), **kw))


def test_circuit_breaker_matches_the_reference():
    clock = FakeClock()
    trans = ([], [])
    mine, theirs = _breaker_pair(
        clock, failure_threshold=3, backoff_min_s=1.0, backoff_max_s=8.0)
    mine._on_transition = lambda o, n: trans[0].append((o, n))
    theirs._on_transition = lambda o, n: trans[1].append((o, n))
    events = (["fail"] * 2 + ["ok", "fail", "fail", "fail", "allow",
                              "tick:0.5", "allow", "tick:1.2", "allow",
                              "allow", "fail", "tick:1.5", "allow",
                              "tick:2.5", "allow", "tick:2.5", "allow",
                              "ok", "trip", "allow", "tick:9", "allow",
                              "trip", "tick:20", "allow", "fail",
                              "tick:50", "allow", "ok", "allow"])
    for ev in events:
        outs = []
        for br in (mine, theirs):
            if ev == "fail":
                outs.append(br.record_failure())
            elif ev == "ok":
                outs.append(br.record_success())
            elif ev == "trip":
                outs.append(br.trip())
            elif ev == "allow":
                outs.append(br.allow())
            else:
                outs.append(None)
        if ev.startswith("tick:"):
            clock.t += float(ev[5:])
        assert outs[0] == outs[1], ev
        assert mine.snapshot() == theirs.snapshot(), ev
        assert mine.seconds_until_retry() == theirs.seconds_until_retry()
    assert trans[0] == trans[1] and len(trans[0]) >= 8


def _health_pair(clock, n):
    pair = (device_health.DeviceHealth(failure_threshold=2,
                                       backoff_min_s=0.5,
                                       backoff_max_s=4.0),
            jdh.DeviceHealth(failure_threshold=2, backoff_min_s=0.5,
                             backoff_max_s=4.0))
    for h in pair:
        rng = _fake_rng()
        for i in range(n):
            br = h.breaker(i)
            br._clock = clock
            br._rng = rng
    return pair


def test_device_health_matches_the_reference():
    """The same events under one fake clock: equal breaker states,
    assignments, quarantine lists, history and audit tallies."""
    clock = FakeClock()
    mine, theirs = _health_pair(clock, 4)
    events = [("fail", 1), ("assign", 4), ("fail", 1), ("assign", 4),
              ("assign", 2), ("audit", 0, True), ("quarantine", 2),
              ("audit", 2, False), ("assign", 4), ("tick", 0.8),
              ("assign", 1), ("assign", 4), ("assign", 4), ("ok", 1),
              ("assign", 4), ("fail", 3), ("fail", 3), ("tick", 0.2),
              ("assign", 3), ("tick", 5.0), ("assign", 4), ("fail", 2),
              ("audit", None, True), ("tick", 10.0), ("assign", 4),
              ("ok", 2), ("ok", 3), ("assign", 4)]
    for ev in events:
        outs = []
        for h in (mine, theirs):
            kind = ev[0]
            if kind == "fail":
                outs.append(h.record_failure(ev[1]))
            elif kind == "ok":
                outs.append(h.record_success(ev[1]))
            elif kind == "quarantine":
                outs.append(h.quarantine(ev[1], reason="audit-mismatch"))
            elif kind == "audit":
                outs.append(h.note_audit(ev[1], ok=ev[2], sampled=3))
            elif kind == "assign":
                outs.append(h.assign_parts(4, ev[1]))
            else:
                outs.append(None)
        if ev[0] == "tick":
            clock.t += ev[1]
        assert outs[0] == outs[1], ev
        assert mine.snapshot() == theirs.snapshot(), ev
        assert mine.quarantined(4) == theirs.quarantined(4), ev
    assert mine.history() == theirs.history()
    assert [e["device"] for e in mine.history()
            if e.get("event") == "quarantine"] == [2]


def test_assign_parts_skips_excluded_devices():
    """The port's one addition to ``assign_parts``: a convicted index
    gets no part and no probation grant; with none excluded it is the
    reference's assignment."""
    clock = FakeClock()
    mine, theirs = _health_pair(clock, 4)
    for h in (mine, theirs):
        h.quarantine(2)
    clock.t += 10.0
    assert mine.assign_parts(4, 4, exclude=()) == theirs.assign_parts(4, 4)
    mine, _ = _health_pair(clock, 4)
    mine.quarantine(2)
    clock.t += 10.0
    assert mine.assign_parts(4, 4, exclude={2}) == [0, 1, 3, 0]
    assert mine.breaker(2).state == resilience.OPEN
    assert mine.assign_parts(4, 2, exclude={0, 1, 2, 3}) == [None, None]


@pytest.mark.parametrize("rate", [0.0, 0.02, 0.1, 0.5, 1.0])
def test_audit_sampler_matches_the_reference(rate):
    rng = np.random.default_rng(76)
    for n in (0, 1, 7, 50, 500):
        material = rng.bytes(64 + n)
        assert audit.sample_indices(material, n, rate) == \
            jaudit.sample_indices(material, n, rate)
        eligible = sorted(rng.choice(max(n, 1) * 2, size=n,
                                     replace=False).tolist())
        assert audit.sample_rows(material, eligible, rate) == \
            jaudit.sample_rows(material, eligible, rate)
    assert audit.verdict_record(None, 3, 9, 2, True) == \
        jaudit.verdict_record(None, 3, 9, 2, True)
    assert audit.verdict_record(2, 0, 4, 1, False) == \
        jaudit.verdict_record(2, 0, 4, 1, False)
