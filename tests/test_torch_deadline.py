"""The deadline-guarded resolve, the watchdog, the hang and stall faults
and the device probe, on the CPU.

* ``call_with_deadline``, ``Deadline`` and ``WatchdogPool.stats()``
  behave as the reference's on a return, a raise and a hang; the fault
  modes count as the reference's do.
* The engine (a toy workload on CPU indices): a ``hang`` at ``RESOLVE``
  charges index 0, counts a deadline miss, dumps the flight recorder
  with the fetch spans open, and moves the part; the abandoned fetch's
  late completion moves no count. A one-device engine raises within the
  deadline plus 0.5 s. A part whose breaker is already open is moved
  without a wait. The verifier on the edge corpus under the same fault
  is held against the JAX ``BatchVerifier`` in ``tests/test_torch_hot.py``
  (its B = 16 compile lives there).
* The probe: no card here answers ``"cpu"`` for good; a hung probe
  answers False without caching and heals after its backoff.
* ``dispatch_health`` against the reference's keys.

Hangs are 1 s or less, deadlines 100-200 ms."""

import threading
import time

import numpy as np
import pytest

from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.utils import faults as jfaults
from stellar_tpu.utils import resilience as jres
from stellar_tpu_torch.parallel import batch_engine as be
from stellar_tpu_torch.parallel.batch_engine import BatchEngine, Workload
from stellar_tpu_torch.utils import faults, resilience, tracing
from stellar_tpu_torch.utils.metrics import registry
from stellar_tpu_torch.utils.timeline import pipeline_timeline

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def fresh_dispatch_state():
    """No fault armed, the probe as at process start, and the dispatch
    knobs restored after the test."""
    saved = (be.DEADLINE_MS, be.DISPATCH_RETRIES, be.AUDIT_RATE,
             be._probe_breaker._threshold, be._probe_breaker._backoff_min,
             be._probe_breaker._backoff_max)
    faults.clear()
    be._reset_dispatch_state_for_testing()
    yield
    faults.clear()
    be.configure_dispatch(deadline_ms=saved[0], dispatch_retries=saved[1],
                          audit_rate=saved[2], failure_threshold=saved[3],
                          backoff_min_s=saved[4], backoff_max_s=saved[5])
    be._reset_dispatch_state_for_testing()


# ---------------- the watchdog against the reference ----------------


def _boom():
    raise ValueError("boom")


def test_call_with_deadline_matches_the_reference():
    for mod in (resilience, jres):
        assert mod.call_with_deadline(lambda: 7, 1.0) == 7
        assert mod.call_with_deadline(lambda: 5, None) == 5
        with pytest.raises(mod.DeadlineExceeded):
            mod.call_with_deadline(lambda: time.sleep(0.5), 0.05)
        with pytest.raises(ValueError, match="boom"):
            mod.call_with_deadline(_boom, 1.0)
        with pytest.raises(mod.DeadlineExceeded, match="no budget"):
            mod.call_with_deadline(lambda: 1, 0.0)
        assert set(mod.watchdog_stats()) == {"workers", "idle", "queued",
                                             "spawned_total"}
    assert not issubclass(resilience.DeadlineExceeded, RuntimeError)


def test_deadline_matches_the_reference():
    for mod in (resilience, jres):
        t = {"now": 10.0}
        d = mod.Deadline.from_ms(500, clock=lambda: t["now"])
        assert d.remaining() == 0.5 and not d.expired()
        t["now"] = 10.25
        assert d.elapsed() == 0.25 and d.remaining() == 0.25
        d.check("step")
        t["now"] = 10.5
        assert d.expired()
        with pytest.raises(mod.DeadlineExceeded, match="step: 0.500s"):
            d.check("step")


def _settle(pool, idle):
    for _ in range(500):
        if pool.stats()["idle"] == idle:
            return pool.stats()
        time.sleep(0.005)
    return pool.stats()


def _drive_pool(mod):
    """A return, a raise, a hang and a return while the hang holds its
    worker: the pool's stats after each, once its workers settle."""
    pool = mod.WatchdogPool(name="t-pool", max_idle=2)
    stats = []
    job = pool.submit(lambda: 1)
    assert job["done"].wait(5) and job["box"]["out"] == 1
    stats.append(_settle(pool, 1))
    job = pool.submit(_boom)
    assert job["done"].wait(5) and isinstance(job["box"]["err"], ValueError)
    stats.append(_settle(pool, 1))
    release = threading.Event()
    hang = pool.submit(release.wait)
    assert not hang["done"].wait(0.05)
    stats.append(_settle(pool, 0))
    job = pool.submit(lambda: 2)  # a fresh worker: the hung one is busy
    assert job["done"].wait(5) and job["box"]["out"] == 2
    stats.append(_settle(pool, 1))
    release.set()
    assert hang["done"].wait(5)
    stats.append(_settle(pool, 2))
    return stats


def test_watchdog_pool_stats_match_the_reference():
    got, want = _drive_pool(resilience), _drive_pool(jres)
    assert got == want
    assert got[-1] == {"workers": 2, "idle": 2, "queued": 0,
                       "spawned_total": 2}


def test_watchdog_and_registry_hold_under_contention():
    """More threads than cores, each making guarded calls that open a
    span and bump a counter, with a short switch interval: no call is
    lost, every count lands, and the pool ends with nothing queued."""
    import os
    import sys
    n_threads = 2 * (os.cpu_count() or 2) + 1
    calls = 50
    counter = registry.counter("test.contention.calls")
    before = counter.count
    pool = resilience.WatchdogPool(name="t-contention", max_idle=2)
    done = []

    def guarded():
        with tracing.span("test.contention"):
            counter.inc()
        return 1

    def worker():
        got = 0
        for _ in range(calls):
            job = pool.submit(guarded)
            assert job["done"].wait(10)
            got += job["box"]["out"]
        done.append(got)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert done == [calls] * n_threads
    assert counter.count - before == n_threads * calls
    assert pool.stats()["queued"] == 0


def _drive_faults(mod):
    mod.clear()
    mod.set_fault("x.hang", "hang", 0.01)
    mod.inject("x.hang")
    mod.inject("x.hang", device=3)
    mod.set_fault(mod.DISPATCH, "stall-device", 1, seconds=0.01)
    mod.inject(mod.DISPATCH, device=0)
    mod.inject(mod.DISPATCH, device=None)
    t = time.perf_counter()
    mod.inject(mod.DISPATCH, device=1)
    slept = time.perf_counter() - t
    mod.set_fault(mod.TRANSFER, "stall-transfer", 0, seconds=0.01)
    mod.inject(mod.TRANSFER, device=0)
    mod.set_fault(mod.PROBE, "raise")
    with pytest.raises(mod.FaultInjected):
        mod.inject(mod.PROBE)
    active = [mod.is_active(p) for p in (mod.PROBE, mod.RESOLVE)]
    with pytest.raises(ValueError):
        mod.set_fault("x", "stall-device")  # needs a device index
    with pytest.raises(ValueError):
        mod.set_fault("x", "no-such-mode")
    out = mod.counters()
    mod.clear()
    return out, active, slept


def test_fault_modes_count_as_the_reference():
    got, active, slept = _drive_faults(faults)
    want, j_active, _ = _drive_faults(jfaults)
    assert got == want and active == j_active == [True, False]
    assert got["x.hang"] == {"mode": "hang", "calls": 2, "fired": 2}
    assert got[faults.DISPATCH] == {"mode": "stall-device", "calls": 1,
                                    "fired": 1}
    assert slept >= 0.01
    assert (faults.PROBE, faults.TRANSFER, faults.DISPATCH,
            faults.RESOLVE) == (jfaults.PROBE, jfaults.TRANSFER,
                                jfaults.DISPATCH, jfaults.RESOLVE)
    assert faults.STALL_DEVICE_SECONDS == jfaults.STALL_DEVICE_SECONDS


# ---------------- the engine under hangs ----------------


class Doubler(Workload):
    """Items are ints; the 'kernel' doubles them; the host agrees."""

    def encode(self, items):
        arr = np.asarray(items, dtype=np.int64)[:, None]
        return np.ones(len(items), dtype=bool), (arr,)

    def pad_rows(self):
        return (np.zeros((1, 1), np.int64),)

    def kernel_fn(self):
        return lambda x: x[:, 0] * 2

    def empty_result(self, n):
        return np.zeros(n, np.int64)

    def host_result(self, items):
        return np.asarray(items, dtype=np.int64) * 2

    def finalize(self, gate, out, items):
        return out


def _engine(devices=2, threshold=2):
    be.configure_dispatch(audit_rate=1.0)
    eng = BatchEngine(Doubler(), devices=["cpu"] * devices,
                      bucket_sizes=(8,))
    eng.health.configure(failure_threshold=threshold, backoff_min_s=0.1,
                         backoff_max_s=0.2)
    return eng


def clear_when_fired(point):
    """Disarm ``point`` as soon as its fault has fired once (the hang it
    started goes on), so that only the first fetch hangs."""
    def run():
        for _ in range(2000):
            c = faults.counters().get(point)
            if c is None or c["fired"]:
                break
            time.sleep(0.002)
        faults.clear(point)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_missed_deadline_charges_the_device_and_moves_the_part():
    eng = _engine()
    be.configure_dispatch(deadline_ms=150)
    misses0 = registry.counter("crypto.verify.dispatch.deadline_miss").count
    tracing.flight_recorder.clear()
    faults.set_fault(faults.RESOLVE, "hang", 0.6)
    helper = clear_when_fired(faults.RESOLVE)
    items = list(range(8))
    resolve = eng.submit(items)
    t = time.monotonic()
    got = resolve()
    waited = time.monotonic() - t
    helper.join(5)
    np.testing.assert_array_equal(got, 2 * np.arange(8))
    assert 0.15 <= waited < 0.55
    assert eng.deadline_misses == 1
    assert registry.counter(
        "crypto.verify.dispatch.deadline_miss").count == misses0 + 1
    snap = eng.health.snapshot()["devices"]
    assert snap["0"]["consecutive_failures"] == 1
    assert snap["0"]["state"] == resilience.CLOSED
    assert eng.device_served == {1: 8}
    # the dump was taken while the wait and the worker's fetch were open
    dump, = [d for d in tracing.flight_recorder.dumps()
             if d["reason"] == "watchdog-timeout:device0"]
    by_id = {r["id"]: r for r in dump["open_spans"]}
    dev, = [r for r in dump["open_spans"]
            if r["name"] == "span.workload.fetch.device"]
    wait = by_id[dev["parent"]]
    assert wait["name"] == "span.workload.fetch"
    assert wait["attrs"]["device"] == 0 and dev["thread"] != wait["thread"]
    assert by_id[wait["parent"]]["name"] == "span.workload.resolve"
    rec, = [r for r in pipeline_timeline.recent(1)]
    assert rec["parts"] == 3 and rec["delivered"] == 2
    # the abandoned fetch completes late and moves no count
    before = (dict(eng.served), eng.deadline_misses, eng.health.snapshot(),
              pipeline_timeline.totals(), len(eng.audit_verdicts))
    time.sleep(0.7)
    assert before == (dict(eng.served), eng.deadline_misses,
                      eng.health.snapshot(), pipeline_timeline.totals(),
                      len(eng.audit_verdicts))


def test_one_device_raises_within_the_deadline():
    eng = _engine(devices=1)
    be.configure_dispatch(deadline_ms=100)
    faults.set_fault(faults.RESOLVE, "hang", 1.0)
    resolve = eng.submit([1, 2, 3])
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="no device left") as err:
        resolve()
    assert time.monotonic() - t < 0.1 + 0.5
    assert isinstance(err.value.__cause__, resilience.DeadlineExceeded)
    assert eng.deadline_misses == 1 and eng.served["device"] == 0
    assert eng.health.snapshot()["devices"]["0"][
        "consecutive_failures"] == 1


def test_open_breaker_short_circuits_the_wait():
    """Index 0 stalls at the fetch; threshold 1 opens its breaker at the
    first miss, so its part of the second chunk moves without a wait."""
    eng = _engine(threshold=1)
    be.configure_dispatch(deadline_ms=150)
    faults.set_fault(faults.RESOLVE, "stall-device", 0, seconds=0.6)
    items = list(range(16))  # two chunks, a part on each index
    resolve = eng.submit(items)
    t = time.monotonic()
    got = resolve()
    waited = time.monotonic() - t
    np.testing.assert_array_equal(got, 2 * np.arange(16))
    assert waited < 0.45  # one deadline, not two
    assert eng.deadline_misses == 1 and eng.short_circuits == 1
    assert eng.health.quarantined(2) == [0]
    assert eng.device_served == {1: 16}
    assert faults.counters()[faults.RESOLVE]["fired"] == 1


def test_resolve_budget():
    cpu, card = be.torch.device("cpu"), be.torch.device("cuda", 0)
    be.configure_dispatch(deadline_ms=250)
    assert be._resolve_budget_s(cpu) is None
    assert be._resolve_budget_s(card) == 0.25
    for point in (faults.RESOLVE, faults.DISPATCH, faults.TRANSFER):
        faults.set_fault(point, "failn", 0)
        assert be._resolve_budget_s(cpu) == 0.25
        faults.clear()
    faults.set_fault(faults.PROBE, "raise")
    assert be._resolve_budget_s(cpu) is None
    be.configure_dispatch(deadline_ms=0)
    assert be._resolve_budget_s(card) is None


def test_unguarded_cpu_fetch_stays_on_the_callers_thread():
    eng = _engine()
    spawned = resilience.watchdog_stats()["spawned_total"]
    tracing.flight_recorder.clear()
    eng.compute_batch([1, 2, 3, 4, 5])
    threads = {r["thread"] for r in
               tracing.flight_recorder.snapshot(100)["recent"]
               if r["name"] == "span.workload.fetch.device"}
    assert threads == {threading.current_thread().name}
    assert resilience.watchdog_stats()["spawned_total"] == spawned


# ---------------- the probe ----------------


def test_probe_without_a_card_answers_cpu_for_good():
    assert be.device_available(timeout_s=10) is False
    assert be._device_state == "cpu"
    cur = be._probe
    assert be.device_available(timeout_s=10) is False
    assert be._probe is cur  # never probed again
    assert be.dispatch_health()["device_state"] == "cpu"


def test_hung_probe_caches_nothing_and_heals_after_the_backoff():
    be.configure_dispatch(failure_threshold=1, backoff_min_s=0.05,
                          backoff_max_s=0.1)
    faults.set_fault(faults.PROBE, "hang", 1.0)
    t = time.monotonic()
    assert be.device_available(timeout_s=0.2, block=False) is False
    assert time.monotonic() - t < 0.15
    assert be._device_state is None  # pending: nothing cached
    t = time.monotonic()
    assert be.device_available(timeout_s=0.2, block=True) is False
    assert time.monotonic() - t < 0.2 + 0.3
    assert be._device_state == "dead"
    assert be._probe_breaker.state == resilience.OPEN
    faults.clear()
    time.sleep(0.15)
    assert be.device_available(timeout_s=10) is False
    assert be._device_state == "cpu"
    assert be._probe_breaker.state == resilience.CLOSED


def test_failed_probe_is_reprobed_when_the_breaker_allows():
    be.configure_dispatch(failure_threshold=2, backoff_min_s=0.05,
                          backoff_max_s=0.1)
    faults.set_fault(faults.PROBE, "raise")
    assert be.device_available(timeout_s=5) is False
    assert be._device_state == "dead"
    assert be._probe_breaker.state == resilience.CLOSED
    assert be.device_available(timeout_s=5) is False
    assert be._probe_breaker.state == resilience.OPEN
    cur = be._probe
    assert be.device_available(timeout_s=5) is False
    assert be._probe is cur  # open: no new probe
    faults.clear()
    time.sleep(0.15)
    assert be.device_available(timeout_s=5) is False
    assert be._device_state == "cpu"


# ---------------- dispatch_health ----------------

# keys whose meaning the port shares with the reference's dispatch_health
SHARED_KEYS = {"device_state", "deadline_ms", "dispatch_retries",
               "deadline_misses", "retries", "short_circuits", "audit",
               "watchdog", "flight_recorder", "transfer", "resident",
               "service", "fleet"}
# the reference's process-wide breaker gates dispatch; the port's paces
# only the probe, and each engine keeps its own breakers and tallies
PORT_ONLY = {"probe_breaker", "engines"}
# no host failover, no host-only mode; no donation (the caching allocator
# reuses a freed operand's block); the signer-table cache reports
# through its own snapshot
REFERENCE_ONLY = {"breaker", "served", "fallback_chunks", "host_only",
                  "device_health", "signer_tables", "donate_buffers"}
# the reference engine's counters with no counterpart in the port: no
# coalesced sharded upload (one copy an operand a part on its device's
# stream) and no donated dispatch
REFERENCE_ENGINE_ONLY = {"coalesced_dispatches", "donated_dispatches"}


def test_dispatch_health_shape_against_the_reference():
    from stellar_tpu_torch.crypto import batch_verifier as bv
    jbv._reset_dispatch_state_for_testing()  # another test may probe
    port, ref = bv.dispatch_health(), jbv.dispatch_health()
    assert set(port) == SHARED_KEYS | PORT_ONLY
    assert set(ref) == SHARED_KEYS | REFERENCE_ONLY
    assert set(port["audit"]) == set(ref["audit"])
    assert set(port["watchdog"]) == set(ref["watchdog"])
    assert set(port["flight_recorder"]) == set(ref["flight_recorder"])
    assert port["transfer"] == ref["transfer"]
    assert port["fleet"] == ref["fleet"] == {"enabled": False}
    # the port's resident cache starts off, the reference's on
    assert (port["resident"]["enabled"], ref["resident"]["enabled"]) == \
        (False, True)
    assert dict(port["resident"], enabled=True) == ref["resident"]
    assert port["device_state"] == ref["device_state"] == "unprobed"
    assert port["deadline_ms"] == 8000.0 and "deadline_ms" in ref
    v = bv.default_verifier("cpu")
    eng = port_engine = bv.dispatch_health()["engines"]["verify:cpu"]
    assert set(eng) == {"devices", "served", "device_served", "retries",
                        "deadline_misses", "short_circuits", "convicted",
                        "device_health", "resident_hits", "shipped_bytes",
                        "fetched_bytes"}
    fresh = bv.BatchVerifier(device="cpu").health_snapshot()
    ref_engine = jbv.BatchVerifier(bucket_sizes=(16,))
    for key in ("resident_hits", "shipped_bytes", "fetched_bytes"):
        assert fresh[key] == getattr(ref_engine, key) == 0
    for key in REFERENCE_ENGINE_ONLY:
        assert hasattr(ref_engine, key) and key not in eng
    assert set(port_engine["device_health"]) == \
        set(ref["device_health"])
    assert be.served_counts()["verify:cpu"] == v.served


# ---------------- chaos shapes of the reference, raising ----------------


@pytest.fixture
def cold_only():
    from stellar_tpu_torch.parallel import signer_tables
    cache = signer_tables.signer_table_cache
    cache.configure(enabled=False)
    yield
    cache.configure(enabled=True)


def test_edge_corpus_under_resolve_hang_raises_on_one_device(cold_only):
    """The reference's ``test_failover_parity_edge_corpus_under_resolve_
    hang`` (``tests/test_chaos_dispatch.py``), where the port has no host
    failover: on one device the edge corpus under a resolve hang raises
    once the deadline passes, the miss chained, and no verdict escapes."""
    from stellar_tpu_torch.crypto import vectors
    from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
    items = vectors.edge_corpus(np.random.default_rng(93))
    v = BatchVerifier(device="cpu", bucket_sizes=(64,))  # one chunk
    be.configure_dispatch(deadline_ms=150)
    faults.set_fault(faults.RESOLVE, "hang", 1.0)
    resolve = v.submit(items)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="no device left") as err:
        resolve()
    waited = time.monotonic() - t
    assert 0.15 <= waited < 0.15 + 0.5
    assert isinstance(err.value.__cause__, resilience.DeadlineExceeded)
    assert v.deadline_misses == 1 and v.served["device"] == 0
    assert v.health.snapshot()["devices"]["0"]["consecutive_failures"] == 1


def _convict_between_submit_and_resolve(v, items):
    resolve = v.submit(items)
    v.convicted.add(0)
    v.health.quarantine(0, reason="audit-mismatch")
    return resolve


def test_device_convicted_mid_resolve_moves_its_parts_or_raises(cold_only):
    """The reference's ``test_host_only_flips_mid_resolve``: the device
    that served a part is convicted between ``submit`` and ``resolve``
    (the port has no host-only mode; a conviction is its counterpart).
    Its in-flight part is not accepted: on the split it moves to index 1,
    and on one device the call raises."""
    from stellar_tpu_torch.crypto import vectors
    from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
    items = vectors.valid_items(np.random.default_rng(94), 3)
    v = BatchVerifier(devices=["cpu"] * 2, bucket_sizes=(8,))
    got = _convict_between_submit_and_resolve(v, items)()
    assert got.all()
    assert v.served["device"] == 3 and v.device_served == {1: 3}
    assert v.health.quarantined(2) == [0]
    one = BatchVerifier(device="cpu", bucket_sizes=(8,))
    resolve = _convict_between_submit_and_resolve(one, items)
    with pytest.raises(RuntimeError, match="no device left"):
        resolve()
    assert one.served["device"] == 0
