"""The transfer ledger and the resident operand cache, on the CPU, held
against the reference number for number.

* The same call sequences through the reference's and the port's
  ``TransferLedger`` and ``DeviceResidentCache`` give equal ``totals()``,
  ``recent()`` and ``snapshot()`` (the cases of
  ``tests/test_transfer_ledger.py`` and ``tests/test_residency.py``).
* A toy workload (one (n, 2) uint8 operand, the first column its result)
  through the reference's ``BatchEngine`` and the port's, with the same
  items: a first call, a repeat (a resident hit), a repeat with the cache
  off (redundant bytes). Ledger deltas, per-resolve records, cache
  snapshots and the engines' own tallies are equal, and each engine's
  tallies reconcile with its ledger.
* The port's cache starts off, where the reference's starts on: by
  default every operand is copied, and a repeat is counted redundant.
* The port's verifier, cold and hot, reconciles with its ledger; the hot
  table operand is counted bytes-only.
* A transfer fault on a would-be hit still charges the device; a fetch
  that misses its deadline and completes late moves no ledger count; the
  pipeline record carries the resolve's transfer record.

No JAX program is compiled beyond the toy kernel."""

import threading
import time

import numpy as np
import pytest

from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.parallel import batch_engine as jbe
from stellar_tpu.parallel import residency as jresidency
from stellar_tpu.utils import transfer_ledger as jledger
from stellar_tpu.utils.timeline import pipeline_timeline as jtimeline
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
from stellar_tpu_torch.parallel import batch_engine as be
from stellar_tpu_torch.parallel import residency, signer_tables
from stellar_tpu_torch.utils import faults
from stellar_tpu_torch.utils import transfer_ledger as ledger
from stellar_tpu_torch.utils.timeline import pipeline_timeline


@pytest.fixture(autouse=True)
def fresh_state():
    """Both packages' dispatch state, ledger and cache as at process
    start; the knobs and the port's cache switch restored after the
    test."""
    saved = (be.DEADLINE_MS, be.AUDIT_RATE)
    faults.clear()
    be._reset_dispatch_state_for_testing()
    jbv._reset_dispatch_state_for_testing()
    yield
    faults.clear()
    be.configure_dispatch(deadline_ms=saved[0], audit_rate=saved[1])
    residency.resident_cache.configure(
        enabled=residency.ENABLED, max_item_bytes=1 << 20,
        max_bytes=128 << 20)
    ledger.transfer_ledger.configure(fp_max_bytes=1 << 20)
    jresidency.resident_cache.configure(enabled=True)
    signer_tables.signer_table_cache._reset_for_testing()
    signer_tables.signer_table_cache.configure(enabled=True)
    be._reset_dispatch_state_for_testing()
    jbv._reset_dispatch_state_for_testing()


# ---------------- the ledger and the cache against the reference -------


def _ledger_redundancy(mod):
    led = mod.TransferLedger(resolves=8, fingerprints=64)
    tok = led.begin("test.ns")
    a = np.arange(32, dtype=np.uint8).reshape(4, 8)
    sizes = [led.record_h2d(tok, a),
             led.record_h2d(tok, np.ones((2, 8), dtype=np.uint8)),
             led.record_h2d(tok, a.copy()),
             led.record_d2h(tok, np.zeros(4, dtype=bool))]
    rec = led.finish(tok)
    return sizes, rec, led.totals(), led.recent(8)


def _ledger_idempotent_finish(mod):
    led = mod.TransferLedger(resolves=4, fingerprints=64)
    recs = []
    for _ in range(6):
        t = led.begin("ns")
        led.record_d2h(t, np.zeros(1, dtype=bool))
        recs.append(led.finish(t))
        recs.append(led.finish(t))
    return recs, led.totals(), led.recent(100), led.recent(0)


def _ledger_fingerprint_lru(mod):
    led = mod.TransferLedger(resolves=8, fingerprints=16)
    for i in range(40):
        led.record_h2d(None, np.array([i], dtype=np.int64))
    first = led.totals()
    led.record_h2d(None, np.array([39], dtype=np.int64))  # still tracked
    led.record_h2d(None, np.array([0], dtype=np.int64))   # evicted
    led.configure(resolves=4, fingerprints=32)
    return first, led.totals(), led._ring.maxlen


def _ledger_size_cap(mod):
    led = mod.TransferLedger(resolves=8, fingerprints=64, fp_max_bytes=64)
    big = np.zeros(128, dtype=np.uint8)
    out = [led.record_h2d(None, big), led.record_h2d(None, big.copy())]
    snaps = [led.totals()]
    small = np.zeros(64, dtype=np.uint8)  # at the cap: fingerprinted
    led.record_h2d(None, small)
    led.record_h2d(None, small.copy())
    snaps.append(led.totals())
    led.configure(fp_max_bytes=1024)
    led.record_h2d(None, big.copy())
    snaps.append(led.totals())
    return out, snaps


def _ledger_resident_and_fp_handoff(mod):
    led = mod.TransferLedger(resolves=8, fingerprints=64)
    tok = led.begin("ns")
    a = np.arange(16, dtype=np.uint8)
    fp = b"\x01" * 16
    led.record_h2d(tok, a, fp=fp)
    led.record_h2d(tok, a.copy(), fp=fp)     # the hand-off's content key
    led.record_h2d(tok, a, fp=None)          # None: bytes-only
    hit = led.record_resident_hit(tok, a)
    led.record_resident_hit(None, a)
    rec = led.finish(tok)
    led._reset_for_testing()
    return hit, rec, led.totals()


LEDGER_CASES = [_ledger_redundancy, _ledger_idempotent_finish,
                _ledger_fingerprint_lru, _ledger_size_cap,
                _ledger_resident_and_fp_handoff]


@pytest.mark.parametrize("case", LEDGER_CASES, ids=lambda f: f.__name__)
def test_ledger_equals_the_reference(case):
    assert case(ledger) == case(jledger)


def test_ledger_cases_show_what_they_cover():
    sizes, rec, tot, recent = _ledger_redundancy(ledger)
    assert sizes == [32, 16, 32, 4] and recent == [rec]
    assert (rec["bytes_h2d"], rec["redundant_constant_bytes"],
            rec["round_trips"]) == (80, 32, 1)
    recs, tot, ring, none = _ledger_idempotent_finish(ledger)
    assert tot["resolves_recorded"] == 6 and len(ring) == 4 and none == []
    first, last, maxlen = _ledger_fingerprint_lru(ledger)
    assert first["fingerprints_tracked"] == 16 and maxlen == 4
    assert last["redundant_uploads"] == 1
    out, snaps = _ledger_size_cap(ledger)
    assert out == [128, 128]
    assert [s["unfingerprinted_uploads"] for s in snaps] == [2, 2, 2]
    assert snaps[1]["redundant_constant_bytes"] == 64
    assert snaps[2]["fingerprints_tracked"] == 2
    hit, rec, tot = _ledger_resident_and_fp_handoff(ledger)
    assert hit == 16 and rec["resident_hits"] == 1
    assert rec["redundant_uploads"] == 1 and tot["bytes_h2d"] == 0
    assert ledger.DEFAULT_FP_MAX_BYTES == jledger.DEFAULT_FP_MAX_BYTES


def _cache_fingerprint(mod):
    a = np.arange(16, dtype=np.uint8)
    return (mod.fingerprint(a, max_bytes=64),
            mod.fingerprint(a.copy(), max_bytes=64),
            mod.fingerprint(a + 1, max_bytes=64),
            mod.fingerprint(a, max_bytes=16),      # at the cap
            mod.fingerprint(a, max_bytes=8))       # over it: None


def _cache_key(mod):
    c = mod.DeviceResidentCache(max_bytes=1 << 16, max_item_bytes=1 << 12)
    a = np.arange(8, dtype=np.uint8)
    fp = mod.fingerprint(a, max_bytes=1 << 12)
    seen = [c.get(fp, a, "cpu"), c.put(fp, a, "cpu", "placed"),
            c.get(fp, a, "cpu"),
            c.get(fp, a, "cuda:0"),                 # another placement
            c.get(fp, a.reshape(2, 4), "cpu"),      # another shape
            c.get(fp, a.view(np.int8), "cpu"),      # another dtype
            c.get(None, a, "cpu"),                  # no fingerprint
            c.put(None, a, "cpu", "x")]
    return seen, c.snapshot()


def _cache_lru(mod):
    c = mod.DeviceResidentCache(max_bytes=32, max_item_bytes=64)
    rows = [np.full(16, i, dtype=np.uint8) for i in range(4)]
    fps = [mod.fingerprint(r, max_bytes=64) for r in rows]
    seen = [c.put(fps[0], rows[0], "p", "a0"),
            c.put(fps[1], rows[1], "p", "a1"), c.snapshot(),
            c.put(fps[2], rows[2], "p", "a2"),
            c.get(fps[0], rows[0], "p"), c.get(fps[2], rows[2], "p"),
            c.get(fps[1], rows[1], "p"),
            c.put(fps[3], rows[3], "p", "a3"),
            c.get(fps[1], rows[1], "p"), c.get(fps[2], rows[2], "p"),
            c.snapshot()]
    c.configure(enabled=False)
    seen += [c.snapshot(), c.get(fps[1], rows[1], "p"),
             c.put(fps[1], rows[1], "p", "a1")]
    c.configure(enabled=True, max_bytes=16)
    seen += [c.put(fps[1], rows[1], "p", "a1"),
             c.put(fps[2], rows[2], "p", "a2"), c.snapshot()]
    c._reset_for_testing()
    return seen, c.snapshot()


def _cache_oversize(mod):
    c = mod.DeviceResidentCache(max_bytes=8, max_item_bytes=64)
    big = np.zeros(16, dtype=np.uint8)
    fp = mod.fingerprint(big, max_bytes=64)
    return c.put(fp, big, "p", "arr"), c.snapshot()


CACHE_CASES = [_cache_fingerprint, _cache_key, _cache_lru, _cache_oversize]


@pytest.mark.parametrize("case", CACHE_CASES, ids=lambda f: f.__name__)
def test_cache_equals_the_reference(case):
    assert case(residency) == case(jresidency)


def test_cache_cases_show_what_they_cover():
    fps = _cache_fingerprint(residency)
    assert fps[0] == fps[1] != fps[2] and fps[3] == fps[0]
    assert fps[4] is None and len(fps[0]) == 16
    seen, snap = _cache_key(residency)
    assert seen == [None, True, "placed", None, None, None, None, False]
    assert (snap["entries"], snap["hits"], snap["misses"]) == (1, 1, 4)
    seen, snap = _cache_lru(residency)
    assert seen[4] is None and seen[5] == "a2" and seen[8] == "a1"
    assert seen[9] is None and seen[10]["evictions"] == 2
    assert seen[11]["entries"] == 0 and seen[13] is False
    assert seen[16]["entries"] == 1 and seen[16]["bytes"] == 16
    kept, snap = _cache_oversize(residency)
    assert kept is False and snap["entries"] == 0
    assert (residency.DEFAULT_CACHE_BYTES, residency.DEFAULT_MAX_ITEM_BYTES,
            residency.DeviceResidentCache().enabled) == (
        128 << 20, 1 << 20, True) == (
        jresidency.DEFAULT_CACHE_BYTES, jresidency.DEFAULT_MAX_ITEM_BYTES,
        jresidency.DeviceResidentCache().enabled)
    # the one divergence: the port's process-wide cache starts off
    assert residency.ENABLED is residency.resident_cache.enabled is False
    assert jresidency.resident_cache.enabled is True


# ---------------- a toy workload through both engines ----------------


def _toy(base):
    class Toy(base):
        """One (n, 2) uint8 operand; the kernel's result is its first
        column, a fresh array."""

        metrics_ns = "test.xfer"
        span_ns = "xfer"

        def encode(self, items):
            arr = np.array([[v, v + 1] for v in items], dtype=np.uint8)
            return np.ones(len(items), dtype=bool), (arr,)

        def pad_rows(self):
            return (np.zeros((1, 2), dtype=np.uint8),)

        def kernel_fn(self):
            if base is be.Workload:
                return lambda a: a[:, 0].clone()
            return lambda a: a[:, 0] + 0

        def empty_result(self, n):
            return np.zeros(n, dtype=np.uint8)

        def host_result(self, items):
            return np.array(list(items), dtype=np.uint8)

        def finalize(self, gate, out, items):
            return out
    return Toy()


def _drive_toy(engine_mod, led, cache, timeline):
    """A first call, a repeat and a repeat with the cache off, each with
    its ledger totals, its per-resolve record and the cache's snapshot;
    then the engine's own tallies and the pipeline records' transfer."""
    where = {"device": "cpu"} if engine_mod is be else {}
    eng = engine_mod.BatchEngine(_toy(engine_mod.Workload),
                                 bucket_sizes=(4,), **where)
    items = [10, 20, 30, 40]
    steps = [led.totals()]
    for enabled in (True, True, False):
        cache.configure(enabled=enabled)
        assert list(eng.compute_batch(items)) == items
        steps.append((led.totals(), led.recent(1), cache.snapshot()))
    tallies = (eng.shipped_bytes, eng.fetched_bytes, eng.resident_hits)
    transfers = [r["transfer"] for r in timeline.recent(3)]
    return steps, tallies, transfers


def test_toy_engine_ledger_equals_the_reference():
    got = _drive_toy(be, ledger.transfer_ledger, residency.resident_cache,
                     pipeline_timeline)
    want = _drive_toy(jbe, jledger.transfer_ledger,
                      jresidency.resident_cache, jtimeline)
    assert got == want
    steps, (shipped, fetched, hits), transfers = got
    first, repeat, off = (s[0] for s in steps[1:])
    # the first call ships (4, 2) and fetches (4,); the repeat is served
    # from the cache; with it off the same bytes ship again, redundant
    assert (first["bytes_h2d"], first["bytes_d2h"]) == (8, 4)
    assert repeat["bytes_h2d"] == 8 and repeat["resident_hits"] == 1
    assert off["bytes_h2d"] == 16 and off["redundant_constant_bytes"] == 8
    assert steps[2][1][0]["resident_hits"] == 1
    assert steps[2][1][0]["bytes_h2d"] == 0
    # each engine's shape-derived tallies reconcile with its ledger
    assert (shipped, fetched, hits) == (off["bytes_h2d"], off["bytes_d2h"],
                                        off["resident_hits"]) == (16, 12, 1)
    assert [t["bytes_h2d"] for t in transfers] == [8, 0, 8]
    assert steps[3][2]["entries"] == 0  # switched off: cleared


def test_by_default_every_operand_is_copied_and_a_repeat_is_redundant():
    """With the port's default (the cache off) the toy's repeat copies
    its operand again; the ledger's fingerprints still see the repeat,
    and no tensor is kept."""
    eng = be.BatchEngine(_toy(be.Workload), device="cpu", bucket_sizes=(4,))
    led = ledger.transfer_ledger
    for _ in range(2):
        assert list(eng.compute_batch([10, 20, 30, 40])) == [10, 20, 30, 40]
    tot = led.totals()
    assert (tot["bytes_h2d"], tot["bytes_d2h"], tot["resident_hits"],
            tot["redundant_constant_bytes"]) == (16, 8, 0, 8)
    assert (eng.shipped_bytes, eng.fetched_bytes, eng.resident_hits) == (
        16, 8, 0)
    assert [r["bytes_h2d"] for r in led.recent(2)] == [8, 8]
    snap = residency.resident_cache.snapshot()
    assert (snap["enabled"], snap["entries"], snap["hits"]) == (False, 0, 0)


# ---------------- the port's verifier on the CPU ----------------


def _reconciles(v, before, after):
    return (after["bytes_h2d"] - before["bytes_h2d"],
            after["bytes_d2h"] - before["bytes_d2h"],
            after["resident_hits"] - before["resident_hits"])


def test_verifier_reconciles_cold_and_hot_and_counts_the_table_bytes_only():
    """Three items at bucket 4, cold twice then hot twice; the caps at
    32 KiB so that the hot table operand (4 x 15,360 B) is over both, as
    a 2,048-row bucket's 31 MB is over 1 MiB, while R, s and h are not."""
    rng = np.random.default_rng(91)
    items = vectors.valid_items(rng, 3)
    cap = 32 << 10
    residency.resident_cache.configure(enabled=True, max_item_bytes=cap)
    ledger.transfer_ledger.configure(fp_max_bytes=cap)
    cache = signer_tables.signer_table_cache
    cache.configure(enabled=False)
    v = BatchVerifier(device="cpu", bucket_sizes=(4,))
    led = ledger.transfer_ledger
    seen = []
    for mode in ("cold", "cold", "hot", "hot"):
        cache.configure(enabled=mode == "hot")
        t0 = led.totals()
        e0 = (v.shipped_bytes, v.fetched_bytes, v.resident_hits)
        assert v.verify_batch(items).all()
        t1 = led.totals()
        e1 = (v.shipped_bytes, v.fetched_bytes, v.resident_hits)
        assert _reconciles(v, t0, t1) == tuple(b - a for a, b in zip(e0, e1))
        seen.append((_reconciles(v, t0, t1),
                     t1["unfingerprinted_uploads"] -
                     t0["unfingerprinted_uploads"],
                     t1["unfingerprinted_bytes"] - t0["unfingerprinted_bytes"],
                     t1["redundant_constant_bytes"]))
    table = 4 * signer_tables.TABLE_ENTRIES * 3 * 20 * 2
    assert seen == [
        ((4 * 4 * 32, 4, 0), 0, 0, 0),        # cold: A, R, s, h copied
        ((0, 4, 4), 0, 0, 0),                 # cold repeat: 4 hits
        # hot, first sight: every row cold again, its operands hits
        ((0, 4, 4), 0, 0, 0),
        # hot repeat: the table copied bytes-only and never cached; R, s
        # and h (the cold rows' bytes, padded alike) hits
        ((table, 4, 3), 1, table, 0)]
    assert v.served["hot"] == 3
    snap = residency.resident_cache.snapshot()
    assert snap["entries"] == 4 and snap["bytes"] == 4 * 4 * 32


# ---------------- faults and the deadline ----------------


class Doubler(be.Workload):
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


def _split_engine():
    """Two indices on the CPU, the audit on every part, the cache on."""
    be.configure_dispatch(audit_rate=1.0)
    residency.resident_cache.configure(enabled=True)
    eng = be.BatchEngine(Doubler(), devices=["cpu"] * 2, bucket_sizes=(8,))
    eng.health.configure(failure_threshold=2, backoff_min_s=0.1,
                         backoff_max_s=0.2)
    return eng


def test_transfer_fault_on_a_would_be_hit_charges_the_device():
    """Both parts of the first call are cached under the one placement
    ``cpu``; the second call's part on index 0 would be a hit, but the
    transfer fault is injected ahead of the lookup: index 0 is charged,
    and the part is placed again on index 1, a hit there."""
    eng = _split_engine()
    items = list(range(8))
    np.testing.assert_array_equal(eng.compute_batch(items), 2 * np.arange(8))
    assert eng.resident_hits == 0 and eng.shipped_bytes == 8 * 8
    faults.set_fault(faults.TRANSFER, "fail-device", 0)
    np.testing.assert_array_equal(eng.compute_batch(items), 2 * np.arange(8))
    assert faults.counters()[faults.TRANSFER]["fired"] == 1
    assert eng.health.snapshot()["devices"]["0"]["consecutive_failures"] == 1
    assert eng.device_served == {0: 4, 1: 4 + 8}
    assert eng.resident_hits == 2 and eng.shipped_bytes == 8 * 8
    tot = ledger.transfer_ledger.totals()
    assert (tot["bytes_h2d"], tot["resident_hits"], tot["bytes_d2h"]) == (
        eng.shipped_bytes, eng.resident_hits, eng.fetched_bytes)


def test_late_fetch_moves_no_ledger_count():
    """The first fetch hangs past a 150 ms deadline; its part moves to
    index 1 (placed again, a hit there). Only accepted results are
    counted, and the abandoned fetch's late completion moves nothing."""
    eng = _split_engine()
    be.configure_dispatch(deadline_ms=150)
    faults.set_fault(faults.RESOLVE, "hang", 0.6)

    def clear_when_fired():
        for _ in range(2000):
            if faults.counters().get(faults.RESOLVE, {"fired": 1})["fired"]:
                break
            time.sleep(0.002)
        faults.clear(faults.RESOLVE)

    helper = threading.Thread(target=clear_when_fired, daemon=True)
    helper.start()
    got = eng.compute_batch(list(range(8)))
    helper.join(5)
    np.testing.assert_array_equal(got, 2 * np.arange(8))
    assert eng.deadline_misses == 1 and eng.device_served == {1: 8}
    led = ledger.transfer_ledger
    before = (led.totals(), led.recent(4), eng.fetched_bytes)
    rec, = before[1]
    assert rec["round_trips"] == 2 and rec["bytes_d2h"] == 2 * 4 * 8
    assert rec["resident_hits"] == 1 and rec["bytes_h2d"] == 2 * 4 * 8
    assert before[0]["bytes_d2h"] == eng.fetched_bytes
    time.sleep(0.7)
    assert before == (led.totals(), led.recent(4), eng.fetched_bytes)


def test_pipeline_record_carries_the_transfer_record():
    eng = be.BatchEngine(Doubler(), device="cpu", bucket_sizes=(4,))
    eng.compute_batch([1, 2, 3])
    eng.compute_batch([1, 2, 3])
    recs = pipeline_timeline.recent(2)
    ledger_recs = ledger.transfer_ledger.recent(2)
    keys = ("round_trips", "bytes_h2d", "bytes_d2h",
            "redundant_constant_bytes")
    assert [r["transfer"] for r in recs] == [
        {k: r[k] for k in keys} for r in ledger_recs] == [
        {"round_trips": 1, "bytes_h2d": 32, "bytes_d2h": 32,
         "redundant_constant_bytes": 0},
        {"round_trips": 1, "bytes_h2d": 32, "bytes_d2h": 32,
         "redundant_constant_bytes": 32}]
    health = be.dispatch_health()
    assert health["transfer"] == ledger.transfer_ledger.totals()
    assert health["resident"] == residency.resident_cache.snapshot()
    assert health["resident"]["hits"] == 0
