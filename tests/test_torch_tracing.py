"""Tracing, metrics and attribution: the port's copies against the
reference's jax-free modules.

* The metrics registry: the same updates give the same totals.
* Spans: one scripted sequence runs through ``stellar_tpu.utils.tracing``
  and the port's ``tracing``: nested spans under a collecting root, an
  instant event with trace ranges, a span opened on a ``WatchdogPool``
  worker under the caller's context, a span abandoned by a missed
  deadline (dumped while it is open), a job that raises inside its
  context, and a span entered by hand and never exited. Both give equal
  ``span_totals`` counts, equal flight-recorder names, threads, flags
  and parent links, equal dumps and equal trace timelines.
* ``phase_attribution`` on the same ``span_totals`` dicts and
  ``trace_ranges`` on seeded ID lists give equal output.
* Coverage: a blocking CPU ``verify_batch`` (cold and hot) and
  ``hash_batch`` are attributed at 0.95 or more of their root span.

Exact comparisons; only durations (which no comparison reads) differ."""

import threading
import time

import numpy as np
import pytest

from stellar_tpu.parallel import batch_engine as jbe
from stellar_tpu.utils import metrics as jmetrics
from stellar_tpu.utils import resilience as jres
from stellar_tpu.utils import tracing as jtr
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_hasher import BatchHasher
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
from stellar_tpu_torch.parallel import batch_engine as be
from stellar_tpu_torch.parallel import signer_tables
from stellar_tpu_torch.utils import metrics
from stellar_tpu_torch.utils import resilience as res
from stellar_tpu_torch.utils import tracing as tr

PORT = (tr, res, be)
REF = (jtr, jres, jbe)


# ---------------- metrics ----------------


def _drive_registry(reg):
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set("open")
    reg.meter("m").mark(3)
    for ms in (1.5, 0.25, 7.0):
        reg.timer("t").update_ms(ms)
    reg.timer("t").record_total(4, 10.0)
    reg.timer("empty")
    return reg


def test_registry_matches_the_reference():
    port = _drive_registry(metrics.MetricsRegistry())
    ref = _drive_registry(jmetrics.MetricsRegistry())
    got, want = port.to_dict(), ref.to_dict()
    assert sorted(got) == sorted(want)
    for name in ("c", "g", "m"):
        assert got[name] == want[name]
    for name in ("t", "empty"):
        assert got[name] == {k: want[name][k] for k in got[name]}
    totals, ref_totals = port.timer_totals(), ref.timer_totals()
    assert {k: v["count"] for k, v in totals.items()} == \
        {k: v["count"] for k, v in ref_totals.items()}
    assert totals["t"] == ref_totals["t"] == {"count": 7, "sum_ms": 18.75}
    assert port.find("t") == {k: v for k, v in got.items()
                              if k.startswith("t")}


# ---------------- spans and the flight recorder ----------------


def _script(mods):
    """One fixed sequence of spans through one tracing module (with its
    resilience and engine modules). Returns the recorder's ring, its
    dumps, the count of every span timer the sequence touched, and the
    trace timeline of trace 7."""
    tracing, resilience, engine = mods
    fr = tracing.flight_recorder
    fr.clear()
    before = tracing.span_totals()
    pool = resilience.WatchdogPool(name="script-pool", max_idle=1)
    hung_done = threading.Event()

    def on_worker():
        with tracing.span("t.worker", traces=[[7, 9]]):
            with tracing.span("t.worker.inner"):
                return tracing.current_context() is not None

    def hung():
        with tracing.span("t.hung"):
            time.sleep(0.3)
        hung_done.set()

    def raises():
        tracing.span("t.raises").__enter__()  # left open by the raise
        raise KeyError("boom")

    def idle_worker():
        for _ in range(500):
            if pool.stats()["idle"] == 1:
                return
            time.sleep(0.01)

    with tracing.span("t.blocking", _collect=engine.phase_names("t")):
        with tracing.span("t.prep"):
            with tracing.zone("t.encode"):
                pass
        with tracing.span("t.dispatch", traces=[[5, 8]]):
            fr.note("t.reshard", assignment=[1, 1], traces=[[5, 8]])
        with tracing.span("t.fetch", device=0):
            job = pool.submit(on_worker)
            assert job["done"].wait(5)
            linked = job["box"]["out"]
        with tracing.span("t.fetch", device=1, traces=[[6, 7]]):
            with pytest.raises(resilience.DeadlineExceeded):
                resilience.call_with_deadline(hung, 0.05, name="t-fetch")
            fr.dump("watchdog-timeout:device1")
        assert hung_done.wait(5)
        idle_worker()
        job = pool.submit(raises)
        assert job["done"].wait(5) and isinstance(job["box"]["err"],
                                                  KeyError)
        idle_worker()
        job = pool.submit(on_worker)  # the same worker: no stale parent
        assert job["done"].wait(5)
        orphan = tracing.span("t.orphan")
        orphan.__enter__()
        with tracing.span("t.audit"):
            pass
    after = tracing.span_totals()
    counts = {k: after[k]["count"] - before.get(k, {"count": 0})["count"]
              for k in after if _ours(k)}
    return (fr.snapshot(limit=200)["recent"], fr.dumps(), counts, linked,
            fr.trace_timeline(7), fr.stats())


def _ours(name):
    # a late record of another test's abandoned worker may land in the
    # process-wide recorder meanwhile: compare this script's names only
    return name.startswith(("t.", "span.t.", "zone.t.", "span.attr.t."))


def _shape(records):
    """This script's records, parents by their parent's name;
    ids, durations and stamps dropped."""
    by_id = {r["id"]: r for r in records}
    out = []
    for r in records:
        if not _ours(r["name"]):
            continue
        parent = by_id.get(r["parent"])
        out.append({
            "name": r["name"], "thread": r["thread"],
            "parent": None if parent is None else parent["name"],
            "parent_thread": None if parent is None else parent["thread"],
            "attrs": r.get("attrs"), "event": r.get("event", False),
            "abandoned": r.get("abandoned", False),
            "open": r.get("open", False),
            "timed": r["dur_ms"] is not None})
    return out


def test_scripted_spans_match_the_reference():
    ring, dumps, counts, linked, timeline, stats = _script(PORT)
    j_ring, j_dumps, j_counts, j_linked, j_timeline, j_stats = _script(REF)
    assert counts == j_counts
    assert counts["span.attr.t.prep"] == 1 and \
        counts["span.attr.t.fetch"] == 2 and \
        counts["span.attr.t.audit"] == 1 and \
        counts["span.t.blocking"] == 1
    assert linked is j_linked is True
    assert _shape(ring) == _shape(j_ring)
    assert any(r["name"] == "t.reshard" and r["event"]
               for r in _shape(ring))
    raised, = [r for r in _shape(ring) if r["name"] == "span.t.raises"]
    assert raised["abandoned"] and raised["parent"] == "span.t.blocking"
    # the worker's spans link across threads to the fetch that waited
    worker = [r for r in _shape(ring) if r["name"] == "span.t.worker"]
    assert len(worker) == 2 and worker[0]["parent"] == "span.t.fetch"
    assert worker[0]["thread"] != worker[0]["parent_thread"]
    assert worker[1]["parent"] == "span.t.blocking"
    orphan, = [r for r in _shape(ring) if r["name"] == "span.t.orphan"]
    assert orphan["abandoned"] and not orphan["timed"]
    assert [d["reason"] for d in dumps] == [d["reason"] for d in j_dumps] \
        == ["watchdog-timeout:device1"]
    d, jd = dumps[0], j_dumps[0]
    open_names = sorted(r["name"] for r in d["open_spans"])
    assert open_names == sorted(r["name"] for r in jd["open_spans"]) == \
        ["span.t.blocking", "span.t.fetch", "span.t.hung"]
    assert _shape(d["open_spans"] + d["spans"]) == \
        _shape(jd["open_spans"] + jd["spans"])
    assert stats["dump_reasons"] == j_stats["dump_reasons"]
    assert timeline["found"] and timeline["trace"] == 7
    assert _shape(timeline["records"]) == _shape(j_timeline["records"])
    assert {k: v["count"] for k, v in timeline["phases"].items()} == \
        {k: v["count"] for k, v in j_timeline["phases"].items()}


def test_span_context_restores_the_stack_when_the_call_raises():
    outer = tr.span("t.ctx")
    outer.__enter__()
    ctx = tr.current_context()
    outer.__exit__(None, None, None)
    for mod in (tr, jtr):
        with pytest.raises(ValueError):
            with mod.span_context(ctx):
                mod.span("t.left.open").__enter__()
                raise ValueError("x")
        assert mod.current_context() is None
        with mod.span_context(None):
            assert mod.current_context() is None


def test_recorder_accounting_matches_the_reference():
    for fr in (tr.FlightRecorder(capacity=16),
               jtr.FlightRecorder(capacity=16)):
        for i in range(20):
            fr.note("e", i=i)
        d = fr.dump("a", limit=4)
        assert [r["attrs"]["i"] for r in d["spans"]] == [16, 17, 18, 19]
        snap = fr.snapshot(limit=0)
        assert snap["recent"] == [] and snap["recorded_total"] == 20
        assert len(fr.snapshot(limit=100)["recent"]) == 16
        assert snap["capacity"] == 16 and fr.stats()["dump_reasons"] == \
            ["a"]
        fr.clear()
        assert fr.stats() == {"capacity": 16, "recorded_total": 0,
                              "dumps_total": 0, "dump_reasons": []}


def test_log_slow_execution_counts_like_the_reference():
    for mod, reg in ((tr, metrics.registry), (jtr, jmetrics.registry)):
        before = reg.counter("slow.t.scope").count
        with mod.LogSlowExecution("t.scope", threshold_ms=0.0):
            time.sleep(0.001)
        with mod.LogSlowExecution("t.scope", threshold_ms=1e6):
            pass
        assert reg.counter("slow.t.scope").count == before + 1


# ---------------- attribution and trace ranges ----------------


def _totals(rng, ns):
    names = [f"span.attr.{ns}.{s}" for s in be.PHASE_SUFFIXES] + \
        [f"span.{ns}.blocking", "span.other"]
    return {n: {"count": int(rng.integers(0, 50)),
                "sum_ms": float(rng.integers(0, 10 ** 6)) / 64}
            for n in names if rng.random() < 0.9}


@pytest.mark.parametrize("ns", ["verify", "hash"])
def test_phase_attribution_matches_the_reference(ns):
    rng = np.random.default_rng(91)
    assert be.PHASE_SUFFIXES == jbe.PHASE_SUFFIXES
    assert be.RESOLVE_PHASES == jbe.RESOLVE_PHASES
    assert be.RESOLVE_ROOT == jbe.RESOLVE_ROOT
    assert be.phase_names(ns) == jbe.phase_names(ns)
    for _ in range(20):
        before = _totals(rng, ns)
        after = {k: {"count": v["count"] + int(rng.integers(0, 9)),
                     "sum_ms": v["sum_ms"] + float(rng.integers(0, 999))}
                 for k, v in _totals(rng, ns).items()}
        reps = int(rng.integers(1, 30))
        assert be.phase_attribution(before, after, reps, ns) == \
            jbe.phase_attribution(before, after, reps, ns)
        if ns == "verify":
            assert be.dispatch_attribution(before, after, reps) == \
                jbe.dispatch_attribution(before, after, reps)
    assert be.phase_attribution({}, {}, 1, ns) == \
        jbe.phase_attribution({}, {}, 1, ns)


def test_trace_ranges_and_matches_equal_the_reference():
    rng = np.random.default_rng(92)
    for n in (0, 1, 5, 64, 300):
        ids = np.cumsum(rng.integers(1, 3, size=n)).tolist()
        got = be.trace_ranges(ids)
        assert got == jbe.trace_ranges(ids)
        rec = {"attrs": {"traces": got}}
        for t in range(0, (ids[-1] if ids else 0) + 2):
            assert tr.trace_matches(rec, t) == jtr.trace_matches(rec, t) \
                == (t in ids)
    assert not tr.trace_matches({}, 1)


# ---------------- coverage of a blocking call ----------------


@pytest.fixture
def fresh_cache():
    cache = signer_tables.signer_table_cache
    cache._reset_for_testing()
    yield cache
    cache._reset_for_testing()
    cache.configure(enabled=True)


def _covered(call, ns):
    before = tr.span_totals()
    out = call()
    att = be.phase_attribution(before, tr.span_totals(), 1, ns)
    assert att["blocking_span_count"] == 1
    assert att["coverage"] >= 0.95, att
    return out, att


def test_blocking_verify_is_covered_cold_and_hot(fresh_cache):
    rng = np.random.default_rng(93)
    items = vectors.valid_items(rng, 3) + vectors.edge_corpus(rng)[:3]
    want = [ref.verify(*it) for it in items]
    for enabled in (False, True, True):
        fresh_cache.configure(enabled=enabled)
        v = BatchVerifier(device="cpu", bucket_sizes=(8,))
        got, att = _covered(lambda: v.verify_batch(items, trace_ids=range(
            100, 106)), "verify")
        assert got.tolist() == want
        assert att["phases"]["verify.prep"]["count"] >= 1
        assert att["phases"]["verify.fetch"]["count"] >= 1
    assert v.served["hot"] > 0
    # the trace ranges reached the engine's spans
    recs = tr.flight_recorder.trace_timeline(100)["records"]
    assert {"span.verify.fetch", "span.verify.dispatch"} <= \
        {r["name"] for r in recs}


def test_blocking_hash_is_covered():
    import hashlib
    msgs = [bytes([i]) * (7 * i) for i in range(40)]
    h = BatchHasher(device="cpu", bucket_sizes=(64,))
    got, att = _covered(lambda: h.hash_batch(msgs), "hash")
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert att["phases"]["hash.dispatch"]["count"] == 1
