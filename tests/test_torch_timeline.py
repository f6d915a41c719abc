"""The pipeline timeline: the port's ``PipelineTimeline`` against the
reference's, and its hooks in the port's engine.

* The scripted sequences of the reference's own timeline tests (a stall
  between two devices' launches, prep hidden behind in-flight work,
  overlapping parts on one device, an abandoned part, the bounded ring)
  run through both profilers, each driven by its own scripted clock
  (``_now`` patched on the instance): every record, the totals, the
  recent records and the snapshot are equal, key for key.
* The engine writes one record a resolve: a split CPU engine's record
  reconciles, delivers each part once, and a ``stall-device`` fault at
  the launch shows as a ``queue_wait`` bubble without charging anything.

Exact comparisons throughout: the records are rounded the same way."""

import numpy as np
import pytest

from stellar_tpu.utils import timeline as jtl
from stellar_tpu_torch.parallel.batch_engine import BatchEngine, Workload
from stellar_tpu_torch.utils import faults
from stellar_tpu_torch.utils import timeline as tl
from stellar_tpu_torch.utils.metrics import registry


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, ms):
        self.t += ms

    def now(self):
        return self.t


def _pair(resolves=8):
    """The reference's profiler and the port's, each on its own clock."""
    out = []
    for mod in (jtl, tl):
        clk = FakeClock()
        pl = mod.PipelineTimeline(resolves=resolves)
        pl._now = clk.now
        out.append((pl, clk))
    return out


def _two_device_stall(pl, clk):
    tok = pl.begin("test")
    with pl.host_phase(tok, "prep"):
        clk.advance(10)
    pl.note_dispatch(tok, 0)
    clk.advance(50)
    pl.note_dispatch(tok, 1)
    with pl.host_phase(tok, "fetch"):
        clk.advance(20)
    pl.note_delivery(tok, 0)
    with pl.host_phase(tok, "fetch"):
        clk.advance(10)
    pl.note_delivery(tok, 1)
    return [pl.finish(tok)]


def _overlap_hidden_and_not(pl, clk):
    tok = pl.begin("test")
    pl.note_dispatch(tok, 0)
    clk.advance(5)
    with pl.host_phase(tok, "prep"):
        clk.advance(10)
    clk.advance(5)
    pl.note_delivery(tok, 0)
    first = pl.finish(tok)
    tok = pl.begin("test")
    with pl.host_phase(tok, "prep"):
        clk.advance(10)
    pl.note_dispatch(tok, 0)
    clk.advance(10)
    pl.note_delivery(tok, 0)
    return [first, pl.finish(tok)]


def _overlapping_parts(pl, clk):
    tok = pl.begin("test")
    pl.note_dispatch(tok, 0)
    clk.advance(5)
    pl.note_dispatch(tok, 0)
    clk.advance(15)
    pl.note_delivery(tok, 0)
    clk.advance(5)
    pl.note_delivery(tok, 0)
    return [pl.finish(tok)]


def _abandoned_part(pl, clk):
    tok = pl.begin("test")
    pl.note_dispatch(tok, 3)
    clk.advance(10)
    rec = pl.finish(tok)
    again = pl.finish(tok)
    pl.note_dispatch(tok, 3)
    pl.note_delivery(tok, 3)
    return [rec, again]


def _given_up_then_moved(pl, clk):
    """The engine's own shape: a part given up on device 0 (a missed
    deadline) moves to device 1, which delivers it."""
    tok = pl.begin("test")
    with pl.host_phase(tok, "prep"):
        clk.advance(3)
    pl.note_dispatch(tok, 0)
    pl.note_dispatch(tok, 1)
    with pl.host_phase(tok, "fetch"):
        clk.advance(200)
    pl.note_delivery(tok, 0, delivered=False)
    clk.advance(1)
    pl.note_dispatch(tok, 1)
    with pl.host_phase(tok, "fetch"):
        clk.advance(4)
    pl.note_delivery(tok, 1)
    with pl.host_phase(tok, "audit"):
        clk.advance(2)
    with pl.host_phase(tok, "fetch"):
        clk.advance(1)
    pl.note_delivery(tok, 1)
    return [pl.finish(tok)]


def _ring(pl, clk):
    recs = []
    for _ in range(10):
        tok = pl.begin("test")
        pl.note_dispatch(tok, 0)
        clk.advance(1)
        pl.note_delivery(tok, 0)
        recs.append(pl.finish(tok))
    recs.append(pl.recent(100))
    recs.append(pl.recent(0))
    return recs


SCRIPTS = [_two_device_stall, _overlap_hidden_and_not, _overlapping_parts,
           _abandoned_part, _given_up_then_moved, _ring]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[1:])
def test_records_equal_the_reference(script):
    (jpl, jclk), (pl, clk) = _pair(resolves=4)
    want = script(jpl, jclk)
    got = script(pl, clk)
    assert got == want
    assert pl.totals() == jpl.totals()
    assert pl.recent(100) == jpl.recent(100)
    assert pl.snapshot(3) == jpl.snapshot(3)
    assert pl._ring.maxlen == jpl._ring.maxlen


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[1:])
def test_closed_tokens_read_back_as_the_reference_records(script):
    """The engine's ``close`` defers a record's build to the next read:
    the records, totals and snapshot read afterwards equal the
    reference's, which builds each at ``finish``."""
    (jpl, jclk), (pl, clk) = _pair(resolves=4)
    script(jpl, jclk)
    pl.finish = pl.close
    script(pl, clk)
    if script is _two_device_stall:  # nothing built until a read
        assert not pl._ring and len(pl._pending) == 1
    assert pl.recent(100) == jpl.recent(100)
    assert not pl._pending
    assert pl.totals() == jpl.totals()
    assert pl.snapshot(3) == jpl.snapshot(3)


def test_reference_stall_figures_hold():
    """The reference test's own figures, on the port: the stall is a
    queue_wait bubble on the delayed device and the record reconciles."""
    (_jpl, _jclk), (pl, clk) = _pair()
    rec, = _two_device_stall(pl, clk)
    assert rec["wall_ms"] == 90.0 and rec["delivered"] == 2
    assert rec["bubbles"] == {"queue_wait": 50.0, "prep": 20.0,
                              "fetch": 10.0, "audit": 0.0,
                              "host_fallback": 0.0, "gap": 0.0}
    assert rec["largest_bubble_class"] == "queue_wait"
    assert rec["busy_frac"] == round(100.0 / 180.0, 4)
    assert rec["reconciliation"] == 1.0
    assert registry.gauge("crypto.pipeline.busy_frac").value == \
        rec["busy_frac"]


class Doubler(Workload):
    """Items are ints; the 'kernel' doubles them."""

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


@pytest.fixture
def engine():
    faults.clear()
    tl.pipeline_timeline._reset_for_testing()
    yield BatchEngine(Doubler(), devices=["cpu"] * 2, bucket_sizes=(8,))
    faults.clear()


def test_engine_leaves_one_record_a_resolve(engine):
    items = list(range(12))  # chunks of 8 and 4: 2 parts + 1 part
    np.testing.assert_array_equal(engine.compute_batch(items),
                                  2 * np.arange(12))
    rec, = tl.pipeline_timeline.recent(10)
    assert rec["ns"] == "workload"
    assert rec["n_devices"] == 2 and rec["parts"] == 3
    assert rec["delivered"] == 3
    assert rec["reconciliation"] == 1.0
    assert rec["prep_ms"] > 0 and 0 < rec["busy_frac"] <= 1
    # an empty batch dispatches nothing and leaves no record
    engine.compute_batch([])
    assert len(tl.pipeline_timeline.recent(10)) == 1


def test_stall_device_is_a_bubble_and_trips_nothing(engine):
    """A stall before device 0's launch delays both devices' first
    launch: a queue_wait bubble at least as long as the stall, and no
    breaker charged, no part moved."""
    faults.set_fault(faults.DISPATCH, "stall-device", 0, seconds=0.08)
    items = list(range(8))
    np.testing.assert_array_equal(engine.compute_batch(items),
                                  2 * np.arange(8))
    assert faults.counters()[faults.DISPATCH]["fired"] == 1
    rec, = tl.pipeline_timeline.recent(1)
    assert rec["bubbles"]["queue_wait"] >= 80.0
    assert rec["largest_bubble_class"] == "queue_wait"
    assert rec["devices"]["1"]["bubbles"]["queue_wait"] >= 80.0
    assert engine.device_served == {0: 4, 1: 4}
    snap = engine.health.snapshot()["devices"]
    assert all(d["consecutive_failures"] == 0 for d in snap.values())
    assert engine.deadline_misses == 0
