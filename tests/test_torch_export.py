"""The export surfaces, on the CPU, held against the reference: timer
percentiles, the Prometheus text and the Chrome trace with the pipeline's
counter tracks.

* The same update sequence through a fresh reference registry and a fresh
  port registry gives equal p50/p90/p99, ``stddev_ms``, ``to_dict()`` and
  ``to_prometheus()`` text. The meters' ``_rate`` lines depend on the
  clock (a mark evicts the events older than the window); the clock is
  patched to one scripted sequence for both drives, so those lines are
  compared too, none masked.
* ``to_chrome_trace()`` of the same span tree, instants, open span and
  pipeline records gives the same events in both: names, phases, tracks,
  nesting order and attrs; span timestamps and ids may differ, the counter
  tracks (on a scripted pipeline clock) are equal to the microsecond."""

import itertools
import threading
import time

from stellar_tpu.utils import metrics as jmetrics
from stellar_tpu.utils import timeline as jtimeline
from stellar_tpu.utils import tracing as jtracing
from stellar_tpu_torch.utils import metrics, timeline, tracing


def _drive_registry(mod, monkeypatch):
    """Counters, meters, timers and gauges under names that need
    mangling; more timer updates than the reservoir holds, a flush of an
    aggregate, and a clock that steps 150 s a read so marks evict."""
    clock = itertools.count(1000.0, 150.0)
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    reg = mod.MetricsRegistry()
    reg.counter("crypto.transfer.bytes_h2d").inc(262144)
    reg.counter("9starts.with-digit").inc()
    for n in (1, 3, 2, 5):
        reg.meter("crypto.verify.serve.device").mark(n)
    t = reg.timer("span.verify.blocking")
    for i in range(2 * mod.RESERVOIR_SIZE + 7):
        t.update_ms((i * 37 % 101) / 7.0)
    reg.timer("span.attr.verify.prep").record_total(20, 101.5)
    reg.timer("span.attr.verify.prep").record_total(0, 3.0)
    reg.timer("empty")
    for name, v in (("g.num", 0.4963), ("g.int", 3), ("g.bool", True),
                    ("g.none", None), ("g.nan", float("nan")),
                    ("g.label", 'half-open "x"\nback\\slash')):
        reg.gauge(name).set(v)
    monkeypatch.undo()
    return reg


def test_registry_percentiles_and_prometheus_equal_the_reference(
        monkeypatch):
    port = _drive_registry(metrics, monkeypatch)
    ref = _drive_registry(jmetrics, monkeypatch)
    assert metrics.RESERVOIR_SIZE == jmetrics.RESERVOIR_SIZE == 512
    for name in ("span.verify.blocking", "span.attr.verify.prep", "empty"):
        a, b = port.timer(name), ref.timer(name)
        assert a.percentiles_ms((50, 90, 99)) == \
            b.percentiles_ms((50, 90, 99))
        assert a.percentile_ms(75) == b.percentile_ms(75)
        assert a.stddev_ms() == b.stddev_ms()
        assert a.to_dict() == b.to_dict()
    big = port.timer("span.verify.blocking")
    assert len(big._reservoir) == metrics.RESERVOIR_SIZE
    assert big.to_dict()["p99_ms"] > big.to_dict()["p50_ms"] > 0
    m = port.meter("crypto.verify.serve.device")
    assert m.windowed_rate() == \
        ref.meter("crypto.verify.serve.device").windowed_rate()
    text = port.to_prometheus()
    assert text == ref.to_prometheus()
    lines = text.splitlines()
    assert "crypto_transfer_bytes_h2d 262144" in lines
    assert "_9starts_with_digit 1" in lines
    assert "crypto_verify_serve_device_total 11" in lines
    # 4 marks 150 s apart, the window 300 s: the first was evicted
    assert "crypto_verify_serve_device_rate 0.010000" in lines
    assert 'g_label{value="half-open \\"x\\"\\nback\\\\slash"} 1' in lines
    assert 'g_none{value="none"} 1' in lines and "g_bool 1" in lines
    assert any(line.startswith('span_verify_blocking_ms{quantile="0.99"}')
               for line in lines)


def test_interp_percentile_equals_the_reference():
    for data in ([], [4.0], [1.0, 2.0], [0.5, 1.5, 9.0, 10.0, 11.25]):
        for q in (0, 1, 25, 50, 90, 99, 100):
            assert metrics._interp_percentile(data, q) == \
                jmetrics._interp_percentile(data, q)
    for name in ("a.b-c d", "0x", "ok_name:sub", ""):
        assert metrics._prom_name(name) == jmetrics._prom_name(name)


def _drive_trace(trc, tl):
    """One span tree on the main thread (a root, children, a grandchild,
    an instant), a span on a named worker thread linked by context, a span
    left open, and two pipeline records on a scripted clock, the second
    with no transfer record. Returns the Chrome trace."""
    trc.flight_recorder.clear()
    tl.pipeline_timeline._reset_for_testing()
    with trc.span("xfer.blocking", calls=1):
        with trc.span("xfer.prep"):
            trc.flight_recorder.note("xfer.reshard", parts=2)
        with trc.span("xfer.dispatch", device=0):
            with trc.zone("xfer.copy"):
                pass
        ctx = trc.current_context()

        def work():
            with trc.span_context(ctx), trc.span("xfer.fetch.device",
                                                 device=1):
                pass
        t = threading.Thread(target=work, name="xfer-worker")
        t.start()
        t.join()
    parked = trc.span("xfer.fetch", device=0)
    parked.__enter__()
    clock = iter([10.0, 11.0, 12.5, 14.0, 20.0, 21.0, 21.5, 30.0])
    pl = tl.pipeline_timeline
    pl._now = lambda: next(clock)
    try:
        for transfer in ({"round_trips": 1, "bytes_h2d": 262144,
                          "bytes_d2h": 2048, "redundant_constant_bytes": 0},
                         None):
            tok = pl.begin("crypto.verify")
            pl.note_dispatch(tok, 0)
            pl.note_delivery(tok, 0)
            if hasattr(pl, "close"):  # the port builds the record on read
                pl.close(tok, transfer=transfer)
            else:
                pl.finish(tok, transfer=transfer)
        out = trc.flight_recorder.to_chrome_trace()
    finally:
        del pl._now
        parked.__exit__(None, None, None)
        trc.flight_recorder.clear()
        pl._reset_for_testing()
    return out


def _shape(trace):
    """Every event with its timestamp and span id dropped (counter events
    kept whole: their clock is scripted)."""
    out = []
    for e in trace["traceEvents"]:
        if e["ph"] == "C":
            out.append(e)
            continue
        e = {k: v for k, v in e.items() if k != "ts"}
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items() if k != "id"}
        out.append(e)
    return out


def test_chrome_trace_equals_the_reference():
    got = _drive_trace(tracing, timeline)
    want = _drive_trace(jtracing, jtimeline)
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert _shape(got) == _shape(want)
    events = got["traceEvents"]
    names = [(e["name"], e["ph"]) for e in events if e["ph"] in "BE"]
    assert names == [
        ("span.xfer.blocking", "B"), ("span.xfer.prep", "B"),
        ("span.xfer.prep", "E"), ("span.xfer.dispatch", "B"),
        ("zone.xfer.copy", "B"), ("zone.xfer.copy", "E"),
        ("span.xfer.dispatch", "E"), ("span.xfer.blocking", "E"),
        ("span.xfer.fetch.device", "B"), ("span.xfer.fetch.device", "E")]
    instants = {e["name"]: e["args"] for e in events if e["ph"] == "i"}
    assert instants["xfer.reshard"]["parts"] == 2
    assert instants["span.xfer.fetch"]["open"] is True
    tracks = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert tracks == {"MainThread", "xfer-worker"}
    counters = [(e["name"], e["ts"], e["args"]) for e in events
                if e["ph"] == "C"]
    assert ("transfer.bytes", 14000.0, {"h2d": 262144, "d2h": 2048}) in \
        counters
    assert ("pipeline.dev0.inflight", 11000.0, {"inflight": 1}) in counters
    assert sum(name == "transfer.bytes" for name, _t, _a in counters) == 1
    assert sum(name == "pipeline.busy_frac" for name, _t, _a in counters) \
        == 2
    # a B/E pair nests inside its parent's interval
    ts = {(e["name"], e["ph"]): e["ts"] for e in events if e["ph"] in "BE"}
    assert ts[("span.xfer.blocking", "B")] <= ts[("zone.xfer.copy", "B")] \
        <= ts[("zone.xfer.copy", "E")] <= ts[("span.xfer.blocking", "E")]
