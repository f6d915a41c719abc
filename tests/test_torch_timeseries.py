"""The port's time-series ring and the rest of its observability plane
against the reference's: ``TimeSeriesRing`` (``utils/metrics.py``), the
registry extras, ``tracing.current_zones``, ``tracing.frame_mark``,
``FlightRecorder.configure`` and ``PipelineTimeline.configure``.

Each ring test drives the port's ring over the port's registry and the
reference's ring over the reference's registry with the same sequence,
as ``tests/test_timeline.py``'s time-series tests drive the reference's
alone, and holds the two snapshots equal but for the timestamps.
"""

import threading

import pytest

from stellar_tpu.utils import metrics as jm
from stellar_tpu.utils import timeline as jtl
from stellar_tpu.utils import tracing as jtr
from stellar_tpu_torch.utils import metrics as pm
from stellar_tpu_torch.utils import timeline as ptl
from stellar_tpu_torch.utils import tracing as ptr

SIDES = {"port": (pm, ptr), "reference": (jm, jtr)}


def _values(snap: dict) -> dict:
    """A snapshot without its clock: values, windows, flags, anomalies
    (their series, value, baseline and z) and the sampling block."""
    out = {n: (s["n"], s["window"], s["partial"],
               [v for _t, v in s["samples"]])
           for n, s in snap["series"].items()}
    anomalies = [(a["series"], a["value"], a["mu"], a["z"])
                 for a in snap["anomalies"]]
    return {"series": out, "anomalies": anomalies,
            "sampling": dict(snap["sampling"])}


def _both(drive):
    """``drive(metrics, tracing)`` on each package; returns both
    results."""
    return {side: drive(*mods) for side, mods in SIDES.items()}


def test_counter_delta_and_gauge_value():
    def drive(m, _t):
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pa.",))
        c, g = m.registry.counter("tst.pa.c"), m.registry.gauge("tst.pa.g")
        mt, tm = m.registry.meter("tst.pa.m"), m.registry.timer("tst.pa.t")
        c.inc(10)
        g.set(2.5)
        mt.mark(4)
        for ms in (1.0, 2.0, 30.0):
            tm.update_ms(ms)
        ring.sample_once()
        c.inc(3)
        c.dec(1)
        mt.mark()
        tm.update_ms(4.0)
        registry_gauge_label = m.registry.gauge("tst.pa.label")
        registry_gauge_label.set("open")   # not a number: skipped
        ring.sample_once()
        return _values(ring.snapshot())
    got = _both(drive)
    assert got["port"] == got["reference"]
    s = got["port"]["series"]
    assert s["tst.pa.c.count"][3] == [0.0, 2.0]     # deltas, not counts
    assert s["tst.pa.g"][3] == [2.5, 2.5]
    assert s["tst.pa.m.count"][3] == [0.0, 1.0]
    assert s["tst.pa.t.count"][3] == [0.0, 1.0]
    assert "tst.pa.label" not in s
    assert s["tst.pa.g"][2] is True                 # partial window


def test_window_bound_and_partial_flag():
    def drive(m, _t):
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pb.",))
        ring.configure(samples=8)
        g = m.registry.gauge("tst.pb.g")
        for i in range(20):
            g.set(float(i))
            ring.sample_once()
        snap = ring.snapshot()
        tail = ring.snapshot(limit=3)["series"]["tst.pb.g"]["samples"]
        return _values(snap), [v for _t, v in tail], \
            ring.snapshot(series="tst.pb.none")["series"]
    got = _both(drive)
    assert got["port"] == got["reference"]
    values, tail, none = got["port"]
    s = values["series"]["tst.pb.g"]
    assert s[:3] == (8, 8, False)
    assert s[3] == [float(i) for i in range(12, 20)]
    assert tail == s[3][-3:] and none == {}


def test_anomaly_fires_once_and_dumps_recorder():
    def drive(m, t):
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pc.",))
        ring.configure(min_samples=8, sustain=3, z=6.0)
        g = m.registry.gauge("tst.pc.g")
        dumps = t.flight_recorder.stats()["dumps_total"]
        fired = m.registry.counter("metrics.timeseries.anomalies").count
        for i in range(20):
            g.set(5.0 + (i % 3) * 0.01)
            ring.sample_once()
        for _ in range(6):                  # a sustained excursion
            g.set(50.0)
            ring.sample_once()
        for _ in range(4):                  # back to normal: re-armed
            g.set(5.0)
            ring.sample_once()
        stats = t.flight_recorder.stats()
        return (_values(ring.snapshot()),
                m.registry.counter("metrics.timeseries.anomalies").count
                - fired, stats["dumps_total"] - dumps,
                any(r.startswith("timeseries-anomaly:tst.pc.g")
                    for r in stats["dump_reasons"]))
    got = _both(drive)
    assert got["port"] == got["reference"]
    values, fired, dumps, reason = got["port"]
    assert len(values["anomalies"]) == 1 and fired == 1 and dumps == 1
    assert values["anomalies"][0][0] == "tst.pc.g" and reason


def test_constant_baseline_jump_fires():
    def drive(m, _t):
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pf.",))
        ring.configure(min_samples=4, sustain=1)
        g = m.registry.gauge("tst.pf.g")
        for v in [1.0] * 10 + [2.0] * 3:
            g.set(v)
            ring.sample_once()
        return _values(ring.snapshot())
    got = _both(drive)
    assert got["port"] == got["reference"]
    assert got["port"]["anomalies"][0][3] == 1e9


def test_series_cap_counts_drops(monkeypatch):
    def drive(m, _t):
        monkeypatch.setattr(m, "MAX_SERIES", 2)
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pd.",))
        for i in range(4):
            m.registry.gauge(f"tst.pd.g{i}").set(1.0)
        ring.sample_once()
        return _values(ring.snapshot())
    got = _both(drive)
    assert got["port"] == got["reference"]
    assert len(got["port"]["series"]) == 2
    assert got["port"]["sampling"]["dropped_series"] == 2


def test_max_series_configurable_per_ring():
    def drive(m, _t):
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pm.",))
        ring.configure(max_series=8)
        for i in range(12):
            m.registry.gauge(f"tst.pm.g{i}").set(1.0)
        ring.sample_once()
        low = m.TimeSeriesRing(m.registry, prefixes=("tst.pm.",))
        low.configure(max_series=1, samples=1, z=0.1, sustain=0,
                      min_samples=0, interval_s=0.0)
        return _values(ring.snapshot()), _values(low.snapshot())
    got = _both(drive)
    assert got["port"] == got["reference"]
    snap, low = got["port"]
    assert len(snap["series"]) == 8
    assert snap["sampling"]["max_series"] == 8
    assert snap["sampling"]["dropped_series"] == 4
    assert {k: low["sampling"][k] for k in (
        "max_series", "window", "z", "sustain", "min_samples",
        "interval_s")} == {"max_series": 8, "window": 8, "z": 1.0,
                           "sustain": 1, "min_samples": 2,
                           "interval_s": 0.01}


def test_tenant_gauges_bounded_under_series_cap(monkeypatch):
    """The port's tenant monitor publishes rank-keyed gauges only, so a
    ring over its namespace tracks as many series as the reference's and
    drops none."""
    from stellar_tpu.crypto import tenant as jtn
    from stellar_tpu_torch.crypto import tenant as ptn

    def drive(m, tn):
        saved = (tn.TENANT_TOPK, tn.TENANT_TRACK_CAP)
        mon = tn.TenantSloMonitor(window=16)
        monkeypatch.setattr(tn, "tenant_slo", mon)
        try:
            tn.configure_tenants(topk=8, track_cap=4096)
            for i in range(300):
                mon.note_completion(f"z{i:04d}", ok=(i % 3 != 0))
            mon.publish_topk()
            ring = m.TimeSeriesRing(m.registry,
                                    prefixes=("crypto.verify.tenant.",))
            ring.sample_once()
            return _values(ring.snapshot())
        finally:
            tn.configure_tenants(topk=saved[0], track_cap=saved[1])
    port, ref = drive(pm, ptn), drive(jm, jtn)
    assert port == ref
    assert port["sampling"]["tracked_series"] <= 8 * 4 + 16
    assert port["sampling"]["dropped_series"] == 0


def test_sampler_thread_start_stop():
    def drive(m, _t):
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pe.",))
        m.registry.gauge("tst.pe.g").set(1.0)
        ring.start(interval_s=0.01)
        ring.start()                        # idempotent
        thread = ring._thread
        for _ in range(200):
            if ring.snapshot()["sampling"]["ticks"] >= 2:
                break
            threading.Event().wait(0.01)
        running = ring.snapshot()["sampling"]["running"]
        ring.stop()
        ring.stop()                         # a second stop is harmless
        snap = ring.snapshot()["sampling"]
        return (running, snap["ticks"] >= 2, snap["running"],
                thread.is_alive(), thread.name)
    got = _both(drive)
    assert got["port"] == got["reference"] == (
        True, True, False, False, "metrics-timeseries")


def test_reset_and_module_ring():
    for m, _t in SIDES.values():
        ring = m.TimeSeriesRing(m.registry, prefixes=("tst.pz.",))
        m.registry.gauge("tst.pz.g").set(3.0)
        ring.sample_once()
        ring._reset_for_testing()
        snap = ring.snapshot()
        assert snap["series"] == {} and snap["sampling"]["ticks"] == 0
        assert isinstance(m.timeseries, m.TimeSeriesRing)
        assert m.timeseries._prefixes == ("crypto.",)
        assert (m.TIMESERIES_SAMPLES, m.TIMESERIES_INTERVAL_S, m.ANOMALY_Z,
                m.ANOMALY_SUSTAIN, m.ANOMALY_MIN_SAMPLES, m.MAX_SERIES) == \
            (512, 1.0, 6.0, 3, 32, 1024)
    assert set(pm.__all__) == set(jm.__all__)


def test_registry_extras_equal_reference():
    """``Counter.dec``, ``Timer.time``, ``Meter.one_minute_rate`` and
    ``MetricsRegistry.clear`` on fresh registries."""
    out = {}
    for side, (m, _t) in SIDES.items():
        reg = m.MetricsRegistry()
        c = reg.counter("x.c")
        c.inc(5)
        c.dec()
        c.dec(2)
        mt = reg.meter("x.m")
        mt.mark(3)
        t = reg.timer("x.t")
        with t.time():
            pass
        with t.time():
            threading.Event().wait(0.002)
        out[side] = (c.count, mt.one_minute_rate() == mt.windowed_rate(),
                     t.count, t.sum_ms() > 1.0, sorted(reg.to_dict()))
        reg.clear()
        assert reg.to_dict() == {} and reg.counter("x.c").count == 0
    assert out["port"] == out["reference"]
    assert out["port"][:3] == (2, True, 2)


def test_current_zones_and_frame_mark_equal_reference():
    def drive(m, t):
        seen = [t.current_zones()]
        with t.span("outer"):
            with t.zone("inner"):
                seen.append(t.current_zones())
                ctx = t.current_context()
                box = []

                def other():
                    with t.span_context(ctx):
                        box.append(t.current_zones())
                        with t.span("child"):
                            box.append(t.current_zones())
                th = threading.Thread(target=other)
                th.start()
                th.join()
                seen += box
            seen.append(t.current_zones())
        seen.append(t.current_zones())
        meter = m.registry.meter("frame.ledger_close")
        before = meter.count
        for _ in range(3):
            t.frame_mark()
        return seen, meter.count - before
    got = _both(drive)
    assert got["port"] == got["reference"]
    assert got["port"] == ([[], ["outer", "inner"], [], ["child"],
                            ["outer"], []], 3)
    assert "current_zones" in ptr.__all__ and "frame_mark" in ptr.__all__


def test_frame_mark_reaches_a_ring():
    ring = pm.TimeSeriesRing(pm.registry, prefixes=("frame.",))
    ring.sample_once()
    ptr.frame_mark()
    ptr.frame_mark()
    ring.sample_once()
    s = ring.snapshot()["series"]["frame.ledger_close.count"]["samples"]
    assert [v for _t, v in s] == [0.0, 2.0]


@pytest.mark.parametrize("capacity", [4, 16, 40])
def test_flight_recorder_configure_equals_reference(capacity):
    def drive(_m, t):
        rec = t.FlightRecorder(capacity=64)
        for i in range(50):
            rec.finish_span({"id": i, "name": f"s{i}", "dur_ms": 1.0})
        rec.configure(None)
        rec.configure(capacity)
        ids = [r["id"] for r in rec.snapshot(limit=1000)["recent"]]
        return rec._ring.maxlen, ids
    got = _both(drive)
    assert got["port"] == got["reference"]
    cap, ids = got["port"]
    assert cap == max(16, capacity) and ids == list(range(50))[-cap:]


@pytest.mark.parametrize("resolves", [1, 4, 12])
def test_pipeline_timeline_configure_equals_reference(resolves):
    out = {}
    for side, tl in (("port", ptl), ("reference", jtl)):
        p = tl.PipelineTimeline(resolves=32)
        for i in range(20):
            tok = p.begin(f"ns{i}")
            p.finish(tok)
        p.configure(None)
        p.configure(resolves)
        out[side] = (p._ring.maxlen, [r["ns"] for r in p.recent(100)])
    assert out["port"] == out["reference"]
    assert out["port"][0] == max(4, resolves)
    assert len(out["port"][1]) == max(4, resolves)
