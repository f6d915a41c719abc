"""The port's four engine self-checks (``stellar_tpu_torch/tools/
metrics_selfcheck.py``, ``transfer_selfcheck.py``,
``pipeline_selfcheck.py``, ``hot_signer_selfcheck.py``) against the
reference's ``tools/`` scripts, where no JAX compile is needed: the
constants, the exposition pattern, the K3 corpora, the hot signer's
corpus bytes and batch stream, the record keys, and the partition's
``hot_rows``/``cold_rows`` meters over a stubbed engine. The reference's
metrics self-check (host-only, no compile) runs in a subprocess beside
the port's on the CPU; the port's transfer self-check passes on
``["cpu"] * 4``; a gate made to fail gives exit 1 and one JSON line.
``tests/test_torch_pipeline_selfcheck.py`` and
``tests/test_torch_hot_selfcheck.py`` run the other two tools on the
CPU."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from stellar_tpu_torch.crypto import batch_verifier as pbv
from stellar_tpu_torch.parallel import batch_engine as pengine
from stellar_tpu_torch.parallel import signer_tables as pst
from stellar_tpu_torch.tools import hot_signer_selfcheck as phs
from stellar_tpu_torch.tools import metrics_selfcheck as pms
from stellar_tpu_torch.tools import pipeline_selfcheck as pps
from stellar_tpu_torch.tools import transfer_selfcheck as pts
from stellar_tpu_torch.utils.metrics import registry

from tests._torch_port import ROOT

TOOLS = ("metrics_selfcheck", "transfer_selfcheck", "pipeline_selfcheck",
         "hot_signer_selfcheck")
PORT = dict(zip(TOOLS, (pms, pts, pps, phs)))


def _ref_tool(name):
    """The reference's ``tools/<name>.py``, imported from its file (its
    JAX imports sit inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = {name: _ref_tool(name) for name in TOOLS}


def _run_tool(module, *args, timeout=120):
    """``python -m stellar_tpu_torch.tools.<module> args``: the exit code
    and the one JSON line it printed."""
    proc = subprocess.run(
        [sys.executable, "-m", f"stellar_tpu_torch.tools.{module}",
         *args], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, (proc.stdout[-2000:], proc.stderr[-3000:])
    return proc.returncode, json.loads(lines[0])


def _ref_record_keys(name):
    """The keys of the dict literal the reference's ``run()`` (or
    ``main()``, for the metrics check) returns or prints."""
    tree = ast.parse((ROOT / "tools" / f"{name}.py").read_text())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("run", "main"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict) and any(
                        isinstance(k, ast.Constant) and k.value == "ok"
                        for k in node.keys):
                    keys |= {k.value for k in node.keys}
    assert keys, name
    return keys


CONSTANTS = {
    "metrics_selfcheck": ("MIN_COVERAGE", "N_SIGS"),
    "transfer_selfcheck": ("N_DEV", "BUCKET", "MIN_RECONCILE"),
    "pipeline_selfcheck": ("N_DEV", "BUCKET", "PIPELINE_CHUNKS", "STALL_S",
                           "MIN_RECONCILE", "MIN_STALL_ATTRIBUTED",
                           "MIN_OVERLAP", "PIPELINE_TRIES"),
    "hot_signer_selfcheck": ("N_DEV", "BUCKET", "SUB", "N_SIGNERS",
                             "FRESH_PER_BATCH", "HOT_HEAD",
                             "MIN_RECONCILE"),
}


@pytest.mark.parametrize("name", TOOLS)
def test_constants_equal_reference(name):
    for const in CONSTANTS[name]:
        assert getattr(PORT[name], const) == getattr(REF[name], const), \
            const
    # every upper-case constant the reference defines is listed above
    ref_consts = {k for k, v in vars(REF[name]).items()
                  if k.isupper() and isinstance(v, (int, float))
                  and k != "REPO"}
    assert ref_consts == set(CONSTANTS[name])


def test_prom_sample_pattern_equals_reference():
    ref = REF["metrics_selfcheck"]._PROM_SAMPLE
    assert pms._PROM_SAMPLE.pattern == ref.pattern
    registry.counter("crypto.selfcheck.test").inc()
    lines = [ln for ln in registry.to_prometheus().splitlines()
             if ln and not ln.startswith("#")]
    lines += ['x{a="b\\"c"} 1', "x 1e-3", "x nan", "1x 1", "x{a=b} 1",
              "x 1 2"]
    assert [bool(pms._PROM_SAMPLE.match(ln)) for ln in lines] == \
        [bool(ref.match(ln)) for ln in lines]
    assert all(pms._PROM_SAMPLE.match(ln) for ln in lines[:-6])


def test_k3_corpora_equal_reference():
    assert pts._corpus(pts.BUCKET) == REF["transfer_selfcheck"]._corpus(
        pts.BUCKET)
    ref = REF["pipeline_selfcheck"]
    for i in (0, 1, 2, 3, 10, 11, 12):
        for n in (pps.BUCKET, pps.BUCKET * pps.PIPELINE_CHUNKS):
            assert pps._corpus(i, n) == ref._corpus(i, n)


def test_hot_corpus_equals_reference(monkeypatch):
    """The port's ``ed25519_ref`` signs the reference's corpus byte for
    byte and its oracle gives the same verdicts (at 12 signers)."""
    ref = REF["hot_signer_selfcheck"]
    monkeypatch.setattr(ref, "N_SIGNERS", 12)
    rpool, rwant = ref._corpus()
    ppool, pwant = phs._corpus(12)
    assert ppool == rpool
    assert pwant.tolist() == rwant.tolist()
    assert pwant.tolist() == [True] * 12 + [False, False]


@pytest.mark.parametrize("n", [12, 30, phs.N_SIGNERS])
def test_hot_batches_equal_reference(monkeypatch, n):
    ref = REF["hot_signer_selfcheck"]
    monkeypatch.setattr(ref, "N_SIGNERS", n)
    assert phs._batches(n) == ref._batches([None] * (n + 2))


@pytest.mark.parametrize("name", TOOLS[1:])
def test_record_keys_cover_reference(name):
    """Every key of the reference's record is in the port's (read from
    the port's source the same way)."""
    ref_keys = _ref_record_keys(name)
    tree = ast.parse(open(PORT[name].__file__).read())
    port_keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "ok"
                for k in node.keys):
            port_keys |= {k.value for k in node.keys}
    assert ref_keys <= port_keys, ref_keys - port_keys


def test_metrics_selfcheck_equals_reference(capsys):
    """The reference's check (host-only) in a subprocess and the port's
    (one K1 resolve through the plain version) on the CPU: both ``ok``,
    one JSON line each with the same keys, the port's adding its
    device."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "metrics_selfcheck.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    enabled = pst.signer_table_cache.enabled
    assert pms.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    port = json.loads(lines[0])
    assert ref["ok"] and port["ok"], (ref, port)
    assert set(port) == set(ref) | {"device"}
    assert port["device"] == "cpu"
    assert port["coverage"] >= pms.MIN_COVERAGE
    assert pst.signer_table_cache.enabled == enabled


def test_metrics_gate_failure_exits_1(monkeypatch, capsys):
    """A gate made to fail (coverage above 1 required) gives exit 1 and
    one JSON line naming it."""
    monkeypatch.setattr(pms, "MIN_COVERAGE", 1.01)
    assert pms.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ok"] is False
    assert len(rec["problems"]) == 1 and "covers" in rec["problems"][0]


def test_transfer_selfcheck_passes_on_cpu():
    rc, rec = _run_tool("transfer_selfcheck", "--device", "cpu")
    assert rc == 0 and rec["ok"], rec["problems"]
    assert (rec["device"], rec["devices"], rec["bucket"]) == ("cpu", 4, 8)
    assert rec["redundant_constant_bytes"] == 0
    assert rec["resident_hits"] > 0
    assert rec["detector"]["redundant_constant_bytes"] > 0
    assert rec["reconciliation"] >= pts.MIN_RECONCILE
    assert rec["fault_counters"]["device.dispatch"]["fired"] > 0
    # the process's setting (off) came back after the windows
    assert rec["resident_cache"] == {"on_in_windows": True,
                                     "restored_to": False}


def _stub_submit(self, items, trace_ids=None, variant=None):
    n = len(items)
    return lambda: np.ones(n, dtype=bool)


def test_partition_meters_equal_reference(monkeypatch):
    """The hot/cold partition over the hot self-check's first batches,
    both engines' dispatch stubbed: the ``hot_rows`` and ``cold_rows``
    meters and the cache tallies move alike in both packages."""
    from stellar_tpu.crypto import batch_verifier as jbv
    from stellar_tpu.parallel import batch_engine as jengine
    from stellar_tpu.parallel import signer_tables as jst
    from stellar_tpu.utils.metrics import registry as jregistry
    monkeypatch.setattr(pengine.BatchEngine, "submit", _stub_submit)
    monkeypatch.setattr(jengine.BatchEngine, "submit", _stub_submit)
    pool, _want = phs._corpus(12)
    batches = phs._batches(12) * 2
    names = [f"crypto.verify.signer_table.{k}_rows" for k in ("hot",
                                                              "cold")]
    moved = {}
    for side, (verifier, cache, reg) in {
            "port": (pbv.BatchVerifier(device="cpu", bucket_sizes=(8,)),
                     pst.signer_table_cache, registry),
            "reference": (jbv.BatchVerifier(bucket_sizes=(8,)),
                          jst.signer_table_cache, jregistry)}.items():
        cache._reset_for_testing()
        before = [reg.meter(n).count for n in names]
        try:
            for idx in batches:
                verifier.submit([pool[k] for k in idx])()
            snap = cache.snapshot()
        finally:
            cache._reset_for_testing()
        moved[side] = [reg.meter(n).count - b
                       for n, b in zip(names, before)] + \
            [snap[k] for k in ("hits", "misses", "installs")]
    assert moved["port"] == moved["reference"]
    assert moved["port"][0] > 0 and moved["port"][1] > 0


def test_attribution_share_equals_the_phase_timer(monkeypatch):
    """On a clock that ticks 1 ms a read: a phase's attributed share is
    the time its own timer keeps, and the root's time holds the phase's
    and the instruments' own reads around it."""
    from stellar_tpu_torch.utils import tracing
    ticks = iter(range(1000))
    monkeypatch.setattr(tracing.time, "perf_counter",
                        lambda: next(ticks) / 1000.0)
    before = tracing.span_totals()
    with tracing.span("selfcheck.blocking",
                      _collect=("selfcheck.prep",)):
        with tracing.span("selfcheck.prep"):
            pass
    after = tracing.span_totals()

    def moved(name):
        b = before.get(name, {"count": 0, "sum_ms": 0.0})
        return (after[name]["count"] - b["count"],
                round(after[name]["sum_ms"] - b["sum_ms"], 6))

    assert moved("span.attr.selfcheck.prep") == \
        moved("span.selfcheck.prep") == (1, 1.0)
    count, root_ms = moved("span.selfcheck.blocking")
    assert count == 1 and root_ms > 1.0


def _instant_kernel(*ops):
    """A verdict of True a row at once, as a launch on the card returns
    before its kernel ends."""
    import torch
    return torch.ones(ops[0].shape[0], dtype=torch.bool)


def test_resolve_bookkeeping_is_outside_every_phase(monkeypatch):
    """The open fault of a short call (ROADMAP queue 3): the resolve's
    own bookkeeping, here the timeline's close, runs inside the blocking
    root and outside every phase, so a 64-row K1 call of about 4 ms on
    the card, with no first sight to build in ``prep``, leaves more than
    5% of its time unattributed. A close made 200 ms slow adds 200 ms to
    the root and nothing to the phases."""
    import time

    from stellar_tpu_torch.utils import tracing
    from stellar_tpu_torch.utils.timeline import pipeline_timeline
    monkeypatch.setattr(pbv.Ed25519Workload, "kernel_fn",
                        lambda self: _instant_kernel)
    close = pipeline_timeline.close

    def slow_close(*a, **k):
        time.sleep(0.2)
        return close(*a, **k)
    monkeypatch.setattr(pipeline_timeline, "close", slow_close)
    ref = REF["metrics_selfcheck"]
    items = pms.signer_pool()
    enabled = pst.signer_table_cache.enabled
    pst.signer_table_cache.configure(enabled=False)
    try:
        v = pbv.BatchVerifier(device="cpu", bucket_sizes=(ref.N_SIGS,))
        before = tracing.span_totals()
        assert v.verify_batch(items * (ref.N_SIGS // 8)).all()
        att = pbv.dispatch_attribution(before, tracing.span_totals())
    finally:
        pst.signer_table_cache.configure(enabled=enabled)
    unattributed = att["blocking_span_per_rep_ms"] - \
        att["span_sum_per_rep_ms"]
    assert unattributed >= 200.0
    assert att["coverage"] < pms.MIN_COVERAGE


def test_timeseries_snapshot_shares_its_samples():
    """The ring's snapshot copies its lists, not its samples: a sample is
    the ring's own immutable ``(t_s, value)``, which serializes as the
    reference's ``[t_s, value]``, and a caller that edits the returned
    list leaves the ring alone."""
    from stellar_tpu_torch.utils.metrics import TimeSeriesRing
    ring = TimeSeriesRing(registry, prefixes=("crypto.selfcheck.ts",))
    g = registry.gauge("crypto.selfcheck.ts.g")
    for i in range(3):
        g.set(float(i))
        ring.sample_once()
    samples = ring.snapshot()["series"]["crypto.selfcheck.ts.g"]["samples"]
    assert [type(p) for p in samples] == [tuple] * 3
    assert [v for _t, v in json.loads(json.dumps(samples))] == \
        [0.0, 1.0, 2.0]
    samples.clear()
    again = ring.snapshot()["series"]["crypto.selfcheck.ts.g"]["samples"]
    assert [v for _t, v in again] == [0.0, 1.0, 2.0]
