"""The port's benchmark runner, trace reader and trace exporter
(``stellar_tpu_torch/tools/run_benchmarks.py``, ``trace_kernel_time.py``,
``trace_export.py``) against the reference's ``tools/`` scripts.

``run_all`` of both packages calls the same harnesses with the same
keyword arguments in the same order (the harnesses stubbed), and
``render_table`` gives the same text; configs 3 and 4 run small in both
packages with their oracles, their records and header hashes equal. The
trace reader's ``union_ms`` is the reference's on seeded intervals, and
on a trace shaped as ``torch.profiler`` writes it counts only GPU events
(``kernel``, ``gpu_memcpy``, ``gpu_memset``) and raises on a trace with
none. The exporter's synthetic resolve (the port's on the CPU, the
reference's in host-only mode) and fleet window have the reference's
event kinds. The ``slow`` test recomputes ``chip_smoke.py`` phase 29's
pins of configs 1-3 at full scale with the reference's harnesses."""

import collections
import gzip
import importlib.util
import io
import json
import sys

import numpy as np
import pytest

import stellar_tpu.tx.ops  # noqa: F401 (fills the registry)
import stellar_tpu_torch.tx.ops  # noqa: F401
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.parallel import batch_engine as jengine
from stellar_tpu.simulation import load_generator as jlg
from stellar_tpu.utils import tracing as jtracing
from stellar_tpu.utils.timeline import pipeline_timeline as jtimeline
from stellar_tpu_torch.crypto import batch_hasher as pbh
from stellar_tpu_torch.crypto import ed25519_ref as pref
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.simulation import load_generator as plg
from stellar_tpu_torch.tools import run_benchmarks as prb
from stellar_tpu_torch.tools import trace_export as pte
from stellar_tpu_torch.tools import trace_kernel_time as ptk
from stellar_tpu_torch.utils import tracing as ptracing
from stellar_tpu_torch.utils.timeline import pipeline_timeline as ptimeline

from tests._torch_port import ROOT, chip_smoke_constants, harness_closes


def _ref_tool(name):
    """The reference's ``tools/<name>.py``, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rrb, rtk, rte = (_ref_tool(n) for n in ("run_benchmarks",
                                        "trace_kernel_time",
                                        "trace_export"))
_REAL_HASH_MANY = pbh.hash_many


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
    """Both packages verify with their oracles and flush their caches
    around each case; the port hashes on the CPU."""
    saved = (jkeys._backend, pkeys._backend)
    jkeys.set_verifier_backend(jref.verify)
    pkeys.set_verifier_backend(pref.verify)
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    monkeypatch.setattr(pbh, "hash_many", _cpu_hash_many)
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()


# ---------------- the runner ----------------

HARNESSES = ("apply_load", "multisig_apply_load", "catchup_replay_bench",
             "scp_storm_bench", "soroban_apply_load", "soroban_compute_load")


def _stub_harnesses(monkeypatch, lg, calls):
    """Each harness of ``lg`` records its name and keyword arguments and
    returns a record with every field ``render_table`` reads; its
    ``txs_per_sec`` varies from call to call, so the A/B's best-of-N
    choice is exercised."""
    def stub(name):
        def run(**kwargs):
            calls.append((name, kwargs))
            wasm = kwargs.get("use_wasm", False)
            return {"harness": name, "call": len(calls),
                    "txs_per_sec": float((len(calls) * 37) % 11),
                    "close_mean_ms": 1.5, "close_p99_ms": 2.5,
                    "tx_apply_per_sec": 100.0, "deep_spill_over_p50": 1.2,
                    "sigs_per_sec": 9.0, "ledgers": 5,
                    "ledgers_per_sec": 3.0, "replayed_ledgers": 125,
                    "rounds_per_sec": 0.5, "total_statements": 7440,
                    "signatures_per_ledger": 1500,
                    "engine": "wasm-native" if wasm else "scval",
                    "loop_iterations": 600}
        return run
    for name in HARNESSES:
        monkeypatch.setattr(lg, name, stub(name))


@pytest.mark.parametrize("quick", [False, True])
def test_runner_calls_equal_reference(monkeypatch, capsys, quick):
    """Both ``run_all``s, ``verify="host"``: the same harness calls with
    the same keyword arguments in order, the same records, every row
    naming the host oracle."""
    calls = {"port": [], "ref": []}
    _stub_harnesses(monkeypatch, plg, calls["port"])
    _stub_harnesses(monkeypatch, jlg, calls["ref"])
    pkeys.set_verifier_backend(None)
    jkeys.set_verifier_backend(None)
    got = prb.run_all(quick, verify="host")
    want = rrb.run_all(quick, verify="host")
    assert calls["port"] == calls["ref"]
    assert len(calls["port"]) == 4 + 2 * 2 * (1 if quick else 3)
    assert calls["port"][:4] == [
        ("apply_load", {"n_ledgers": 39 if quick else 130,
                        "txs_per_ledger": 100}),
        ("multisig_apply_load", {"n_ledgers": 1 if quick else 5,
                                 "txs_per_ledger": 300 if quick else 1000}),
        ("catchup_replay_bench", {"n_ledgers": 63 if quick else 130,
                                  "txs_per_ledger": 10}),
        ("scp_storm_bench", {"n_validators": 16,
                             "n_rounds": 1 if quick else 5})]
    assert got == want
    assert {r["verify_backend"] for r in got.values()} == {"host-oracle"}
    assert pkeys._backend is pref.verify
    capsys.readouterr()


def test_render_table_equals_reference(monkeypatch):
    calls = []
    _stub_harnesses(monkeypatch, plg, calls)
    results = prb.run_all(False, verify="host")
    table = prb.render_table(results)
    assert table == rrb.render_table(results)
    assert table.startswith(prb.BEGIN) and table.endswith(prb.END)
    assert table.count("\n| ") == 1 + 7   # the header and seven rows


def test_runner_writes_build_not_docs(monkeypatch, capsys, tmp_path):
    """``main`` writes the JSON and the table under ``build/`` (here a
    temporary directory), its last line names them, and the reference's
    ``docs/benchmarks.*`` stay as they are."""
    docs = {p: p.read_bytes() for p in (ROOT / "docs" / "benchmarks.json",
                                        ROOT / "docs" / "benchmarks.md")}
    _stub_harnesses(monkeypatch, plg, [])
    monkeypatch.setattr(prb, "REPO", tmp_path)
    monkeypatch.setattr(prb, "OUT_JSON", tmp_path / "build" / "b.json")
    monkeypatch.setattr(prb, "OUT_MD", tmp_path / "build" / "b.md")
    assert prb.main(["--quick", "--verify", "host"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["wrote"] == ["build/b.json", "build/b.md"]
    assert len(last["scenarios"]) == 8
    rows = json.loads((tmp_path / "build" / "b.json").read_text())
    assert sorted(rows) == last["scenarios"]
    assert prb.render_table(rows) in (tmp_path / "build" / "b.md").read_text()
    assert all(p.read_bytes() == b for p, b in docs.items())


def test_verify_device_raises_with_no_card(monkeypatch):
    """``--verify device`` takes the card or raises; it never falls back to
    the host."""
    _stub_harnesses(monkeypatch, plg, [])
    pkeys.set_verifier_backend(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prb.run_all(True, verify="device")
    assert pkeys._backend is None
    with pytest.raises(ValueError):
        prb.run_all(True, verify="card")


def _timeless(out):
    """A harness's record less what depends on the clock."""
    return {k: v for k, v in out.items()
            if not any(t in k for t in ("_ms", "_per_sec", "over_p50",
                                        "wall_s"))}


def test_catchup_replay_equals_reference():
    """Config 3 at one checkpoint (63 ledgers of 2 payments) in both
    packages: the records less their timings and every header hash, the
    chain's closes and the replay's, equal."""
    port = harness_closes("stellar_tpu_torch", "catchup_replay_bench",
                          n_ledgers=63, txs_per_ledger=2)
    ref = harness_closes("stellar_tpu", "catchup_replay_bench",
                         n_ledgers=63, txs_per_ledger=2)
    assert _timeless(port[0]) == _timeless(ref[0]) == {
        "scenario": "catchup-replay", "replayed_ledgers": 61,
        "txs_per_ledger": 2}
    assert port[1] == ref[1] and len(port[1]) == 63 + 61
    # the replay closes to the chain's own headers, from its first on
    assert port[1][63:] == port[1][:61]
    assert port[2] == ref[2]


def test_scp_storm_equals_reference():
    """Config 4 cut to 4 validators and one round in both packages: the
    records less their timings equal, in consensus."""
    port = plg.scp_storm_bench(n_validators=4, n_rounds=1)
    ref = jlg.scp_storm_bench(n_validators=4, n_rounds=1)
    assert _timeless(port) == _timeless(ref)
    assert port["total_statements"] > 0 and port["rounds"] == 1


# ---------------- the trace reader ----------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_union_ms_equals_reference(seed):
    """Seeded intervals, nested and overlapping among them, and the
    edge cases: the same covered time."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, 10_000, 200).astype(float)
    ivals = [(s, s + d) for s, d in zip(start, rng.integers(0, 500, 200))]
    outer = ivals[0]
    ivals += [(outer[0] + 1, outer[0] + 2), (outer[0], outer[1])]
    assert ptk.union_ms(list(ivals)) == rtk.union_ms(list(ivals))
    assert 0 < ptk.union_ms(list(ivals)) <= sum(e - s for s, e in ivals)
    for case in ([], [(5.0, 5.0)], [(0.0, 1000.0), (0.0, 1000.0)],
                 [(0.0, 10.0), (10.0, 20.0)]):
        assert ptk.union_ms(list(case)) == rtk.union_ms(list(case))


def _profiler_trace():
    """Events as ``torch.profiler``'s Chrome export gives them with CUDA
    activities: a host process with CUDA runtime calls, a device process
    with kernels, a copy, a memset and a GPU annotation spanning them."""
    evs = [
        {"ph": "M", "name": "process_name", "pid": 4242,
         "args": {"name": "python3 4242"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": ""}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 1, "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "pid": 4242, "tid": 1, "ts": 1000.0, "dur": 50.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "verify",
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 5000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
         "Device)", "pid": 0, "tid": 7, "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "verify_cold_kernel(unsigned "
         "char const*)", "pid": 0, "tid": 7, "ts": 200.0, "dur": 400.0,
         "args": {"grid": [32, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "verify_hot_kernel(short "
         "const*)", "pid": 0, "tid": 7, "ts": 500.0, "dur": 300.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 2000.0, "dur": 10.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
         "ts": 200.0, "id": 1},
    ]
    return {"schemaVersion": 1, "traceEvents": evs,
            "deviceProperties": [{"id": 0, "name": "a card"}]}


@pytest.mark.parametrize("gz", [False, True])
def test_analyze_counts_gpu_events_only(tmp_path, gz):
    """Device busy time is the union of the GPU-kind events alone (the
    kernels overlap, the annotation and the host's runtime calls are not
    counted); the top ops are those events by total time."""
    path = tmp_path / ("t.json.gz" if gz else "t.json")
    data = json.dumps(_profiler_trace())
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    out = ptk.analyze(str(path), 2)
    # [100, 800) covered by the copy and the two kernels, plus the memset
    assert out["device_busy_ms_per_iter"] == round((700 + 10) / 1000 / 2, 3)
    assert [(o["name"][:17], o["count"], o["total_ms"])
            for o in out["top_device_ops"]] == [
        ("verify_cold_kerne", 1, 0.4), ("verify_hot_kernel", 1, 0.3),
        ("Memcpy HtoD (Pinn", 1, 0.1), ("Memset (Device)", 1, 0.01)]
    assert out["processes"]["python3 4242"] == {
        "busy_ms_total": 0.95, "busy_ms_per_iter": 0.475, "n_events": 2}
    assert out["processes"][""]["n_events"] == 5
    assert set(out) == {"trace", "n_iters", "processes",
                        "device_busy_ms_per_iter", "top_device_ops"}


def test_analyze_raises_without_device_events(tmp_path):
    trace = _profiler_trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("cat") not in ptk.DEVICE_CATS]
    path = tmp_path / "host_only.json"
    path.write_text(json.dumps(trace))
    with pytest.raises(ptk.NoDeviceEvents):
        ptk.analyze(str(path), 3)


def test_trace_reader_main_prints_one_line(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_profiler_trace()))
    assert ptk.main([str(path), "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == ptk.analyze(str(path), 2)
    assert ptk.main([]) == 2


def test_capture_raises_without_cuda_activity(tmp_path):
    """On a PyTorch whose profiler cannot record CUDA (this CPU build),
    ``capture`` raises; it never reports 0 ms busy."""
    with pytest.raises(ptk.NoDeviceEvents):
        ptk.capture(lambda: None, 3, str(tmp_path / "t.json"))


def test_capture_raises_on_a_trace_with_no_device_event(monkeypatch,
                                                        tmp_path):
    """A profiler that records CUDA activity but sees none (no CUPTI, no
    card) writes a trace with only host events: ``capture`` raises. The
    function ran once untimed and then ``n_iters`` times under it."""
    import torch.profiler as tp
    calls = []

    class _Profile:
        def __init__(self, activities):
            assert activities == [tp.ProfilerActivity.CUDA]

        def __enter__(self):
            calls.append("enter")
            return self

        def __exit__(self, *exc):
            calls.append("exit")

        def export_chrome_trace(self, path):
            trace = _profiler_trace()
            trace["traceEvents"] = trace["traceEvents"][:4]
            with open(path, "w") as f:
                json.dump(trace, f)
    monkeypatch.setattr(tp, "supported_activities", lambda: {
        tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA})
    monkeypatch.setattr(tp, "profile", _Profile)
    with pytest.raises(ptk.NoDeviceEvents):
        ptk.capture(lambda: calls.append("fn"), 3, str(tmp_path / "t.json"))
    assert calls == ["fn", "enter", "fn", "fn", "fn", "exit"]


# ---------------- the exporter ----------------

def _validated(trace):
    """The trace through JSON, each B closed by its E on its track."""
    out = json.loads(json.dumps(trace))
    stacks = collections.defaultdict(list)
    for e in out["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "B":
            stacks[(e["pid"], e["tid"])].append(e["name"])
        elif e["ph"] == "E":
            assert stacks[(e["pid"], e["tid"])].pop() == e["name"]
    assert not any(stacks.values())
    return out


def _kinds(trace):
    return collections.Counter((e["ph"], e["name"])
                               for e in trace["traceEvents"])


def _fresh(recorder, timeline):
    recorder.clear()
    timeline._reset_for_testing()


def test_synthetic_export_shape_equals_reference():
    """The synthetic resolve: the port's on the CPU through its device
    path, the reference's in host-only mode (reset after). Both nest, carry
    one blocking root and the prep spans, and the same counter tracks of
    the scripted window; the port's resolve shows its dispatch and fetch
    where the reference's shows its host fallback."""
    _fresh(ptracing.flight_recorder, ptimeline)
    port = _validated(pte.synthetic_trace(device="cpu"))
    _fresh(jtracing.flight_recorder, jtimeline)
    try:
        ref = _validated(rte.synthetic_trace())
    finally:
        jengine._reset_dispatch_state_for_testing()
    pk, rk = _kinds(port), _kinds(ref)
    for kinds in (pk, rk):
        assert kinds[("B", "span.verify.blocking")] == 1
        assert kinds[("B", "span.verify.prep")] >= 1
        assert kinds[("M", "thread_name")] == 1
    assert {n for ph, n in pk if ph == "C"} == \
        {n for ph, n in rk if ph == "C"} == {
            "pipeline.busy_frac", "pipeline.dev0.inflight",
            "pipeline.dev1.inflight", "transfer.bytes"}
    # the scripted window's two-device series in both
    assert pk[("C", "pipeline.dev1.inflight")] == \
        rk[("C", "pipeline.dev1.inflight")] == 2
    assert rk[("B", "span.verify.host_fallback")] > 0
    assert pk[("B", "span.verify.host_fallback")] == 0
    assert pk[("B", "span.verify.dispatch")] > 0 and \
        pk[("B", "span.verify.fetch")] > 0
    counts = pte.event_counts(port)
    assert counts["spans"] > 0 and counts["instants"] > 0 and \
        counts["counters"] > 0


def test_fleet_export_equals_reference():
    """The three-replica fleet window over the instant stub: the same
    event kinds, a process track a replica, and one route, enqueue and
    schedule instant a submission in both."""
    _fresh(ptracing.flight_recorder, ptimeline)
    port = _validated(pte.synthetic_fleet_trace())
    _fresh(jtracing.flight_recorder, jtimeline)
    ref = _validated(rte.synthetic_fleet_trace())
    pk, rk = _kinds(port), _kinds(ref)
    assert set(pk) == set(rk)
    for key in (("i", "fleet.route"), ("i", "service.enqueue"),
                ("i", "service.schedule")):
        assert pk[key] == rk[key] == 12
    assert pk[("M", "process_name")] == rk[("M", "process_name")] == 3
    assert {k: v for k, v in pk.items() if k[0] == "C"} == \
        {k: v for k, v in rk.items() if k[0] == "C"}


def test_exporter_main_writes_the_file(tmp_path, monkeypatch):
    """``--fleet --out``: the file loads, and the stderr line counts its
    spans, instants and counter samples as the reference's does."""
    _fresh(ptracing.flight_recorder, ptimeline)
    out = tmp_path / "fleet.json"
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    assert pte.main(["--fleet", "--out", str(out)]) == 0
    trace = _validated(json.loads(out.read_text()))
    c = pte.event_counts(trace)
    assert err.getvalue().strip().splitlines()[-1] == (
        f"trace-export: {c['events']} events ({c['spans']} spans, "
        f"{c['instants']} instants, {c['counters']} counter samples) -> "
        f"{out}")


# ---------------- phase 29's pins ----------------

@pytest.mark.slow
@pytest.mark.parametrize("scenario,harness,kwargs", [
    ("close", "apply_load", {"n_ledgers": 130, "txs_per_ledger": 100}),
    ("multisig", "multisig_apply_load",
     {"n_ledgers": 5, "txs_per_ledger": 1000}),
    ("catchup", "catchup_replay_bench",
     {"n_ledgers": 130, "txs_per_ledger": 10})])
def test_phase29_pins_are_the_reference(scenario, harness, kwargs):
    """``run_all``'s configs 1-3 at full scale on the reference with its
    oracle: the last header hash and the fields less timings are
    ``chip_smoke.py``'s ``BENCH_PINS``."""
    out, hashes, _meta = harness_closes("stellar_tpu", harness, **kwargs)
    last_hash, fields = chip_smoke_constants()["BENCH_PINS"][scenario]
    assert hashes[-1] == last_hash
    assert _timeless(out) == fields
