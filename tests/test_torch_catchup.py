"""The port's catchup (``stellar_tpu_torch.catchup``, ``history``,
``historywork``, ``work``, ``process``, ``utils.scheduler``, ``utils.timer``,
``utils.status``) against the reference's.

The copies are held to the reference's source (``_torch_port.check_copy``).
The work system's state sequences and retries, the clock's and the
scheduler's, and the checkpoint math are equal in both packages. Both
packages build the same two-checkpoint chain (``vectors.catchup_plan`` at
four senders over ``vectors.catchup_root``: the upgrade to state archival
at ledger 3 evicts two entries into the hot archive, and ledgers 64 to 127
carry the payments): their envelopes, headers and archives are equal
record for record after gunzip, with equal HAS JSON. ``COMPLETE``,
``MINIMAL`` and ``RECENT`` catchups give equal LCL hashes, stores, bucket
lists and hot archives from either package's archive. A divergent replay
raises ``ValueError`` with the same message in both, trust anchors refuse
with the same status lines, the coalesced prefetch makes the same calls,
and ``SKIP_KNOWN_RESULTS`` verifies nothing. ``chip_smoke.py``'s pinned
``CATCHUP_LCL_HASH`` is checked by a ``slow`` test.

Both packages verify through their pure-Python oracles unless a case
installs another backend, and the port hashes through ``hash_many`` on the
CPU (the plain K3): with no card it raises from 32 blobs on, and a
checkpoint holds 61 to 64 headers. No JAX program is compiled.
"""

import gzip
import json
import os

import numpy as np
import pytest

from stellar_tpu_torch.crypto import batch_hasher as pbh
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
from stellar_tpu_torch.parallel import signer_tables

from tests._torch_chain import NID, PORT, REF
from tests._torch_port import chip_smoke_constants, check_copy

MODULES = ["utils/scheduler.py", "utils/timer.py", "utils/status.py",
           "work/__init__.py", "work/work.py", "process/__init__.py",
           "process/process_manager.py", "history/__init__.py",
           "history/history_manager.py", "historywork/__init__.py",
           "catchup/__init__.py", "catchup/catchup.py"]

SENDERS = 4
PLAN_SEED = 1515
CATCHUP_KNOBS = ("SKIP_KNOWN_RESULTS", "BUCKET_APPLY_DELAY_MS",
                 "WAIT_MERGES_ON_APPLY")


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


_REAL_HASH_MANY = pbh.hash_many


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
    """Both packages verify with their oracles and flush their caches
    around each case; the port hashes on the CPU; the catchup module's
    knobs and the invariant managers are restored."""
    saved = (REF.keys._backend, PORT.keys._backend)
    knobs = [(s, k, getattr(s.cu, k)) for s in (PORT, REF)
             for k in CATCHUP_KNOBS]
    REF.keys.set_verifier_backend(REF.ref.verify)
    PORT.keys.set_verifier_backend(PORT.ref.verify)
    for side in (PORT, REF):
        side.keys.flush_verify_cache()
    monkeypatch.setattr(pbh, "hash_many", _cpu_hash_many)
    yield
    REF.keys.set_verifier_backend(saved[0])
    PORT.keys.set_verifier_backend(saved[1])
    for side, k, v in knobs:
        setattr(side.cu, k, v)
    for side in (PORT, REF):
        side.keys.flush_verify_cache()
        side.inv.set_active_manager(None)


# ---------------- the work system, the clock, the scheduler ----------------

def _function_work(s):
    ws = s.work.WorkScheduler(s.timer.VirtualClock(s.timer.VIRTUAL_TIME))
    log = []
    a = ws.schedule(s.work.FunctionWork("a", lambda: log.append("a")))
    b = ws.schedule(s.work.FunctionWork("b", lambda: log.append("b")))
    return {"done": ws.run_until_done(10), "log": log,
            "states": [a.state, b.state], "now": ws.clock.now()}


def _sequence_failure(s):
    ws = s.work.WorkScheduler(s.timer.VirtualClock(s.timer.VIRTUAL_TIME))
    log = []
    seq = s.work.WorkSequence("seq", max_retries=0)
    seq.add_child(s.work.FunctionWork("one", lambda: log.append(1)))
    seq.add_child(s.work.FunctionWork("two", lambda: log.append(2)))
    seq.add_child(s.work.FunctionWork("fail",
                                      lambda: s.work.State.FAILURE))
    seq.add_child(s.work.FunctionWork("never", lambda: log.append(3)))
    ws.schedule(seq)
    ws.run_until_done(10)
    return {"log": log, "state": seq.state,
            "children": [c.state for c in seq.children]}


def _retry_then_success(s):
    """A flaky work, its state after every crank of the clock."""
    clock = s.timer.VirtualClock(s.timer.VIRTUAL_TIME)
    ws = s.work.WorkScheduler(clock)
    attempts = []

    def flaky():
        attempts.append(clock.now())
        return s.work.State.FAILURE if len(attempts) < 3 else \
            s.work.State.SUCCESS
    w = ws.schedule(s.work.FunctionWork("flaky", flaky, max_retries=5))
    trace = []
    while not w.is_done() and len(trace) < 100:
        clock.crank(block=True)
        trace.append((clock.now(), w.state, w.retries))
    return {"state": w.state, "attempts": attempts, "trace": trace}


def _batch(s, parallel, n, fail_once):
    ws = s.work.WorkScheduler(s.timer.VirtualClock(s.timer.VIRTUAL_TIME))
    done, attempts = [], {}

    def item(i):
        attempts[i] = attempts.get(i, 0) + 1
        if fail_once and attempts[i] == 1:
            return s.work.State.FAILURE
        done.append(i)
        return s.work.State.SUCCESS

    class Batch(s.work.BatchWork):
        def __init__(self):
            super().__init__("batch", max_parallel=parallel)
            self.n = 0

        def has_next(self):
            return self.n < n

        def yield_more_work(self):
            self.n += 1
            i = self.n
            return s.work.FunctionWork(f"item-{i}", lambda: item(i),
                                       max_retries=3)
    b = ws.schedule(Batch())
    return {"done": ws.run_until_done(600), "state": b.state, "order": done,
            "attempts": attempts, "now": ws.clock.now()}


def _timers(s):
    clock = s.timer.VirtualClock(s.timer.VIRTUAL_TIME)
    events = []
    for delay, name in [(3.0, "c"), (1.0, "a"), (2.0, "b")]:
        t = s.timer.VirtualTimer(clock)
        t.expires_from_now(delay)
        t.async_wait(lambda n=name: events.append((n, clock.now())))
    gone = s.timer.VirtualTimer(clock)
    gone.expires_from_now(1.5)
    gone.async_wait(lambda: events.append(("fired", clock.now())),
                    on_cancel=lambda: events.append(("cancelled",
                                                     clock.now())))
    gone.cancel()
    clock.post_action(lambda: events.append(("posted", clock.now())))
    cranks = []
    while True:
        n = clock.crank(block=True)
        if not n:
            break
        cranks.append(n)
    ticks = {"n": 0}

    def tick():
        ticks["n"] += 1
        if ticks["n"] < 5:
            t = s.timer.VirtualTimer(clock)
            t.expires_from_now(1.0)
            t.async_wait(tick)
    tick()
    reached = clock.crank_until(lambda: ticks["n"] >= 5, timeout=100.0)
    idle = clock.crank_until(lambda: False, timeout=10.0)
    return {"events": events, "cranks": cranks, "reached": reached,
            "idle": idle, "now": clock.now()}


def _scheduler(s):
    sched = s.sched.Scheduler()
    order = []
    for i in range(3):
        sched.enqueue("q1", lambda i=i: order.append(("q1", i)))
    sched.enqueue("q2", lambda: order.append(("q2", 0)))
    ran = sched.run_some()
    clock = s.timer.VirtualClock(s.timer.VIRTUAL_TIME)
    shed = []
    clock.post_action(lambda: shed.append("d"), name="flood",
                      action_type=s.sched.ActionType.DROPPABLE)
    clock.set_current_virtual_time(100.0)
    clock.crank()
    return {"order": order, "ran": ran, "shed": shed,
            "dropped": clock.scheduler.actions_dropped}


WORK_CASES = {
    "function work": _function_work,
    "sequence stops at a failure": _sequence_failure,
    "retry then success": _retry_then_success,
    "batch bounded parallelism": lambda s: _batch(s, 3, 10, False),
    "batch parks on retries": lambda s: _batch(s, 2, 5, True),
    "timers": _timers,
    "scheduler": _scheduler,
}


@pytest.mark.parametrize("case", list(WORK_CASES))
def test_work_case_equals_reference(case):
    port, ref = WORK_CASES[case](PORT), WORK_CASES[case](REF)
    assert port == ref
    if "state" in port:
        assert port["state"] == ("FAILURE" if "failure" in case
                                 else "SUCCESS")


def test_checkpoint_math_equals_reference():
    out = {}
    for name, s in (("port", PORT), ("ref", REF)):
        hm = s.hm
        out[name] = [(n, hm.checkpoint_containing(n),
                      hm.is_last_in_checkpoint(n),
                      hm.first_in_checkpoint(hm.checkpoint_containing(n)),
                      hm._layered_path("ledger", hm.checkpoint_containing(n),
                                       "xdr.gz"))
                     for n in (1, 2, 62, 63, 64, 127, 128, 10**6)]
    assert out["port"] == out["ref"]
    assert out["port"][3][1:4] == (63, True, 1)
    assert out["port"][4][1:4] == (127, False, 64)


# ---------------- the chain ----------------

@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The same chain built by both packages, each over its oracle, each
    publishing into an archive of its own."""
    plan = vectors.catchup_plan(np.random.default_rng(PLAN_SEED),
                                senders=SENDERS)
    out = {"plan": plan}
    saved = (REF.keys._backend, PORT.keys._backend)
    REF.keys.set_verifier_backend(REF.ref.verify)
    PORT.keys.set_verifier_backend(PORT.ref.verify)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pbh, "hash_many", _cpu_hash_many)
            for name, side in (("port", PORT), ("ref", REF)):
                envs = side.envelopes(plan, range(64, 129))
                path = str(tmp_path_factory.mktemp(f"archive-{name}"))
                lm, hm = side.build(plan, envs, path)
                out[name] = {"envs": envs, "lm": lm, "hm": hm, "dir": path}
    finally:
        REF.keys.set_verifier_backend(saved[0])
        PORT.keys.set_verifier_backend(saved[1])
        for side in (PORT, REF):
            side.keys.flush_verify_cache()
    return out


def _archive_records(root):
    """Every file of an archive, by its path: the records of a gzipped
    XDR stream, or the bytes of a bucket, after gunzip; the JSON of a
    HAS."""
    out = {}
    for base, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            rel = os.path.relpath(path, root)
            raw = open(path, "rb").read()
            if rel.endswith(".json"):
                out[rel] = json.loads(raw)
            elif rel.startswith("bucket/"):
                out[rel] = gzip.decompress(raw)
            else:
                out[rel] = PORT.hm._unrecords(gzip.decompress(raw))
    return out


def test_chain_and_archive_equal_reference(chains):
    """Equal envelopes, chains and archives: the same files, each equal
    after gunzip, the HAS JSON equal; the hot archive holds the two
    evicted entries."""
    port, ref = chains["port"], chains["ref"]
    assert port["envs"] == ref["envs"]
    assert PORT.state(port["lm"]) == REF.state(ref["lm"])
    assert port["hm"].published_checkpoints == \
        ref["hm"].published_checkpoints == [63, 127]
    ap, ar = _archive_records(port["dir"]), _archive_records(ref["dir"])
    assert ap == ar
    assert sum(k.startswith("bucket/") for k in ap) > 2
    has = ap[".well-known/stellar-history.json"]
    assert has["currentLedger"] == 127 and has["hotArchiveBuckets"]
    lm = port["lm"]
    assert lm.last_closed_header.ledgerVersion == 23
    assert lm.last_closed_header.maxTxSetSize == 1000
    assert not lm.hot_archive.is_empty()
    headers, txs, results = PORT.hm.HistoryManager.get_checkpoint(
        PORT.hm.FileArchive(port["dir"]), 127)
    assert len(headers) == len(txs) == len(results) == 64
    assert all(len(r.txResultSet.results) == SENDERS for r in results)


MODES = ("COMPLETE", "MINIMAL", "RECENT")


def _catchup(side, archive_dir, mode, plan, to_ledger=127):
    lm = side.fresh(plan if mode == "COMPLETE" else None)
    work = side.catchup(lm, side.hm.FileArchive(archive_dir), to_ledger,
                        mode, count=63 if mode == "RECENT" else 0)
    out = side.state(lm)
    out["work"] = work.state
    out["store"] = dict(lm.root.store.entries)
    out["verified"] = [h.hash for h in work.verified_headers]
    return out


@pytest.mark.parametrize("archive", ["own", "cross"])
@pytest.mark.parametrize("mode", MODES)
def test_catchup_equals_reference(chains, mode, archive):
    """A fresh node of each package catches up to 127 in ``mode``: from
    its own package's archive, or (``cross``) from the other's. Both
    reach the publisher's LCL with equal stores, bucket lists and hot
    archives."""
    plan = chains["plan"]
    dirs = {"port": chains["port"]["dir"], "ref": chains["ref"]["dir"]}
    if archive == "cross":
        dirs = {"port": dirs["ref"], "ref": dirs["port"]}
    port = _catchup(PORT, dirs["port"], mode, plan)
    ref = _catchup(REF, dirs["ref"], mode, plan)
    assert port == ref
    publisher = chains["port"]["lm"]
    assert port["work"] == "SUCCESS"
    assert {k: port[k] for k in ("seq", "lcl", "bucket_list",
                                 "hot_archive")} == \
        {k: v for k, v in PORT.state(publisher).items() if k != "header"}
    assert port["store"] == dict(publisher.root.store.entries)
    assert len(port["verified"]) == 125


def test_replay_divergence_raises_in_both(chains):
    """A node whose genesis differs by one balance: ``replay_checkpoint``
    raises ``ValueError`` with the same message in both packages, and
    ``verify_ledger_chain`` refuses a changed header in both."""
    plan = chains["plan"]
    out = {}
    for name, side in (("port", PORT), ("ref", REF)):
        root = side.root(plan)
        kb = sorted(k for k in root.store.entries
                    if k[:4] == b"\x00\x00\x00\x00")[0]
        entry = root.store.get(kb)
        entry.data.value.balance -= 1
        root.store.put(kb, entry)
        archive = side.hm.FileArchive(chains["port"]["dir"])
        with pytest.raises(ValueError) as err:
            side.cu.replay_checkpoint(
                side.lm.LedgerManager(NID, root), archive, 63)
        headers, _t, _r = side.hm.HistoryManager.get_checkpoint(archive, 63)
        good = side.cu.verify_ledger_chain(headers)
        headers[5].header.feePool += 1
        out[name] = (str(err.value), good,
                     side.cu.verify_ledger_chain(headers))
    assert out["port"] == out["ref"]
    assert out["port"][0].startswith("replay diverged at ledger 3")
    assert out["port"][1:] == (True, False)


def _statused(side, trusted, to_ledger, plan, archive_dir):
    sm = side.status.StatusManager()
    lines = []
    real = sm.set_status

    def recording(category, message):
        lines.append((category, message))
        real(category, message)
    sm.set_status = recording
    lm = side.fresh(plan)
    work = side.catchup(lm, side.hm.FileArchive(archive_dir), to_ledger,
                        "COMPLETE", status_manager=sm,
                        trusted_hashes=trusted)
    return {"state": work.state, "seq": lm.ledger_seq, "lines": lines,
            "now": sm.status_lines(), "retries": work.retries,
            "refused": getattr(work, "_refused", None)}


def test_trusted_anchors_equal_reference(chains):
    """Trust anchors: the real ones pass, a forged one and anchors above
    the archive's tip refuse; every status line on the way is equal."""
    plan, path = chains["plan"], chains["port"]["dir"]
    headers, _t, _r = PORT.hm.HistoryManager.get_checkpoint(
        PORT.hm.FileArchive(path), 63)
    pin = next(h for h in headers if h.header.ledgerSeq == 63).hash.hex()
    cases = [({63: pin}, 63), ({63: "00" * 32}, 63), ({191: "11" * 32}, 63),
             ({63: pin}, 100)]
    port = [_statused(PORT, t, n, plan, path) for t, n in cases]
    ref = [_statused(REF, t, n, plan, path) for t, n in cases]
    assert port == ref
    assert [r["state"] for r in port] == ["SUCCESS", "FAILURE", "FAILURE",
                                          "SUCCESS"]
    assert [r["seq"] for r in port] == [63, 2, 2, 63]
    assert "anchors do not cover" in port[2]["refused"]
    assert port[2]["retries"] == 0
    assert port[1]["now"] == ["Catchup REFUSED: checkpoint 63 does not "
                              "match the trusted hash"]


def test_coalesced_prefetch_calls_equal_reference(chains, monkeypatch):
    """A ``RECENT`` catchup's signature work: the same
    ``batch_verify_into_cache`` calls in both packages, the first of
    them the whole checkpoint's triples at once; the closes verify
    nothing more."""
    calls = {}
    for name, side in (("port", PORT), ("ref", REF)):
        calls[name] = []
        verified = []
        real = side.keys.batch_verify_into_cache

        def recording(items, real=real, log=calls[name]):
            items = list(items)
            log.append(len(items))
            return real(items)

        def counting(pk, msg, sig, side=side, verified=verified):
            verified.append(pk)
            return side.ref.verify(pk, msg, sig)
        monkeypatch.setattr(side.keys, "batch_verify_into_cache", recording)
        side.keys.set_verifier_backend(counting)
        side.catchup(side.fresh(), side.hm.FileArchive(
            chains[name]["dir"]), 127, "RECENT", count=63)
        calls[name].append(len(verified))
    assert calls["port"] == calls["ref"]
    assert calls["port"][0] == 64 * SENDERS
    assert calls["port"][-1] == 64 * SENDERS    # each triple verified once


def test_skip_known_results_verifies_nothing(chains):
    """``SKIP_KNOWN_RESULTS``: every archived transaction succeeded, so
    neither package verifies a signature, and both reach the LCL."""
    out = {}
    for name, side in (("port", PORT), ("ref", REF)):
        verified = []
        side.cu.SKIP_KNOWN_RESULTS = True
        side.keys.set_verifier_backend(
            lambda pk, m, s, side=side, v=verified:
            v.append(pk) or side.ref.verify(pk, m, s))
        lm = side.fresh()
        side.catchup(lm, side.hm.FileArchive(chains[name]["dir"]), 127,
                     "RECENT", count=63)
        out[name] = (lm.last_closed_hash, len(verified))
    assert out["port"] == out["ref"]
    assert out["port"] == (chains["port"]["lm"].last_closed_hash, 0)


def test_catchup_over_cpu_batch_verifier(chains):
    """The port's ``COMPLETE`` catchup to ledger 71 prefetches ledgers 64
    to 71's 32 triples through a CPU ``BatchVerifier`` (the plain K1) in
    one call; every close re-seeds from them without a miss, and the LCL
    is the reference's catchup's."""
    plan = chains["plan"]
    signer_tables.signer_table_cache.configure(enabled=False)
    verifier = BatchVerifier(device="cpu", bucket_sizes=(32,))
    verifier.install()
    try:
        lm = PORT.fresh(plan)
        misses0 = PORT.keys.get_verify_cache_stats()["misses"]
        work = PORT.catchup(lm, PORT.hm.FileArchive(chains["ref"]["dir"]),
                            71, "COMPLETE")
        misses = PORT.keys.get_verify_cache_stats()["misses"] - misses0
    finally:
        signer_tables.signer_table_cache.configure(
            enabled=signer_tables.ENABLED)
    ref = REF.fresh(plan)
    REF.catchup(ref, REF.hm.FileArchive(chains["port"]["dir"]), 71,
                "COMPLETE")
    assert work.state == "SUCCESS" and lm.ledger_seq == 71
    assert lm.last_closed_hash == ref.last_closed_hash
    assert verifier.served["device"] == 8 * SENDERS
    assert misses == 8 * SENDERS


def test_ledger_apply_manager_equals_reference(chains):
    """``LedgerApplyManager``: applied in order, a gap buffered, a second
    gap asks for catchup, a drain applies what became contiguous."""
    plan = chains["plan"]
    out = {}
    for name, side in (("port", PORT), ("ref", REF)):
        lm = side.fresh(plan)
        lam = side.cu.LedgerApplyManager(lm)

        def lcd(seq, at=lm):
            txset, _ex = side.ts.make_tx_set_from_transactions(
                [], at.last_closed_header, at.last_closed_hash)
            return side.lm.LedgerCloseData(seq, txset,
                                           vectors.catchup_close_time(seq))
        got = [lam.process_ledger(lcd(lm.ledger_seq + 1)) for _ in range(3)]
        got.append(lam.process_ledger(lcd(lm.ledger_seq + 2)))
        got.append(lam.process_ledger(lcd(lm.ledger_seq + 3)))
        got.append(lam.process_ledger(lcd(lm.ledger_seq)))
        got.append(sorted(lam.buffered))
        got.append(lm.last_closed_hash)
        out[name] = got
    assert out["port"] == out["ref"]
    assert out["port"][:6] == ["applied"] * 3 + ["buffered",
                                                 "catchup-needed", "applied"]


@pytest.mark.slow
def test_catchup_pin_is_the_reference_chain(tmp_path):
    """``chip_smoke.py`` phase 23's chain, built by the reference at full
    width from ``CATCHUP_SEED`` (256 senders, ledgers 64 to 127 each of
    256 payments, signed through OpenSSL, closed over the reference's
    oracle): ledger 127's header hash is ``CATCHUP_LCL_HASH``, and the
    set the restored node closes as ledger 128 gives
    ``CATCHUP_NEXT_HASH``. About a minute; not tier 1."""
    c = chip_smoke_constants()
    plan = vectors.catchup_plan(np.random.default_rng(c["CATCHUP_SEED"]),
                                senders=c["CATCHUP_SENDERS"])
    envs = REF.envelopes(plan, range(64, 129))
    lm, hm = REF.build(plan, envs, str(tmp_path))
    assert hm.published_checkpoints == [63, 127]
    assert lm.last_closed_hash.hex() == c["CATCHUP_LCL_HASH"]
    res, _set = REF.close(lm, envs[128])
    assert res.header_hash.hex() == c["CATCHUP_NEXT_HASH"]
