"""The port's persistence (``stellar_tpu_torch.database``,
``bucket.bucket_manager``, ``bucket.bucket_list_db``, ``bucket.bucket_index``,
``crypto.shorthash``) against the reference's.

The copies are held to the reference's source (``_torch_port.check_copy``).
``PersistentState`` round-trips alike, ``BucketManager`` adopts, loads and
collects the same files, and the same closes saved by both packages leave
equal sqlite rows. ``LedgerManager.from_persistence`` resumes each
package's node at its LCL, over a ``BucketListStore`` whose reads equal the
in-memory store's at the reference's ``INDEX_CUTOFF_BYTES`` and at 0 (every
bucket through ``DiskBucket``'s index), and the restored nodes close the
next ledgers to the hashes of nodes never restarted; a fresh database gives
``None``. ``BucketIndex`` gives equal hashes and candidates under a seeded
SipHash key, and a lookup does not depend on the key.

Both packages verify through their pure-Python oracles; no JAX program is
compiled.
"""

import os
import shutil
import sqlite3

import numpy as np
import pytest

from stellar_tpu_torch.crypto import vectors

from tests._torch_chain import PORT, REF
from tests._torch_port import check_copy

MODULES = ["crypto/shorthash.py", "bucket/bucket_index.py",
           "bucket/bucket_list_db.py", "bucket/bucket_manager.py",
           "database/__init__.py", "database/database.py"]

SENDERS = 4
PLAN_SEED = 1616
LAST_SAVED = 40     # ledgers 8-40 carry payments, 41-48 follow a restart
TABLES = ("storestate", "ledgerheaders", "txhistory", "txsets", "scphistory")


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


@pytest.fixture(autouse=True)
def module_state():
    """Both packages verify with their oracles; the bucket index's
    cutoff and sidecar switch and the SipHash key are put back after each
    case, and the verify caches flushed."""
    saved = [(s, s.keys._backend, s.bi.INDEX_CUTOFF_BYTES,
              s.bi.PERSIST_INDEX, s.sh._key, s.sh._initialized)
             for s in (PORT, REF)]
    for s in (PORT, REF):
        s.keys.set_verifier_backend(s.ref.verify)
    yield
    for s, backend, cutoff, persist, key, init in saved:
        s.keys.set_verifier_backend(backend)
        s.keys.flush_verify_cache()
        s.bi.INDEX_CUTOFF_BYTES, s.bi.PERSIST_INDEX = cutoff, persist
        s.sh._key, s.sh._initialized = key, init


def _rows(db_path):
    conn = sqlite3.connect(db_path)
    try:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall()
                for t in TABLES}
    finally:
        conn.close()


def test_persistent_state_round_trip_equals_reference(tmp_path):
    out = {}
    for name, s in (("port", PORT), ("ref", REF)):
        path = str(tmp_path / f"{name}.db")
        db = s.db.Database(path)
        ps = s.db.PersistentState(db)
        got = [ps.get(ps.LAST_CLOSED_LEDGER), db.schema_version()]
        ps.set(ps.LAST_CLOSED_LEDGER, "ab" * 32)
        ps.set("cursor.horizon", "41")
        db.close()
        db2 = s.db.Database(path)
        ps2 = s.db.PersistentState(db2)
        got += [ps2.get(ps2.LAST_CLOSED_LEDGER), ps2.list_cursors(),
                db2.upgrade_schema(), db2.max_header_seq()]
        db2.close()
        out[name] = (got, _rows(path))
    assert out["port"] == out["ref"]
    assert out["port"][0] == [None, 2, "ab" * 32, {"horizon": 41}, [], None]


def _bucket(s):
    from importlib import import_module
    create = import_module(s.package + ".tx.ops.create_account")
    entries = [create.new_account_entry(
        s.xt.account_id(bytes([i]) + b"\x55" * 31), (i + 1) * 10**7, 1)
        for i in range(50)]
    return s.bucket.fresh_bucket(22, entries[:40], [], [
        s.lt.entry_to_key(e) for e in entries[40:]])


def test_bucket_manager_equals_reference(tmp_path):
    """Adopt, a cold load through a fresh manager, then collection of
    every unreferenced file: the same file names at each step, and the
    collected bucket fails to load in both."""
    out = {}
    for name, s in (("port", PORT), ("ref", REF)):
        path = str(tmp_path / name)
        bm = s.bm.BucketManager(path)
        b = _bucket(s)
        h = bm.adopt(b)
        names = [sorted(os.listdir(path))]
        b2 = s.bm.BucketManager(path).load(h)
        bm.forget_unreferenced({h})
        names.append(sorted(os.listdir(path)))
        bm2 = s.bm.BucketManager(path)
        bm2.load(h)
        bm2.forget_unreferenced(set())
        names.append(sorted(os.listdir(path)))
        with pytest.raises(OSError):
            s.bm.BucketManager(path).load(h)
        out[name] = (h, b2.serialize(), names)
    assert out["port"] == out["ref"]
    assert out["port"][2][0] == [f"bucket-{out['port'][0].hex()}.xdr"]
    assert out["port"][2][2] == []


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each package's node closes the plan's ledgers 3 to 40 with every
    close saved; a node of each without persistence closes the same (its
    state and store kept), then ledgers 41 to 48 (their hashes kept).
    Merges run inline: a save records a merge still in flight by its
    inputs, so with background merges the rows would follow the
    threads' timing."""
    plan = vectors.catchup_plan(np.random.default_rng(PLAN_SEED),
                                senders=SENDERS, first_full=8,
                                last=LAST_SAVED, extra=8)
    out = {"plan": plan}
    for name, s in (("port", PORT), ("ref", REF)):
        backend = s.keys._backend
        background = s.workers.background_enabled()
        s.keys.set_verifier_backend(s.ref.verify)
        s.workers.set_background(False)
        try:
            base = tmp_path_factory.mktemp(f"node-{name}")
            envs = s.envelopes(plan, range(8, LAST_SAVED + 9))
            pers = s.persistence(str(base / "node.db"),
                                 str(base / "buckets"))
            lm, _hm = s.build(plan, envs, str(base / "archive"),
                              persistence=pers)
            pers.db.close()
            memory, _hm = s.build(plan, envs, str(base / "archive-memory"))
            state, entries = s.state(memory), dict(memory.root.store.entries)
            following = [s.close(memory, envs[seq])[0].header_hash
                         for seq in range(LAST_SAVED + 1, LAST_SAVED + 9)]
        finally:
            s.workers.set_background(background)
            s.keys.set_verifier_backend(backend)
            s.keys.flush_verify_cache()
        out[name] = {"base": base, "envs": envs, "lm": lm, "state": state,
                     "entries": entries, "following": following}
    return out


def test_saved_rows_equal_reference(saved):
    port = _rows(str(saved["port"]["base"] / "node.db"))
    ref = _rows(str(saved["ref"]["base"] / "node.db"))
    assert port == ref
    assert len(port["ledgerheaders"]) == LAST_SAVED - 2
    assert len(port["txhistory"]) == SENDERS * (LAST_SAVED - 7)
    assert sorted(os.listdir(saved["port"]["base"] / "buckets")) == \
        sorted(os.listdir(saved["ref"]["base"] / "buckets"))


@pytest.mark.parametrize("cutoff", ["default", "0"])
def test_restart_resumes_and_equals_reference(saved, tmp_path, cutoff):
    """Each package restores a copy of its files with
    ``from_persistence`` (at ``cutoff``): the LCL of the node that saved
    them, a ``BucketListStore`` whose every read equals the in-memory
    node's and the other package's, then ledgers 41 to 48 closed to the
    hashes of the nodes never restarted."""
    out = {}
    for name, s in (("port", PORT), ("ref", REF)):
        if cutoff == "0":
            s.bi.INDEX_CUTOFF_BYTES = 0
        path = tmp_path / name
        shutil.copytree(saved[name]["base"], path,
                        ignore=shutil.ignore_patterns("archive*"))
        pers = s.persistence(str(path / "node.db"), str(path / "buckets"))
        node = s.lm.LedgerManager.from_persistence(s.tu.TEST_NETWORK_ID,
                                                   pers)
        assert s.state(node) == s.state(saved[name]["lm"]) == \
            saved[name]["state"]
        assert node.root.store.is_bucket_backed
        entries = saved[name]["entries"]
        absent = [b"\x00\x00\x00\x00" + bytes([7]) * 36]
        reads = {}
        for kb in sorted(entries) + absent:
            got = node.root.store.get(kb)
            reads[kb] = None if got is None else \
                s.rt.to_bytes(s.xt.LedgerEntry, got)
        assert reads == {**entries, absent[0]: None}
        hashes = [s.close(node, saved[name]["envs"][seq])[0].header_hash
                  for seq in range(LAST_SAVED + 1, LAST_SAVED + 9)]
        pers.db.close()
        assert hashes == saved[name]["following"]
        out[name] = (reads, hashes, s.state(node))
    assert out["port"] == out["ref"]


def test_fresh_database_gives_none(tmp_path):
    for name, s in (("port", PORT), ("ref", REF)):
        pers = s.db.NodePersistence(
            s.db.Database(str(tmp_path / f"{name}.db")),
            s.bm.BucketManager(None))
        assert s.lm.LedgerManager.from_persistence(b"\x01" * 32, pers) \
            is None


def test_bucket_index_equals_reference_under_a_seeded_key(tmp_path):
    """A bucket of 40 live and 10 dead entries, indexed by both packages
    under one SipHash key: equal hashes, offsets and lengths, and equal
    candidates for every key and an absent one. Under other keys every
    ``DiskBucket`` lookup (cutoff 0, no sidecar) finds the same entry."""
    raw = _bucket(PORT).serialize()
    assert raw == _bucket(REF).serialize()
    bucket = PORT.bucket.Bucket.deserialize(raw)
    kbs = [kb for kb in map(PORT.bi._entry_key_bytes, bucket.entries)
           if kb is not None]
    kbs.append(b"\x00\x00\x00\x00" + bytes([9]) * 36)
    assert len(kbs) == 51
    out = {}
    for name, s in (("port", PORT), ("ref", REF)):
        s.sh.seed(bytes(range(16)))
        idx = s.bi.BucketIndex.build(raw)
        out[name] = (idx.hashes.tolist(), idx.offsets.tolist(),
                     idx.lengths.tolist(), [idx.candidates(kb) for kb in kbs],
                     [s.sh.compute_hash(kb) for kb in kbs[:4]])
    assert out["port"] == out["ref"]
    assert all(out["port"][3][:-1])
    bm = PORT.bm.BucketManager(str(tmp_path))
    path = bm._path_for(bm.adopt(bucket))
    PORT.bi.INDEX_CUTOFF_BYTES = 0
    PORT.bi.PERSIST_INDEX = False
    got = {}
    for key in (bytes(range(16)), bytes(16), b"\xff" * 16):
        PORT.sh.seed(key)
        disk = PORT.bi.DiskBucket(path, bucket.hash)
        got[key] = [None if e is None else PORT.rt.to_bytes(
            PORT.xl.BucketEntry, e) for e in map(disk.get, kbs)]
    assert len({tuple(v) for v in got.values()}) == 1
    assert got[bytes(16)][-1] is None and all(got[bytes(16)][:-1])
