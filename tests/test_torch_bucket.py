"""The port's bucket layer (``stellar_tpu_torch.bucket``,
``utils/workers.py``, ``utils/native.py``) against the reference's.

The copies are held to the reference's source
(``_torch_port.check_copy``); ``utils/native.py`` is the port's own
bridge, so a differential test holds it to the reference's and to its
own pure-Python fallback. Entries are built in the port and carried to
the reference through their bytes. Fresh buckets, merges (INIT, LIVE and
DEAD fusion, tombstones dropped at the bottom) and 70 ledgers of a live
bucket list (levels 0-3 spilled) must give equal bytes and hashes every
ledger, with background merges on and off; the eviction scan and the hot
archive, on contract data written straight into the store, must evict,
archive and hash alike at protocol 22 and 23.
"""

import numpy as np
import pytest

from stellar_tpu.bucket import bucket as jbucket
from stellar_tpu.bucket import bucket_list as jbl
from stellar_tpu.bucket import eviction as jev
from stellar_tpu.bucket import hot_archive as jhot
from stellar_tpu.herder import tx_set as jts
from stellar_tpu.ledger import ledger_manager as jlm
from stellar_tpu.ledger import ledger_txn as jlt
from stellar_tpu.utils import native as jnative
from stellar_tpu.utils import workers as jworkers
from stellar_tpu.xdr import ledger as jledger
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch.bucket import bucket as pbucket
from stellar_tpu_torch.bucket import bucket_list as pbl
from stellar_tpu_torch.bucket import eviction as pev
from stellar_tpu_torch.bucket import hot_archive as phot
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.herder import tx_set as pts
from stellar_tpu_torch.ledger import ledger_manager as plm
from stellar_tpu_torch.ledger import ledger_txn as plt
from stellar_tpu_torch.soroban.host import (
    contract_data_key, scaddress_contract, ttl_key_for,
)
from stellar_tpu_torch.tx import tx_test_utils as ptu
from stellar_tpu_torch.tx.ops.create_account import new_account_entry
from stellar_tpu_torch.utils import native as pnative
from stellar_tpu_torch.utils import workers as pworkers
from stellar_tpu_torch.xdr import contract as pcontract
from stellar_tpu_torch.xdr import ledger as pledger
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import types as ptypes

from tests._torch_port import check_copy, ref_root, to_ref

MODULES = ["utils/workers.py", "bucket/__init__.py", "bucket/bucket.py",
           "bucket/bucket_list.py", "bucket/eviction.py",
           "bucket/hot_archive.py"]

PROTO = 22


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


@pytest.fixture
def background():
    """Both packages' worker pools back to background mode after a
    case that turns them off."""
    yield
    pworkers.set_background(True)
    jworkers.set_background(True)


# ---------------- utils/native.py ----------------

def _frames(rng, n, max_len=300):
    return [rng.bytes(int(rng.integers(0, max_len))) for _ in range(n)]


def _keys(rng, n_old, n_new, n_equal):
    """Two ascending key lists sharing ``n_equal`` keys."""
    shared = [rng.bytes(int(rng.integers(1, 40))) for _ in range(n_equal)]
    old = sorted(set(shared + [rng.bytes(int(rng.integers(1, 40)))
                               for _ in range(n_old)]))
    new = sorted(set(shared + [rng.bytes(int(rng.integers(1, 40)))
                               for _ in range(n_new)]))
    return old, new


NATIVE_CASES = {
    "empty": (lambda rng: ([], ([], []))),
    "one empty frame": (lambda rng: ([b""], ([b"k"], []))),
    "equal keys only": (lambda rng: (_frames(rng, 3),
                                     _keys(rng, 0, 0, 5))),
    "seeded": (lambda rng: (_frames(rng, 60), _keys(rng, 40, 30, 12))),
}


def _native_outputs(mod, frames, keys):
    joined = mod.join_frames(frames)
    return {"sha256": mod.sha256(b"".join(frames)),
            "hash_frames": mod.hash_frames(frames),
            "join_frames": joined,
            "split_frames": mod.split_frames(joined),
            "merge_plan": [tuple(int(x) for x in t)
                           for t in mod.merge_plan(*keys)]}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_equals_reference_and_fallback(case, monkeypatch):
    """The port's C++ path, the reference's and the port's pure-Python
    fallback give equal output on the same frames and keys."""
    frames, keys = NATIVE_CASES[case](np.random.default_rng(71))
    assert pnative.available()
    port = _native_outputs(pnative, frames, keys)
    assert port == _native_outputs(jnative, frames, keys)
    assert port["split_frames"] == frames
    monkeypatch.setattr(pnative, "_load", lambda: None)
    assert not pnative.available()
    assert _native_outputs(pnative, frames, keys) == port


def test_native_builds_apart_from_the_reference():
    """The port's library is its own build under ``build/torch_native``
    (through ``build_library``'s lock), never the reference's."""
    assert pnative.available()
    assert pnative._LIB.endswith("/build/torch_native/libbucketstream.so")
    assert pnative._LIB != jnative._LIB
    assert pnative._SRC == jnative._SRC


# ---------------- buckets ----------------

def _account(i, balance=1000, seq=1):
    aid = ptypes.account_id(sha256(b"bucket-acct-%d" % i))
    return new_account_entry(aid, balance, seq << 32, seq)


def _key(entry):
    return plt.entry_to_key(entry)


def _ref_entries(entries):
    return [to_ref(ptypes.LedgerEntry, jtypes.LedgerEntry, e)
            for e in entries]


def _ref_keys(keys):
    return [to_ref(ptypes.LedgerKey, jtypes.LedgerKey, k) for k in keys]


def _fresh(pkg, init, live, dead, proto=PROTO):
    if pkg is pbucket:
        return pkg.fresh_bucket(proto, init, live, dead)
    return pkg.fresh_bucket(proto, _ref_entries(init), _ref_entries(live),
                            _ref_keys(dead))


MERGES = {
    "init then live keeps init": (([_account(1, 100)], [], []),
                                  ([], [_account(1, 200)], []), True),
    "init then dead annihilates": (([_account(1)], [], []),
                                   ([], [], [_key(_account(1))]), True),
    "dead then init fuses to live": (([], [], [_key(_account(2))]),
                                     ([_account(2, 7)], [], []), True),
    "live then dead keeps the tombstone": (([], [_account(3)], []),
                                           ([], [], [_key(_account(3))]),
                                           True),
    "tombstone dropped at the bottom": (([], [_account(3)], []),
                                        ([], [], [_key(_account(3))]),
                                        False),
    "disjoint": (([_account(4), _account(5)], [], []),
                 ([], [_account(6)], [_key(_account(7))]), True),
}


@pytest.mark.parametrize("case", list(MERGES))
def test_merge_equals_reference(case):
    old, new, keep = MERGES[case]
    out = {}
    for name, pkg in (("port", pbucket), ("ref", jbucket)):
        a, b = _fresh(pkg, *old), _fresh(pkg, *new)
        m = pkg.merge_buckets(a, b, PROTO, keep_tombstones=keep)
        out[name] = (a.serialize(), b.serialize(), m.serialize(), m.hash,
                     m.count_entries())
    assert out["port"] == out["ref"]
    assert out["port"][3] == pbucket.Bucket.deserialize(
        out["port"][2]).hash


def _batches(seed, n_ledgers):
    """Seeded per-ledger (init, live, dead) batches of account entries:
    three created a ledger, two of the live ones updated, one of them
    deleted."""
    rng = np.random.default_rng(seed)
    live, nxt, out = [], 0, []
    for seq in range(1, n_ledgers + 1):
        init = []
        for _ in range(3):
            init.append(_account(nxt, int(rng.integers(1, 10**9)), seq))
            nxt += 1
        upd, dead = [], []
        if len(live) > 3:
            picks = rng.choice(len(live), 3, replace=False).tolist()
            for j in picks[:2]:
                upd.append(_account(live[j], int(rng.integers(1, 10**9)),
                                    seq))
            dead.append(_key(_account(live[picks[2]])))
            live.pop(picks[2])
        live.extend(range(nxt - 3, nxt))
        out.append((seq, init, upd, dead))
    return out


def _drive(bl_mod, batches, convert):
    bl = bl_mod.LiveBucketList()
    seen = []
    for seq, init, upd, dead in batches:
        if convert:
            init, upd, dead = (_ref_entries(init), _ref_entries(upd),
                               _ref_keys(dead))
        bl.add_batch(seq, PROTO, init, upd, dead)
        seen.append(([lev.curr.hash + lev.snap.hash for lev in bl.levels],
                     bl.hash()))
    return bl, seen


@pytest.mark.parametrize("background_merges", [True, False])
def test_bucket_list_equals_reference(background_merges, background):
    """70 ledgers: every level's curr and snap hash and the list hash
    equal after each ledger; at the end every bucket, resolved merges
    included, byte for byte."""
    pworkers.set_background(background_merges)
    jworkers.set_background(background_merges)
    batches = _batches(73, 70)
    pl, port = _drive(pbl, batches, convert=False)
    jl, ref = _drive(jbl, batches, convert=True)
    assert port == ref
    assert [b.serialize() for b in pl.all_buckets()] == \
        [b.serialize() for b in jl.all_buckets()]
    for level in range(4):
        assert not (pl.levels[level].curr.is_empty() and
                    pl.levels[level].snap.is_empty()), level
    assert pl.total_entry_count() == jl.total_entry_count()


# ---------------- eviction and the hot archive ----------------

XLM = 10_000_000
T = ptypes.LedgerEntryType
DUR = pcontract.ContractDataDurability


def _contract_data(tag: int, durability, live_until: int):
    """(entry, key, TTL entry) of one contract-data entry."""
    addr = scaddress_contract(sha256(b"evict-%d" % tag))
    key_val = pcontract.SCVal.make(pcontract.SCValType.SCV_SYMBOL, b"k")
    cd = pcontract.ContractDataEntry(
        ext=ptypes.ExtensionPoint.make(0), contract=addr, key=key_val,
        durability=durability,
        val=pcontract.SCVal.make(pcontract.SCValType.SCV_U32, tag))
    entry = ptypes.LedgerEntry(
        lastModifiedLedgerSeq=2,
        data=ptypes.LedgerEntry._types[1].make(T.CONTRACT_DATA, cd),
        ext=ptypes.LedgerEntry._types[2].make(0))
    lk = contract_data_key(addr, key_val, durability)
    ttl = ptypes.LedgerEntry(
        lastModifiedLedgerSeq=2,
        data=ptypes.LedgerEntry._types[1].make(
            T.TTL, ptypes.TTLEntry(keyHash=ttl_key_for(lk).value.keyHash,
                                   liveUntilLedgerSeq=live_until)),
        ext=ptypes.LedgerEntry._types[2].make(0))
    return entry, lk, ttl


def _soroban_root(version):
    """A port root holding one account and eight contract-data entries,
    written straight into the store: TEMPORARY and PERSISTENT in turn,
    every other one with its TTL expired at ledger 2."""
    root = ptu.seed_root_with_accounts([(ptu.keypair("evict-a"),
                                         1000 * XLM)])
    root.header().ledgerVersion = version
    keys = []
    for tag in range(8):
        durability = DUR.TEMPORARY if tag % 2 == 0 else DUR.PERSISTENT
        expired = tag % 4 < 2
        entry, lk, ttl = _contract_data(tag, durability,
                                        2 if expired else 1000)
        for e in (entry, ttl):
            root.store.put(plt.key_bytes(plt.entry_to_key(e)), e)
        keys.append((lk, durability, expired))
    return root, keys


@pytest.mark.parametrize("version", [22, 23])
def test_eviction_scan_equals_reference(version):
    """One scan over a ``LedgerTxn`` in each package: the same evicted
    keys, the same archived entries (only from protocol 23), the same
    ledger changes; the archived entries into each package's hot archive
    give the same ``header_bucket_list_hash``."""
    root, keys = _soroban_root(version)
    jroot = ref_root(root)
    archive = version >= phot.STATE_ARCHIVAL_PROTOCOL_VERSION
    out = {}
    for name, ev, lt, hot, r, t, rt, led in (
            ("port", pev, plt, phot, root, ptypes, prt, pledger),
            ("ref", jev, jlt, jhot, jroot, jtypes, jrt, jledger)):
        ltx = lt.LedgerTxn(r)
        evicted, archived = ev.EvictionScanner().scan(
            ltx, 3, archive_persistent=archive)
        changes = ltx.get_changes()
        ltx.rollback()
        hl = hot.HotArchiveBucketList()
        hl.add_batch(3, archived, [])
        live_hash = sha256(b"a live bucket list hash")
        out[name] = {
            "evicted": [rt.to_bytes(t.LedgerKey, k) for k in evicted],
            "archived": [rt.to_bytes(t.LedgerEntry, e) for e in archived],
            "changes": [rt.to_bytes(led.LedgerEntryChange, c)
                        for c in changes],
            "hot": hl.hash(),
            "header": hot.header_bucket_list_hash(live_hash, hl, version)}
    assert out["port"] == out["ref"]
    expired = [prt.to_bytes(ptypes.LedgerKey, lk) for lk, d, gone in keys
               if gone and (archive or d == DUR.TEMPORARY)]
    assert sorted(out["port"]["evicted"]) == sorted(expired)
    assert len(out["port"]["archived"]) == (2 if archive else 0)


def _close_empty(lm_mod, ts, lm):
    txset, _ = ts.make_tx_set_from_transactions(
        [], lm.last_closed_header, lm.last_closed_hash)
    return lm.close_ledger(lm_mod.LedgerCloseData(
        ledger_seq=lm.ledger_seq + 1, tx_set=txset,
        close_time=2000 + lm.ledger_seq))


@pytest.mark.parametrize("version", [22, 23])
def test_eviction_through_the_close_equals_reference(version):
    """Three empty closes over each package's ``LedgerManager`` on the
    same store: equal header hashes, close-meta bytes (their evicted
    keys among them), hot-archive hashes and stores; expired temporary
    entries leave the state, expired persistent ones move to the hot
    archive from protocol 23 and stay below it."""
    root, keys = _soroban_root(version)
    jroot = ref_root(root)
    out = {}
    for name, lm_mod, ts, r, rt, led in (
            ("port", plm, pts, root, prt, pledger),
            ("ref", jlm, jts, jroot, jrt, jledger)):
        lm = lm_mod.LedgerManager(ptu.TEST_NETWORK_ID, r)
        metas = []
        lm.close_meta_stream.append(
            lambda m, rt=rt, led=led: metas.append(
                rt.to_bytes(led.LedgerCloseMeta, m)))
        hashes = [_close_empty(lm_mod, ts, lm).header_hash
                  for _ in range(3)]
        out[name] = {"hashes": hashes, "metas": metas,
                     "hot": lm.hot_archive.hash(),
                     "bucket_list": lm.bucket_list.hash(),
                     "store": dict(lm.root.store.entries), "lm": lm}
    port, ref = out.pop("port"), out.pop("ref")
    lm = port.pop("lm")
    ref.pop("lm")
    assert port == ref
    archived = version >= phot.STATE_ARCHIVAL_PROTOCOL_VERSION
    for lk, durability, expired in keys:
        kb = plt.key_bytes(lk)
        gone = expired and (durability == DUR.TEMPORARY or archived)
        assert (kb in lm.root.store.entries) is not gone
        in_archive = lm.hot_archive.get_archived(kb) is not None
        assert in_archive is (expired and archived and
                              durability == DUR.PERSISTENT)
