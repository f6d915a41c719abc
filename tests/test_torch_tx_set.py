"""The port's TxSet (``stellar_tpu_torch.herder``) against the reference's
(``stellar_tpu.herder``), and a miniature of ``chip_smoke.py`` phase 21
(the node's TxSet) on the CPU.

The miniature takes phase 20's 40-transaction traffic
(``vectors.node_txset`` with ``test_torch_signature_checker.py``'s small
arguments) over ``vectors.node_ledger``: admission (one
``prefetch_signature_batch``, then every frame's ``check_valid``),
nomination (``make_tx_set_from_transactions``), the wire bytes,
``TxSetXDRFrame.from_bytes``, ``prepare_for_apply``,
``ApplicableTxSetFrame.check_valid`` and ``get_txs_in_apply_order``. The
port verifies through a CPU ``BatchVerifier`` at bucket 16 (the plain K1)
in one case and the pure-Python oracle in the rest, the reference through
its oracle; the set's bytes and hash, the frames, the verdicts, the
collected triples and the apply order must be equal, at protocol 19 and
23. Then the reference's own TxSet cases (``tests/test_close_ledger.py``:
wire round trip, wrong LCL, sequence gap, surge pricing, apply order) run
over both packages on ``seed_root_with_accounts`` roots.
"""

import numpy as np
import pytest

import stellar_tpu.tx.ops  # noqa: F401 (fills the registry)
import stellar_tpu_torch.tx.ops  # noqa: F401
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.herder import tx_set as jts
from stellar_tpu.ledger import ledger_txn as jlt
from stellar_tpu.tx import transaction_frame as jtf
from stellar_tpu.tx import tx_test_utils as jtu
from stellar_tpu.xdr import ledger as jledger
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu_torch.crypto import ed25519_ref as pref
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_hasher import hash_many
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.herder import tx_set as pts
from stellar_tpu_torch.ledger import ledger_txn as plt
from stellar_tpu_torch.parallel import signer_tables
from stellar_tpu_torch.tx import transaction_frame as ptf
from stellar_tpu_torch.tx import tx_test_utils as ptu
from stellar_tpu_torch.xdr import ledger as pledger
from stellar_tpu_torch.xdr import results as presults
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx

from tests._torch_port import check_copy, ref_root

MODULES = ["herder/__init__.py", "herder/surge_pricing.py",
           "herder/tx_set.py"]

NID = vectors.NODE_NETWORK_ID
LCL = sha256(b"the last closed ledger")
# test_torch_signature_checker.py's miniature of phase 20
SMALL = dict(single=5, multisig=22, two_op=8, special=5, corrupt=0.06,
             short_multisig=2)
OK = presults.TransactionResultCode.txSUCCESS


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


@pytest.fixture(autouse=True)
def oracles():
    """Both packages verify with their pure-Python oracles unless a case
    installs the port's CPU verifier; caches flushed around each case."""
    saved = (jkeys._backend, pkeys._backend)
    jkeys.set_verifier_backend(jref.verify)
    pkeys.set_verifier_backend(pref.verify)
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()


@pytest.fixture(scope="module")
def traffic():
    return vectors.node_txset(np.random.default_rng(1222), **SMALL)


class _Side:
    """One package's half of the miniature."""

    def __init__(self, ts, tf, lt, rt, ledger_mod, tx_mod):
        self.ts, self.tf, self.lt, self.rt = ts, tf, lt, rt
        self.ledger, self.tx = ledger_mod, tx_mod

    def frames(self, envs):
        return [self.tf.make_transaction_frame(
            NID, self.rt.from_bytes(self.tx.TransactionEnvelope, e))
            for e in envs]

    def admit(self, root, frames):
        """One prefetch, then every frame's ``check_valid``: (the
        collected triples, each result's code and operation codes)."""
        ltx = self.lt.LedgerTxn(root)
        items = self.ts.prefetch_signature_batch(ltx, frames)
        out = []
        for f in frames:
            res = f.check_valid(ltx)
            out.append((res.code, [(r.arm, r.value.arm, r.value.value.arm)
                                   if r.arm == 0 else (r.arm,)
                                   for r in res.op_results]))
        ltx.rollback()
        return items, out

    def nominate(self, frames, header):
        app, excluded = self.ts.make_tx_set_from_transactions(
            frames, header, LCL)
        return app, excluded, self.rt.to_bytes(
            self.ledger.GeneralizedTransactionSet, app.xdr)

    def received(self, raw, root):
        """The wire path: decode, prepare, validate, apply order."""
        applicable = self.ts.TxSetXDRFrame.from_bytes(raw) \
            .prepare_for_apply(NID)
        ltx = self.lt.LedgerTxn(root)
        ok = applicable.check_valid(ltx, LCL)
        ltx.rollback()
        order = [self.ts.full_tx_hash(f)
                 for f in applicable.get_txs_in_apply_order()]
        return applicable, ok, order


PORT = _Side(pts, ptf, plt, prt, pledger, ptx)
REF = _Side(jts, jtf, jlt, jrt, jledger, jtx)


def _keyed(items) -> int:
    """The (pk, msg, sig) triples the verify cache keys."""
    return sum(pkeys.cache_keyable(pk, sig) for pk, _m, sig in items)


def _preload_hashes(frames):
    """The contents hashes through ``hash_many`` on the CPU (the plain
    K3 from ``MIN_DEVICE_HASH_BATCH`` frames on), where the port's
    ``prefetch_contents_hashes`` would need a card."""
    for f, digest in zip(frames, hash_many(
            [f.contents_preimage() for f in frames], device="cpu")):
        f._hash = digest


def test_node_txset_miniature_equals_reference(traffic):
    """Phase 21 at 40 transactions. Admission verifies through the
    oracle; the received set's ``check_valid`` prefetches through a CPU
    ``BatchVerifier`` (the plain K1), after which every per-transaction
    ed25519 check is a verify-cache hit."""
    envs, accounts = traffic
    root = vectors.node_ledger(accounts)
    jroot = ref_root(root)
    frames = PORT.frames(envs)
    _preload_hashes(frames)
    items, admitted = PORT.admit(root, frames)
    accepted = [f for f, (code, _o) in zip(frames, admitted) if code == OK]
    app, excluded, raw = PORT.nominate(accepted, root.header())
    assert excluded == []
    # phase 20's stand-ins on the same transactions
    dec = [prt.from_bytes(ptx.TransactionEnvelope, e) for e in envs]
    hashes = [f.contents_hash() for f in frames]
    assert [ok for ok, _u in (vectors.check_transaction(d, accounts, h)
                              for d, h in zip(dec, hashes))] == \
        [code == OK for code, _o in admitted]
    keep = [code == OK for code, _o in admitted]
    ltx = plt.LedgerTxn(root)
    assert pts.collect_signature_triples(ltx, accepted) == \
        vectors.collect_candidates(
            [d for d, k in zip(dec, keep) if k], accounts,
            [h for h, k in zip(hashes, keep) if k])
    ltx.rollback()
    assert items == vectors.collect_candidates(dec, accounts, hashes)
    signer_tables.signer_table_cache.configure(enabled=False)
    try:
        verifier = BatchVerifier(device="cpu", bucket_sizes=(16,))
        verifier.install()
        applicable = pts.TxSetXDRFrame.from_bytes(raw).prepare_for_apply(
            NID)
        _preload_hashes(applicable.frames)
        pkeys.flush_verify_cache()
        ltx = plt.LedgerTxn(root)
        assert applicable.check_valid(ltx, LCL)
        ltx.rollback()
        stats = pkeys.get_verify_cache_stats()
        assert stats["misses"] == _keyed(applicable.sig_triples)
        assert 0 < verifier.served["device"] <= stats["misses"]
        order = [pts.full_tx_hash(f)
                 for f in applicable.get_txs_in_apply_order()]
    finally:
        signer_tables.signer_table_cache.configure(
            enabled=signer_tables.ENABLED)
    # the reference on the same bytes
    jframes = REF.frames(envs)
    jitems, jadmitted = REF.admit(jroot, jframes)
    assert admitted == jadmitted and items == jitems
    jaccepted = [f for f, (code, _o) in zip(jframes, jadmitted)
                 if code == OK]
    _j, jexcluded, jraw = REF.nominate(jaccepted, jroot.header())
    assert jexcluded == [] and jraw == raw
    japplicable, jok, jorder = REF.received(jraw, jroot)
    assert jok is True
    assert japplicable.hash == applicable.hash == app.hash
    assert japplicable.sig_triples == applicable.sig_triples
    assert jorder == order
    assert 0 < len(accepted) < len(frames)


def _rejected_plus(frames, admitted):
    """The accepted frames and the first rejected one."""
    bad = next(f for f, (code, _o) in zip(frames, admitted) if code != OK)
    return [f for f, (code, _o) in zip(frames, admitted)
            if code == OK] + [bad]


@pytest.mark.parametrize("version", [19, 23])
def test_txset_equals_reference(traffic, version):
    """At protocol 19 (one classic phase) and 23 (the Soroban phase
    present, parallel and empty): the set's bytes and hash, the prepared
    frames and their base fees, validity, the triples and the apply
    order; and a set holding one rejected transaction fails in both."""
    envs, accounts = traffic
    root = vectors.node_ledger(accounts, ledger_version=version)
    jroot = ref_root(root)
    out = {}
    for name, side, r in (("port", PORT, root), ("ref", REF, jroot)):
        frames = side.frames(envs)
        _i, admitted = side.admit(r, frames)
        accepted = [f for f, (code, _o) in zip(frames, admitted)
                    if code == OK]
        _app, excluded, raw = side.nominate(accepted, r.header())
        applicable, ok, order = side.received(raw, r)
        _b, _e, bad_raw = side.nominate(_rejected_plus(frames, admitted),
                                        r.header())
        _a, bad_ok, _o = side.received(bad_raw, r)
        out[name] = {
            "admitted": admitted, "excluded": len(excluded), "raw": raw,
            "hash": applicable.hash, "ok": ok, "bad_raw": bad_raw,
            "bad_ok": bad_ok, "order": order,
            "triples": applicable.sig_triples,
            "frames": [(f.envelope_bytes(), applicable.base_fee_for(f))
                       for f in applicable.frames],
            "phases": [p.arm for p in applicable.xdr.value.phases],
            "soroban": applicable.soroban_tx_count()}
    assert out["port"] == out["ref"]
    port = out["port"]
    assert port["ok"] is True and port["bad_ok"] is False
    assert port["excluded"] == 0
    assert port["phases"] == ([0] if version == 19 else [0, 1])
    assert port["soroban"] == 0


# ---------------- the reference's own TxSet cases ----------------

XLM = 10_000_000


class _Pkg:
    def __init__(self, ts, lt, tu, ledger_mod, rt):
        self.ts, self.lt, self.tu, self.ledger, self.rt = \
            ts, lt, tu, ledger_mod, rt

    def env(self, n_accounts=4):
        keys = [self.tu.keypair(f"acct{i}") for i in range(n_accounts)]
        root = self.tu.seed_root_with_accounts(
            [(k, 1000 * XLM) for k in keys])
        return root, keys

    def tx(self, src, seq, dest, fee=None):
        return self.tu.make_tx(src, seq, [self.tu.payment_op(dest, XLM)],
                               fee=fee)

    def valid(self, txset, root, lcl=LCL):
        with self.lt.LedgerTxn(root) as ltx:
            ok = txset.check_valid(ltx, lcl)
            ltx.rollback()
        return ok

    def raw(self, txset):
        return self.rt.to_bytes(self.ledger.GeneralizedTransactionSet,
                                txset.xdr)


PKGS = {"port": _Pkg(pts, plt, ptu, pledger, prt),
        "ref": _Pkg(jts, jlt, jtu, jledger, jrt)}
START = 1 << 32     # seed_root_with_accounts' sequence numbers


def _wire_round_trip(p):
    root, (a, b, *_) = p.env()
    txs = [p.tx(a, START + 1 + i, b) for i in range(3)]
    txset, _ = p.ts.make_tx_set_from_transactions(txs, root.header(), LCL)
    wire = p.ts.TxSetXDRFrame.from_bytes(p.raw(txset))
    applicable = wire.prepare_for_apply(p.tu.TEST_NETWORK_ID)
    return {"raw": p.raw(txset), "hash": wire.hash,
            "same hash": wire.hash == txset.hash,
            "prepared": applicable is not None,
            "valid": p.valid(applicable, root)}


def _wrong_lcl(p):
    root, (a, b, *_) = p.env()
    txset, _ = p.ts.make_tx_set_from_transactions(
        [p.tx(a, START + 1, b)], root.header(), b"\x11" * 32)
    return {"raw": p.raw(txset), "valid": p.valid(txset, root)}


def _sequence_gap(p):
    root, (a, b, *_) = p.env()
    txs = [p.tx(a, START + 1, b), p.tx(a, START + 3, b)]
    txset, _ = p.ts.make_tx_set_from_transactions(txs, root.header(), LCL)
    return {"raw": p.raw(txset), "valid": p.valid(txset, root)}


def _surge_pricing(p):
    root, keys = p.env()
    header = root.header()
    header.maxTxSetSize = 2
    txs = [p.tx(k, START + 1, keys[0], fee=fee)
           for k, fee in zip(keys, [500, 300, 200, 100])]
    txset, excluded = p.ts.make_tx_set_from_transactions(txs, header, LCL)
    return {"raw": p.raw(txset), "size_op": txset.size_op(),
            "base fees": sorted(txset.base_fee_for(f)
                                for f in txset.frames),
            "excluded fees": sorted(f.full_fee() for f in excluded)}


def _apply_order(p):
    root, keys = p.env(3)
    a = keys[0]
    txs = [p.tx(a, START + 1 + i, keys[1]) for i in range(3)]
    txs += [p.tx(keys[2], START + 1, a)]
    txset, _ = p.ts.make_tx_set_from_transactions(txs, root.header(), LCL)
    order = [p.ts.full_tx_hash(f) for f in txset.get_txs_in_apply_order()]
    again = [p.ts.full_tx_hash(f) for f in txset.get_txs_in_apply_order()]
    positions = [order.index(p.ts.full_tx_hash(f)) for f in txs[:3]]
    return {"raw": p.raw(txset), "order": order,
            "deterministic": order == again,
            "seq safe": positions == sorted(positions)}


CASES = {
    "wire round trip": (_wire_round_trip, {"same hash": True,
                                           "prepared": True,
                                           "valid": True}),
    "wrong lcl": (_wrong_lcl, {"valid": False}),
    "sequence gap": (_sequence_gap, {"valid": False}),
    "surge pricing": (_surge_pricing, {"size_op": 2,
                                       "base fees": [300, 300],
                                       "excluded fees": [100, 200]}),
    "apply order": (_apply_order, {"deterministic": True,
                                   "seq safe": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_txset_case_equals_reference(case):
    fn, want = CASES[case]
    port, ref = fn(PKGS["port"]), fn(PKGS["ref"])
    assert port == ref
    assert {k: port[k] for k in want} == want
