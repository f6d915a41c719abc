"""The port's ledger close (``stellar_tpu_torch.ledger.ledger_manager``,
the apply half of ``tx/transaction_frame.py``, ``invariant/``,
``herder/upgrades.py``, ``soroban/host.py``) against the reference's.

The copies are held to the reference's source
(``_torch_port.check_copy``). ``tests/test_close_ledger.py``'s closes (one
payment, the upgrades, the verify-cache seeding under a counting backend,
``BASELINE.json`` config 1's 100 payments, the skip list) run over both
packages: the header hash, the ``TransactionResultPair`` bytes, the
applied and failed counts and the store's bytes after the close must be
equal. A miniature of ``chip_smoke.py`` phase 22 (phase 20's 40
transactions over ``vectors.node_close_ledger``, nominated, replayed from
the wire bytes and closed) must give equal header hashes, result pairs
and ``LedgerCloseMeta`` bytes with no transaction failed: over the
port's oracle, over its CPU ``BatchVerifier`` (the plain K1), and with
every invariant on in both packages. ``chip_smoke.py``'s pinned
``CONFIG1_CLOSE_HASH`` is the reference's close of config 1; the
full-width config 2 pins are checked by a ``slow`` test.

Both packages verify through their pure-Python oracles unless a case
installs another backend, so no JAX program is compiled.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

import stellar_tpu.tx.ops  # noqa: F401 (fills the registry)
import stellar_tpu_torch.tx.ops  # noqa: F401
from stellar_tpu import invariant as jinv
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.herder import tx_set as jts
from stellar_tpu.herder import upgrades as jup
from stellar_tpu.invariant import invariants as jinvariants
from stellar_tpu.ledger import ledger_manager as jlm
from stellar_tpu.ledger import ledger_txn as jlt
from stellar_tpu.ledger import network_config as jnc
from stellar_tpu.tx import transaction_frame as jtf
from stellar_tpu.tx import tx_test_utils as jtu
from stellar_tpu.tx.ops import soroban_ops as jsoroban_ops
from stellar_tpu.xdr import ledger as jledger
from stellar_tpu.xdr import results as jresults
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch import invariant as pinv
from stellar_tpu_torch.crypto import ed25519_ref as pref
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_hasher import hash_many
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.herder import tx_set as pts
from stellar_tpu_torch.herder import upgrades as pup
from stellar_tpu_torch.invariant import invariants as pinvariants
from stellar_tpu_torch.ledger import ledger_manager as plm
from stellar_tpu_torch.ledger import ledger_txn as plt
from stellar_tpu_torch.ledger import network_config as pnc
from stellar_tpu_torch.parallel import signer_tables
from stellar_tpu_torch.soroban import host as phost
from stellar_tpu_torch.tx import transaction_frame as ptf
from stellar_tpu_torch.tx import tx_test_utils as ptu
from stellar_tpu_torch.tx.ops.soroban_ops import default_soroban_config
from stellar_tpu_torch.xdr import contract as pcontract
from stellar_tpu_torch.xdr import ledger as pledger
from stellar_tpu_torch.xdr import results as presults
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx
from stellar_tpu_torch.xdr import types as ptypes

from tests._torch_port import (check_copy, chip_smoke_constants,
                                ref_root, to_ref)

MODULES = ["ledger/ledger_manager.py", "soroban/__init__.py",
           "soroban/host.py", "herder/upgrades.py", "invariant/__init__.py",
           "invariant/invariants.py"]

XLM = 10_000_000
# test_torch_signature_checker.py's miniature of phase 20
SMALL = dict(single=5, multisig=22, two_op=8, special=5, corrupt=0.06,
             short_multisig=2)


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


@pytest.fixture(autouse=True)
def oracles():
    """Both packages verify with their pure-Python oracles, no invariant
    manager is active, and the caches are flushed around each case."""
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
    jinv.set_active_manager(None)
    pinv.set_active_manager(None)


class _Pkg:
    """One package's modules for a close."""

    def __init__(self, lm, ts, lt, tu, ledger_mod, results_mod, rt,
                 keys_mod, oracle):
        self.lm, self.ts, self.lt, self.tu = lm, ts, lt, tu
        self.ledger, self.results, self.rt = ledger_mod, results_mod, rt
        self.keys, self.oracle = keys_mod, oracle

    def env(self, n_accounts=4, balance=1000 * XLM, version=None):
        keys = [self.tu.keypair(f"acct{i}") for i in range(n_accounts)]
        root = self.tu.seed_root_with_accounts([(k, balance) for k in keys])
        if version is not None:
            root.header().ledgerVersion = version
        return self.lm.LedgerManager(self.tu.TEST_NETWORK_ID, root), keys

    def close(self, lm, frames, close_time=2000, upgrades=(), header=None):
        txset, excluded = self.ts.make_tx_set_from_transactions(
            frames, header or lm.last_closed_header, lm.last_closed_hash)
        assert excluded == []
        return lm.close_ledger(self.lm.LedgerCloseData(
            ledger_seq=lm.ledger_seq + 1, tx_set=txset,
            close_time=close_time, upgrades=list(upgrades)))

    def outcome(self, lm, res):
        """What the comparisons hold equal after a close."""
        return {"header_hash": res.header_hash,
                "pairs": [self.rt.to_bytes(self.results.TransactionResultPair,
                                           p) for p in res.result_pairs],
                "applied": res.applied_count, "failed": res.failed_count,
                "store": dict(lm.root.store.entries),
                "header": self.rt.to_bytes(self.ledger.LedgerHeader,
                                           res.header)}


PORT = _Pkg(plm, pts, plt, ptu, pledger, presults, prt, pkeys, pref.verify)
REF = _Pkg(jlm, jts, jlt, jtu, jledger, jresults, jrt, jkeys, jref.verify)


def start_seq(lm):
    return (lm.ledger_seq - 1) << 32


# ---------------- tests/test_close_ledger.py's closes ----------------

def _one_payment(p):
    lm, (a, b, *_) = p.env()
    tx = p.tu.make_tx(a, start_seq(lm) + 1, [p.tu.payment_op(b, XLM)])
    res = p.close(lm, [tx])
    out = p.outcome(lm, res)
    out["bucket list hash"] = res.header.bucketListHash == \
        lm.bucket_list.hash()
    out["seq"] = lm.ledger_seq
    return out


def _skip_list(p):
    lm, _keys = p.env()
    hdr = lm.last_closed_header
    hdr.ledgerSeq = 49
    lm._lcl_hash = p.ledger.ledger_header_hash(hdr)
    res = p.close(lm, [], header=hdr)
    out = p.outcome(lm, res)
    out["skip"] = res.header.skipList[0] == res.header.bucketListHash
    out["seq"] = res.header.ledgerSeq
    return out


def _config_1(p):
    """``BASELINE.json`` config 1: 100 payments to one destination,
    validated, then closed."""
    senders = [p.tu.keypair(f"s{i}") for i in range(100)]
    dest = p.tu.keypair("well-known-dest")
    root = p.tu.seed_root_with_accounts(
        [(k, 1000 * XLM) for k in senders] + [(dest, 1000 * XLM)])
    lm = p.lm.LedgerManager(p.tu.TEST_NETWORK_ID, root)
    hdr = lm.last_closed_header
    hdr.maxTxSetSize = 200
    txs = [p.tu.make_tx(k, start_seq(lm) + 1, [p.tu.payment_op(dest, XLM)])
           for k in senders]
    txset, excluded = p.ts.make_tx_set_from_transactions(
        txs, hdr, lm.last_closed_hash)
    assert not excluded
    with p.lt.LedgerTxn(lm.root) as ltx:
        valid = txset.check_valid(ltx, lm.last_closed_hash)
        ltx.rollback()
    res = lm.close_ledger(p.lm.LedgerCloseData(
        ledger_seq=lm.ledger_seq + 1, tx_set=txset, close_time=5000))
    out = p.outcome(lm, res)
    out["valid"] = valid
    out["fee pool"] = res.header.feePool
    return out


def _seeding(p):
    """The close seeds the verify cache with one batch: the counting
    backend sees each signature once, and the fee and apply phases'
    checks are hits."""
    lm, ks = p.env(n_accounts=8)
    frames = [p.tu.make_tx(ks[i], start_seq(lm) + 1,
                           [p.tu.payment_op(ks[(i + 1) % 8], XLM)])
              for i in range(8)]
    calls = []

    def counting(pk, msg, sig):
        calls.append(pk)
        return p.oracle(pk, msg, sig)

    p.keys.flush_verify_cache()
    p.keys.set_verifier_backend(counting)
    before = p.keys.get_verify_cache_stats()
    res = p.close(lm, frames)
    after = p.keys.get_verify_cache_stats()
    out = p.outcome(lm, res)
    out["calls"] = len(calls)
    out["hits"] = after["hits"] - before["hits"]
    out["misses"] = after["misses"] - before["misses"]
    return out


def _upgrade(arm, value, version=None):
    def case(p):
        lm, (a, b, *_) = p.env(version=version)
        tx = p.tu.make_tx(a, start_seq(lm) + 1, [p.tu.payment_op(b, XLM)])
        up = p.rt.to_bytes(p.ledger.LedgerUpgrade,
                           p.ledger.LedgerUpgrade.make(arm, value))
        res = p.close(lm, [tx], upgrades=[up])
        out = p.outcome(lm, res)
        h = lm.last_closed_header
        out["header fields"] = (h.baseFee, h.maxTxSetSize, h.baseReserve,
                                h.ledgerVersion, h.ext.arm)
        return out
    return case


def _config_upgrade(p):
    """A published ``ConfigUpgradeSet`` (a TEMPORARY contract-data entry
    written straight into the store) raising the Soroban lanes' ledger
    transaction count, applied through ``LEDGER_UPGRADE_CONFIG``."""
    lm, (a, b, *_) = p.env(version=23)
    cfg = pnc.SorobanNetworkConfig(ledger_max_tx_count=7)
    lanes = pcontract.ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES
    raw_set = prt.to_bytes(pcontract.ConfigUpgradeSet,
                           pcontract.ConfigUpgradeSet(updatedEntry=[
                               pnc.setting_entry_from_config(cfg, lanes)]))
    contract_id = sha256(b"config upgrade contract")
    entry = ptypes.LedgerEntry(
        lastModifiedLedgerSeq=1,
        data=ptypes.LedgerEntry._types[1].make(
            ptypes.LedgerEntryType.CONTRACT_DATA,
            pcontract.ContractDataEntry(
                ext=ptypes.ExtensionPoint.make(0),
                contract=phost.scaddress_contract(contract_id),
                key=phost.scbytes(sha256(raw_set)),
                durability=pcontract.ContractDataDurability.TEMPORARY,
                val=phost.scbytes(raw_set))),
        ext=ptypes.LedgerEntry._types[2].make(0))
    key = pledger.ConfigUpgradeSetKey(contractID=contract_id,
                                      contentHash=sha256(raw_set))
    kb = pup.config_upgrade_entry_key(key)
    lm.root.store.entries[kb] = prt.to_bytes(ptypes.LedgerEntry, entry)
    up = prt.to_bytes(pledger.LedgerUpgrade, pledger.LedgerUpgrade.make(
        pledger.LedgerUpgradeType.LEDGER_UPGRADE_CONFIG, key))
    tx = p.tu.make_tx(a, start_seq(lm) + 1, [p.tu.payment_op(b, XLM)])
    res = p.close(lm, [tx], upgrades=[up])
    out = p.outcome(lm, res)
    out["lanes"] = lm.soroban_config.ledger_max_tx_count
    return out


LUT = pledger.LedgerUpgradeType
CASES = {
    "one payment": (_one_payment, {"applied": 1, "failed": 0, "seq": 3,
                                   "bucket list hash": True}),
    "skip list": (_skip_list, {"skip": True, "seq": 50}),
    "config 1": (_config_1, {"applied": 100, "failed": 0, "valid": True,
                             "fee pool": 10_000}),
    "verify cache seeding": (_seeding, {"applied": 8, "calls": 8,
                                        "misses": 8}),
    "upgrade base fee": (_upgrade(LUT.LEDGER_UPGRADE_BASE_FEE, 250), {}),
    "upgrade max tx set size": (
        _upgrade(LUT.LEDGER_UPGRADE_MAX_TX_SET_SIZE, 321), {}),
    "upgrade base reserve": (
        _upgrade(LUT.LEDGER_UPGRADE_BASE_RESERVE, 5 * XLM), {}),
    "upgrade flags": (_upgrade(LUT.LEDGER_UPGRADE_FLAGS, 5, version=19),
                      {}),
    "upgrade version 19 to 23": (
        _upgrade(LUT.LEDGER_UPGRADE_VERSION, 23, version=19), {}),
    "upgrade config": (_config_upgrade, {"lanes": 7}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_close_case_equals_reference(case):
    fn, want = CASES[case]
    port, ref = fn(PORT), fn(REF)
    assert port == ref
    assert {k: port[k] for k in want} == want
    if case.startswith("upgrade"):
        assert port["applied"] == 1 and port["failed"] == 0


def test_upgrade_votes_equal_reference():
    """``Upgrades`` validates and proposes alike in both packages."""
    out = {}
    for name, up_mod, lt, ledger_mod, rt in (
            ("port", pup, plt, pledger, prt),
            ("ref", jup, jlt, jledger, jrt)):
        header = lt.LedgerTxnRoot().header()
        header.ledgerVersion = 21
        params = up_mod.UpgradeParameters(
            upgrade_time=100, protocol_version=23, base_fee=200,
            max_tx_set_size=500, base_reserve=10**8 + 1, flags=1,
            max_soroban_tx_set_size=9)
        ups = up_mod.Upgrades(params)
        votes = ups.create_upgrades_for(header, 200)
        bad = rt.to_bytes(ledger_mod.LedgerUpgrade, ledger_mod.LedgerUpgrade
                          .make(ledger_mod.LedgerUpgradeType
                                .LEDGER_UPGRADE_FLAGS, 8))
        out[name] = {
            "votes": votes,
            "early": ups.create_upgrades_for(header, 50),
            "valid": [ups.is_valid(v, header, True, 200) for v in votes],
            "invalid": [ups.is_valid_for_apply(b, header)
                        for b in (bad, b"\x00")]}
    assert out["port"] == out["ref"]
    assert len(out["port"]["votes"]) == 6 and out["port"]["early"] == []
    assert all(out["port"]["valid"])


def test_effective_cost_params_equal_reference():
    """The port's ``effective_cost_params``, now whole: the initial
    tables by era, and a config's own vectors when set. Fresh configs:
    the process-wide defaults are never changed."""
    pcfg, jcfg = pnc.SorobanNetworkConfig(), jnc.SorobanNetworkConfig()
    assert dataclasses.asdict(pcfg) == \
        dataclasses.asdict(default_soroban_config()) == \
        dataclasses.asdict(jsoroban_ops.default_soroban_config())
    for protocol in (20, 21, 22, 23):
        for dim in ("cpu", "mem"):
            assert pnc.effective_cost_params(pcfg, protocol, dim) == \
                jnc.effective_cost_params(jcfg, protocol, dim)
    pcfg.cpu_cost_params = jcfg.cpu_cost_params = [(1, 2), (3, 4)]
    assert pnc.effective_cost_params(pcfg, 23, "cpu") == \
        jnc.effective_cost_params(jcfg, 23, "cpu") == [(1, 2), (3, 4)]


# ---------------- invariants ----------------

def _pool_entry(types_mod, usd, ra, rb, shares):
    body = types_mod.LiquidityPoolEntry._types[1].make(
        types_mod.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
        types_mod.LiquidityPoolEntryConstantProduct(
            params=types_mod.LiquidityPoolConstantProductParameters(
                assetA=types_mod.NATIVE_ASSET, assetB=usd, fee=30),
            reserveA=ra, reserveB=rb, totalPoolShares=shares,
            poolSharesTrustLineCount=1))
    return types_mod.LedgerEntry(
        lastModifiedLedgerSeq=1,
        data=types_mod.LedgerEntry._types[1].make(
            types_mod.LedgerEntryType.LIQUIDITY_POOL,
            types_mod.LiquidityPoolEntry(liquidityPoolID=b"\x01" * 32,
                                         body=body)),
        ext=types_mod.LedgerEntry._types[2].make(0))


def test_invariant_violation_caught_by_both():
    """``tests/test_invariants_extended.py``'s constant-product case: a
    pool delta that leaks reserves trips the invariant in both packages
    with the same message, and an honest one passes; the manager raises
    ``InvariantDoesNotHold`` for the leak in both."""
    usd = ptypes.asset_alphanum4(b"USD", ptypes.account_id(
        sha256(b"pool issuer")))
    jusd = to_ref(ptypes.Asset, jtypes.Asset, usd)
    out = {}
    for name, mod, t, asset in (("port", pinvariants, ptypes, usd),
                                ("ref", jinvariants, jtypes, jusd)):
        inv = mod.ConstantProductInvariant()
        leak = {b"k": (_pool_entry(t, asset, 1000, 1000, 50),
                       _pool_entry(t, asset, 900, 1100, 50))}
        honest = {b"k": (_pool_entry(t, asset, 1000, 1000, 50),
                         _pool_entry(t, asset, 990, 1012, 50))}
        with pytest.raises(mod.InvariantDoesNotHold) as err:
            mod.InvariantManager().check_on_operation_apply(
                None, None, leak, None)
        out[name] = (inv.check_on_operation_apply(None, None, leak, None),
                     inv.check_on_operation_apply(None, None, honest,
                                                  None),
                     str(err.value),
                     sorted(i.name for i in mod.InvariantManager()
                            .invariants))
    assert out["port"] == out["ref"]
    assert out["port"][0] and out["port"][1] is None
    assert len(out["port"][3]) == 8


# ---------------- the node close, miniature ----------------

@pytest.fixture(scope="module")
def traffic():
    """Phase 20's miniature traffic, the envelopes that pass admission
    (the port's oracle) and ``node_close_ledger`` over them."""
    saved = pkeys._backend
    pkeys.set_verifier_backend(pref.verify)
    try:
        envs, accounts = vectors.node_txset(np.random.default_rng(1222),
                                            **SMALL)
        nid = vectors.NODE_NETWORK_ID
        frames = [ptf.make_transaction_frame(nid, prt.from_bytes(
            ptx.TransactionEnvelope, e)) for e in envs]
        ltx = plt.LedgerTxn(vectors.node_ledger(accounts))
        codes = [f.check_valid(ltx).code for f in frames]
        ltx.rollback()
    finally:
        pkeys.set_verifier_backend(saved)
        pkeys.flush_verify_cache()
    accepted = [e for e, c in zip(envs, codes)
                if c == presults.TransactionResultCode.txSUCCESS]
    assert 0 < len(accepted) < len(envs)
    return accepted, accounts


def _node_close(root, envs, rt, tf, tx_mod, ts, lm_mod, ledger_mod,
                results_mod, preload):
    """Nominate ``envs`` over a fresh ``LedgerManager``, then replay the
    set from its wire bytes and close it, the close meta kept."""
    nid = vectors.NODE_NETWORK_ID
    lm = lm_mod.LedgerManager(nid, root)
    frames = [tf.make_transaction_frame(nid, rt.from_bytes(
        tx_mod.TransactionEnvelope, e)) for e in envs]
    app, excluded = ts.make_tx_set_from_transactions(
        frames, lm.last_closed_header, lm.last_closed_hash)
    assert excluded == []
    raw = rt.to_bytes(ledger_mod.GeneralizedTransactionSet, app.xdr)
    got = ts.TxSetXDRFrame.from_bytes(raw).prepare_for_apply(nid)
    if preload:
        for f, digest in zip(got.frames, hash_many(
                [f.contents_preimage() for f in got.frames],
                device="cpu")):
            f._hash = digest
    metas = []
    lm.close_meta_stream.append(lambda m: metas.append(
        rt.to_bytes(ledger_mod.LedgerCloseMeta, m)))
    res = lm.close_ledger(lm_mod.LedgerCloseData(
        ledger_seq=lm.ledger_seq + 1, tx_set=got, close_time=5000))
    return {"raw": raw, "header_hash": res.header_hash,
            "pairs": [rt.to_bytes(results_mod.TransactionResultPair, p)
                      for p in res.result_pairs],
            "applied": res.applied_count, "failed": res.failed_count,
            "meta": metas, "store": dict(lm.root.store.entries)}


@pytest.mark.parametrize("mode", ["oracle", "cpu verifier", "invariants"])
def test_node_close_miniature_equals_reference(traffic, mode):
    """Phase 22 at phase 20's 40 transactions: the accepted ones over
    ``node_close_ledger``, nominated (nothing excluded) and replayed from
    the wire bytes in each package. ``cpu verifier``: the port's close
    prefetches through a CPU ``BatchVerifier`` (the plain K1), and every
    fee- and apply-phase check is a verify-cache hit. ``invariants``:
    every invariant on in both packages."""
    accepted, accounts = traffic
    root = vectors.node_close_ledger(accounts, accepted)
    jroot = ref_root(root)
    if mode == "invariants":
        pinv.set_active_manager(pinvariants.InvariantManager())
        jinv.set_active_manager(jinvariants.InvariantManager())
    if mode == "cpu verifier":
        signer_tables.signer_table_cache.configure(enabled=False)
        verifier = BatchVerifier(device="cpu", bucket_sizes=(128,))
        verifier.install()
    try:
        pkeys.flush_verify_cache()
        port = _node_close(root, accepted, prt, ptf, ptx, pts, plm,
                           pledger, presults, preload=True)
        stats = pkeys.get_verify_cache_stats()
    finally:
        if mode == "cpu verifier":
            signer_tables.signer_table_cache.configure(
                enabled=signer_tables.ENABLED)
    ref = _node_close(jroot, accepted, jrt, jtf, jtx, jts, jlm, jledger,
                      jresults, preload=False)
    assert port == ref
    assert port["failed"] == 0 and port["applied"] == len(accepted)
    assert len(port["meta"]) == 1
    if mode == "cpu verifier":
        ltx = plt.LedgerTxn(vectors.node_close_ledger(accounts, accepted))
        frames = pts.TxSetXDRFrame.from_bytes(port["raw"]) \
            .prepare_for_apply(vectors.NODE_NETWORK_ID).frames
        keyed = sum(pkeys.cache_keyable(pk, sig) for pk, _m, sig in
                    pts.collect_signature_triples(ltx, frames))
        ltx.rollback()
        assert stats["misses"] == keyed
        assert 0 < verifier.served["device"] <= keyed


# ---------------- the pins of chip_smoke.py phase 22 ----------------

def _ref_config_1_close():
    """The reference's close of ``BASELINE.json`` config 1 as
    ``chip_smoke.py`` phase 22 (a) drives it: no ``check_valid`` before
    the close."""
    senders = [jtu.keypair(f"s{i}") for i in range(100)]
    dest = jtu.keypair("well-known-dest")
    root = jtu.seed_root_with_accounts(
        [(k, 1000 * XLM) for k in senders] + [(dest, 1000 * XLM)])
    lm = jlm.LedgerManager(jtu.TEST_NETWORK_ID, root)
    hdr = lm.last_closed_header
    hdr.maxTxSetSize = 200
    txs = [jtu.make_tx(k, start_seq(lm) + 1, [jtu.payment_op(dest, XLM)])
           for k in senders]
    txset, excluded = jts.make_tx_set_from_transactions(
        txs, hdr, lm.last_closed_hash)
    assert not excluded
    return lm.close_ledger(jlm.LedgerCloseData(
        ledger_seq=lm.ledger_seq + 1, tx_set=txset,
        close_time=chip_smoke_constants()["CLOSE_TIME"]))


def test_config_1_pin_is_the_reference_close():
    res = _ref_config_1_close()
    assert res.applied_count == 100 and res.failed_count == 0
    assert res.header_hash.hex() == \
        chip_smoke_constants()["CONFIG1_CLOSE_HASH"]


@pytest.mark.slow
def test_config_2_pins_are_the_reference_close():
    """``BASELINE.json`` config 2 at full width as ``chip_smoke.py``
    phases 20-22 build it: ``vectors.node_txset`` from ``NODE_SEED``,
    admitted by the reference's frames over ``node_ledger`` (oracle
    backend), the accepted ones over ``node_close_ledger``, nominated and
    replayed from the wire bytes, closed by the reference with a meta
    consumer. Tens of seconds; not tier 1."""
    c = chip_smoke_constants()
    envs, accounts = vectors.node_txset(np.random.default_rng(
        c["NODE_SEED"]))
    nid = vectors.NODE_NETWORK_ID
    frames = [jtf.make_transaction_frame(nid, jrt.from_bytes(
        jtx.TransactionEnvelope, e)) for e in envs]
    ltx = jlt.LedgerTxn(ref_root(vectors.node_ledger(accounts)))
    codes = [f.check_valid(ltx).code for f in frames]
    ltx.rollback()
    accepted = [e for e, code in zip(envs, codes)
                if code == jresults.TransactionResultCode.txSUCCESS]
    root = ref_root(vectors.node_close_ledger(accounts, accepted))
    lm = jlm.LedgerManager(nid, root)
    jframes = [jtf.make_transaction_frame(nid, jrt.from_bytes(
        jtx.TransactionEnvelope, e)) for e in accepted]
    app, excluded = jts.make_tx_set_from_transactions(
        jframes, lm.last_closed_header, lm.last_closed_hash)
    assert excluded == []
    got = jts.TxSetXDRFrame.from_bytes(jrt.to_bytes(
        jledger.GeneralizedTransactionSet, app.xdr)).prepare_for_apply(nid)
    metas = []
    lm.close_meta_stream.append(lambda m: metas.append(
        jrt.to_bytes(jledger.LedgerCloseMeta, m)))
    res = lm.close_ledger(jlm.LedgerCloseData(
        ledger_seq=lm.ledger_seq + 1, tx_set=got,
        close_time=c["CLOSE_TIME"]))
    assert res.failed_count == 0 and res.applied_count == len(accepted)
    assert len(accepted) == c["CONFIG2_APPLIED"]
    assert res.header_hash.hex() == c["CONFIG2_CLOSE_HASH"]
    assert hashlib.sha256(metas[0]).hexdigest() == c["CONFIG2_META_HASH"]
