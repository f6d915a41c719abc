"""The port's ledger layer (``stellar_tpu_torch.protocol``, ``ledger/``)
against the reference's.

The copies are held to the reference's source (``_torch_port.check_copy``);
the same nested ``LedgerTxn`` script runs over both packages' roots, one
carried from the other byte for byte, and must give the same
``get_changes()`` bytes, the same misuse errors, and the same store and
header; the keys of every classic entry type, ``vectors.node_ledger``'s
root and the network config's fee formulas and setting entries must be
equal too.
"""

import dataclasses

import numpy as np
import pytest

from stellar_tpu.ledger import ledger_txn as jlt
from stellar_tpu.ledger import network_config as jnc
from stellar_tpu.xdr import contract as jcontract
from stellar_tpu.xdr import ledger as jledger
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.ledger import ledger_txn as plt
from stellar_tpu_torch.ledger import network_config as pnc
from stellar_tpu_torch.tx.ops.create_account import new_account_entry
from stellar_tpu_torch.tx.ops.soroban_ops import default_soroban_config
from stellar_tpu_torch.xdr import contract as pcontract
from stellar_tpu_torch.xdr import ledger as pledger
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import types as ptypes

from tests._torch_port import check_copy, ref_root, to_ref

MODULES = ["protocol.py", "ledger/__init__.py", "ledger/ledger_txn.py",
           "ledger/network_config.py", "soroban/cost_model.py"]

T = ptypes.LedgerEntryType


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


def _entry(body_type, body, seq=1):
    return ptypes.LedgerEntry(
        lastModifiedLedgerSeq=seq,
        data=ptypes.LedgerEntry._types[1].make(body_type, body),
        ext=ptypes.LedgerEntry._types[2].make(0))


def _classic_entries(rng):
    """One port entry of each classic type."""
    aid = ptypes.account_id(rng.bytes(32))
    usd = ptypes.asset_alphanum4(b"USD", ptypes.account_id(rng.bytes(32)))
    tl_asset = ptypes.TrustLineAsset.make(usd.arm, usd.value)
    cb_id = ptypes.ClaimableBalanceID.make(0, rng.bytes(32))
    params = ptypes.LiquidityPoolConstantProductParameters(
        assetA=ptypes.NATIVE_ASSET, assetB=usd, fee=30)
    claimant = ptypes.Claimant.make(0, ptypes.ClaimantV0(
        destination=aid, predicate=ptypes.ClaimPredicate.make(
            ptypes.ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL)))
    return {
        "account": new_account_entry(aid, 10**9, 5 << 32, 1),
        "trustline": _entry(T.TRUSTLINE, ptypes.TrustLineEntry(
            accountID=aid, asset=tl_asset, balance=5, limit=10**6,
            flags=ptypes.AUTHORIZED_FLAG,
            ext=ptypes.TrustLineEntry._types[5].make(0))),
        "offer": _entry(T.OFFER, ptypes.OfferEntry(
            sellerID=aid, offerID=77, selling=ptypes.NATIVE_ASSET,
            buying=usd, amount=1000, price=ptypes.Price(n=3, d=7),
            flags=0, ext=ptypes.OfferEntry._types[7].make(0))),
        "data": _entry(T.DATA, ptypes.DataEntry(
            accountID=aid, dataName=b"name", dataValue=b"\x01\x02",
            ext=ptypes.DataEntry._types[3].make(0))),
        "claimable_balance": _entry(T.CLAIMABLE_BALANCE,
                                    ptypes.ClaimableBalanceEntry(
            balanceID=cb_id, claimants=[claimant], asset=usd, amount=9,
            ext=ptypes.ClaimableBalanceEntry._types[4].make(0))),
        "liquidity_pool": _entry(T.LIQUIDITY_POOL, ptypes.LiquidityPoolEntry(
            liquidityPoolID=rng.bytes(32),
            body=ptypes.LiquidityPoolEntry._types[1].make(
                0, ptypes.LiquidityPoolEntryConstantProduct(
                    params=params, reserveA=10, reserveB=20,
                    totalPoolShares=14, poolSharesTrustLineCount=1)))),
    }


@pytest.mark.parametrize("kind", ["account", "trustline", "offer", "data",
                                  "claimable_balance", "liquidity_pool"])
def test_entry_key_equals_reference(kind):
    entry = _classic_entries(np.random.default_rng(1300))[kind]
    pk = prt.to_bytes(ptypes.LedgerKey, plt.entry_to_key(entry))
    jentry = to_ref(ptypes.LedgerEntry, jtypes.LedgerEntry, entry)
    jk = jrt.to_bytes(jtypes.LedgerKey, jlt.entry_to_key(jentry))
    assert pk == jk
    assert plt.key_bytes(plt.entry_to_key(entry)) == pk


class _Pkg:
    """One package's ledger layer, for the script below."""

    def __init__(self, lt, ledger_mod, types_mod):
        self.lt, self.ledger, self.types = lt, ledger_mod, types_mod
        self.rt = prt if lt is plt else jrt

    def key(self, entry):
        return self.lt.entry_to_key(entry)

    def changes(self, ltx):
        return [self.rt.to_bytes(self.ledger.LedgerEntryChange, c)
                for c in ltx.get_changes()]

    def raises(self, fn):
        try:
            fn()
        except self.lt.LedgerTxnError as e:
            return type(e).__name__
        return None


def _script(pkg, root, es):
    """Nested create / load / erase / commit / rollback over ``root``;
    every observable as bytes or names."""
    a, b, c, d, e, f = es
    out = {}
    l1 = pkg.lt.LedgerTxn(root)
    with l1.load(pkg.key(a)) as h:
        h.data.balance += 7
    l1.create(d).deactivate()
    l1.erase(pkg.key(b))
    with l1.load_header() as hh:
        hh.header.feePool += 11
    out["create existing"] = pkg.raises(lambda: l1.create(a))
    out["erase missing"] = pkg.raises(lambda: l1.erase(pkg.key(b)))
    out["load erased"] = l1.load(pkg.key(b))
    l2 = pkg.lt.LedgerTxn(l1)
    out["sealed parent"] = pkg.raises(lambda: l1.load(pkg.key(a)))
    out["second child"] = pkg.raises(lambda: pkg.lt.LedgerTxn(l1))
    with l2.load(pkg.key(d)) as h:
        h.data.balance -= 3
    l2.create(e).deactivate()
    l2.erase(pkg.key(c))
    out["inner changes"] = pkg.changes(l2)
    out["inner delta"] = sorted(l2.get_delta())
    l2.rollback()
    out["after rollback"] = pkg.rt.to_bytes(
        pkg.types.LedgerEntry, l1.load_without_record(pkg.key(d)))
    l3 = pkg.lt.LedgerTxn(l1)
    h = l3.load(pkg.key(a))
    out["double load"] = pkg.raises(lambda: l3.load(pkg.key(a)))
    h.data.seqNum += 1
    h.deactivate()
    l3.create(f).deactivate()
    l3.erase(pkg.key(d))
    out["committed changes"] = pkg.changes(l3)
    l3.commit()
    out["outer changes"] = pkg.changes(l1)
    out["closed"] = pkg.raises(lambda: l3.load(pkg.key(a)))
    l1.commit()
    out["store"] = sorted(root.store.entries.items())
    out["header"] = pkg.rt.to_bytes(pkg.ledger.LedgerHeader, root.header())
    return out


def test_nested_ledger_txn_equals_reference():
    rng = np.random.default_rng(1301)
    port_entries = [new_account_entry(ptypes.account_id(rng.bytes(32)),
                                      10**9 + i, (3 << 32) + i, 1)
                    for i in range(6)]
    root = plt.LedgerTxnRoot()
    for entry in port_entries[:3]:
        root.store.put(plt.key_bytes(plt.entry_to_key(entry)), entry)
    jroot = ref_root(root)
    jentries = [to_ref(ptypes.LedgerEntry, jtypes.LedgerEntry, x)
                for x in port_entries]
    port = _script(_Pkg(plt, pledger, ptypes), root, port_entries)
    ref = _script(_Pkg(jlt, jledger, jtypes), jroot, jentries)
    assert port == ref
    assert port["load erased"] is None
    assert port["sealed parent"] == "LedgerTxnError"
    assert port["double load"] == "LedgerTxnError"
    assert len(port["inner changes"]) == 4
    assert len(port["store"]) == 3


def test_node_ledger_carries_to_reference():
    envs, accounts = vectors.node_txset(
        np.random.default_rng(1302), single=3, multisig=3, two_op=2,
        special=2)
    root = vectors.node_ledger(accounts)
    header = root.header()
    assert (header.ledgerVersion, header.ledgerSeq, header.maxTxSetSize,
            header.baseFee, header.baseReserve) == (23, 2, 1150, 100,
                                                    100_000_000)
    assert len(root.store.entries) == len(accounts)
    ltx = plt.LedgerTxn(root)
    for raw, acc in accounts.items():
        got = ltx.load_without_record(plt.entry_to_key(_entry(
            T.ACCOUNT, acc))).data.value
        assert got.seqNum == acc.seqNum - 1
        assert got.signers == acc.signers
    ltx.rollback()
    jroot = ref_root(root)
    jltx = jlt.LedgerTxn(jroot)
    assert jlt.soroban_config_of(jltx) is not None
    assert jrt.to_bytes(jledger.LedgerHeader, jltx.header()) == \
        prt.to_bytes(pledger.LedgerHeader, header)
    jltx.rollback()


def test_soroban_config_defaults_equal_reference():
    from stellar_tpu.tx.ops.soroban_ops import (
        default_soroban_config as jdefault,
    )
    port = dataclasses.asdict(default_soroban_config())
    assert port == dataclasses.asdict(jdefault())
    assert plt.soroban_config_of(plt.LedgerTxn(plt.LedgerTxnRoot())) is \
        default_soroban_config()


@pytest.mark.parametrize("args", [
    (0, 0, 0, 0, 0, 200), (25_000_000, 3, 2, 4_096, 2_048, 900),
    (100_000_000, 40, 25, 200_000, 130_000, 70_000)])
def test_resource_and_rent_fees_equal_reference(args):
    pc, jc = pnc.SorobanNetworkConfig(), jnc.SorobanNetworkConfig()
    assert pnc.compute_resource_fee(pc, *args, events_size_bytes=333) == \
        jnc.compute_resource_fee(jc, *args, events_size_bytes=333)
    for persistent in (True, False):
        assert pnc.compute_rent_fee(pc, args[4], args[5], persistent) == \
            jnc.compute_rent_fee(jc, args[4], args[5], persistent)


def test_setting_entries_equal_reference():
    """Every setting the config stores gives the reference's entry bytes,
    the two cost-parameter settings too: with their vectors unset they
    read the initial tables of ``soroban/cost_model.py``, and with them
    set, the vectors themselves."""
    pc, jc = pnc.SorobanNetworkConfig(), jnc.SorobanNetworkConfig()
    ids = pnc.ALL_SETTING_IDS()
    assert list(ids) == list(jnc.ALL_SETTING_IDS())
    pinned = [(7, 3), (0, 0), (2_000, 128)]
    for cfgs in ((pc, jc), (pnc.SorobanNetworkConfig(
            cpu_cost_params=pinned, mem_cost_params=pinned[::-1]),
            jnc.SorobanNetworkConfig(
            cpu_cost_params=pinned, mem_cost_params=pinned[::-1]))):
        _same_setting_entries(ids, *cfgs)
    assert jcontract.ConfigSettingID.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES \
        == pcontract.ConfigSettingID.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES


def _same_setting_entries(ids, pc, jc):
    for sid in ids:
        pe = pnc.config_setting_ledger_entry(
            pnc.setting_entry_from_config(pc, sid), 3)
        je = jnc.config_setting_ledger_entry(
            jnc.setting_entry_from_config(jc, sid), 3)
        assert prt.to_bytes(ptypes.LedgerEntry, pe) == \
            jrt.to_bytes(jtypes.LedgerEntry, je)
        assert prt.to_bytes(ptypes.LedgerKey, pnc.config_setting_ledger_key(
            sid)) == jrt.to_bytes(jtypes.LedgerKey,
                                  jnc.config_setting_ledger_key(sid))
