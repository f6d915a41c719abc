"""The golden transaction meta through the port's ledger close: the six
classic scenarios of ``tests/test_txmeta_golden.py`` (``SCENARIOS``) at
every protocol version 19-23, each closed by the port's
``LedgerManager``; the port's ``outcome_hash`` (every result pair, every
operation's ledger changes, every closing header) must equal the hash
pinned in ``tests/txmeta_baseline.json``, which this test only reads.

The scenarios' transactions are built and signed with the reference's
helpers (``tests/test_claimable_balances.py``,
``tests/test_liquidity_pools.py``, ``tests/test_sponsorship.py``,
``tests/test_transaction_frame.py``) and carried to the port through
their envelope bytes; the ledgers are the port's own. The claimable
balance's ID is read from the port's store.
"""

import hashlib
import json

import pytest

import stellar_tpu_torch.tx.ops  # noqa: F401 (fills the registry)
from stellar_tpu.tx import tx_test_utils as jtu
from stellar_tpu.tx.asset_utils import change_trust_asset_to_trustline_asset
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch.crypto import ed25519_ref as pref
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.herder.tx_set import make_tx_set_from_transactions
from stellar_tpu_torch.ledger.ledger_manager import (
    LedgerCloseData, LedgerManager,
)
from stellar_tpu_torch.protocol import (
    CURRENT_LEDGER_PROTOCOL_VERSION, MIN_SUPPORTED_PROTOCOL_VERSION,
)
from stellar_tpu_torch.tx import tx_test_utils as ptu
from stellar_tpu_torch.tx.transaction_frame import make_transaction_frame
from stellar_tpu_torch.xdr import ledger as pledger
from stellar_tpu_torch.xdr import results as presults
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx
from stellar_tpu_torch.xdr import types as ptypes

from tests._torch_port import ROOT, to_ref

XLM = 10_000_000
BASELINE = json.loads((ROOT / "tests" / "txmeta_baseline.json").read_text())
VERSIONS = list(range(MIN_SUPPORTED_PROTOCOL_VERSION,
                      CURRENT_LEDGER_PROTOCOL_VERSION + 1))
NETWORK = b"\x21" * 32
SEQ = (1 << 32) + 1


@pytest.fixture(autouse=True)
def oracle():
    """The port verifies through its pure-Python oracle; the verify
    cache flushed around each case."""
    saved = pkeys._backend
    pkeys.set_verifier_backend(pref.verify)
    pkeys.flush_verify_cache()
    yield
    pkeys.set_verifier_backend(saved)
    pkeys.flush_verify_cache()


def K(name):
    """The reference's named key (the port's ``keypair`` gives the same
    key for the same name)."""
    return jtu.keypair(name)


def _port(ref_frame):
    """A reference frame as the port's, through its envelope bytes."""
    return make_transaction_frame(NETWORK, prt.from_bytes(
        ptx.TransactionEnvelope,
        jrt.to_bytes(jtx.TransactionEnvelope, ref_frame.envelope)))


def _tx(name, seq, ops, **kw):
    return _port(jtu.make_tx(K(name), seq, ops, network_id=NETWORK, **kw))


def _lm_with(accounts, version):
    root = ptu.seed_root_with_accounts(
        [(ptu.keypair(name), balance) for name, balance in accounts])
    root.header().ledgerVersion = version
    return LedgerManager(NETWORK, root)


def _close_with(lm, frames, close_time=1700000000):
    lcl = lm.last_closed_header
    txset, _ = make_tx_set_from_transactions(frames, lcl,
                                             lm.last_closed_hash)
    return lm.close_ledger(LedgerCloseData(
        ledger_seq=lcl.ledgerSeq + 1, tx_set=txset,
        close_time=max(close_time, lcl.scpValue.closeTime + 5)))


def outcome_hash(close_results) -> str:
    """``tests/test_txmeta_golden.py``'s ``outcome_hash`` over the port's
    results, in the port's XDR."""
    h = hashlib.sha256()
    for res in close_results:
        for pair in res.result_pairs:
            h.update(prt.to_bytes(presults.TransactionResultPair, pair))
        for meta in res.tx_metas:
            for change in meta.tx_changes_before:
                h.update(prt.to_bytes(pledger.LedgerEntryChange, change))
            for op_changes in meta.operations:
                for change in op_changes:
                    h.update(prt.to_bytes(pledger.LedgerEntryChange,
                                          change))
        h.update(prt.to_bytes(pledger.LedgerHeader, res.header))
    return h.hexdigest()


def _usd(issuer):
    return jtypes.asset_alphanum4(b"USD", jtypes.account_id(
        K(issuer).public_key.raw))


def scenario_payments(version):
    lm = _lm_with([("gm-a", 1000 * XLM), ("gm-b", 1000 * XLM)], version)
    out = [_close_with(lm, [_tx("gm-a", SEQ,
                                [jtu.payment_op(K("gm-b"), 7 * XLM)])])]
    out.append(_close_with(lm, [_tx("gm-b", SEQ, [
        jtu.payment_op(K("gm-a"), 3 * XLM)])]))
    return out


def scenario_account_lifecycle(version):
    lm = _lm_with([("gm-c", 1000 * XLM)], version)
    out = [_close_with(lm, [_tx("gm-c", SEQ, [
        jtu.create_account_op(K("gm-created"), 50 * XLM)])])]
    merge = jtx.Operation(sourceAccount=None, body=jtx.OperationBody.make(
        jtx.OperationType.ACCOUNT_MERGE,
        jtx.muxed_account(K("gm-c").public_key.raw)))
    # created in the close above: its sequence starts at ledgerSeq << 32
    c_seq = (out[0].header.ledgerSeq << 32) + 1
    out.append(_close_with(lm, [_tx("gm-created", c_seq, [merge])]))
    return out


def scenario_trust_and_offers(version):
    from tests.test_liquidity_pools import op
    T = jtx.OperationType
    lm = _lm_with([("gm-d", 1000 * XLM), ("gm-e", 1000 * XLM),
                   ("gm-i", 1000 * XLM)], version)
    usd = _usd("gm-i")
    ct = op(T.CHANGE_TRUST, jtx.ChangeTrustOp(
        line=jtx.ChangeTrustAsset.make(usd.arm, usd.value), limit=10**14))
    out = [_close_with(lm, [_tx("gm-d", SEQ, [ct]),
                            _tx("gm-e", SEQ, [ct])])]
    out.append(_close_with(lm, [_tx("gm-i", SEQ, [op(
        T.PAYMENT, jtx.PaymentOp(
            destination=jtx.muxed_account(K("gm-e").public_key.raw),
            asset=usd, amount=400 * XLM))])]))
    sell = op(T.MANAGE_SELL_OFFER, jtx.ManageSellOfferOp(
        selling=jtypes.NATIVE_ASSET, buying=usd, amount=100 * XLM,
        price=jtypes.Price(n=2, d=1), offerID=0))
    cross = op(T.MANAGE_SELL_OFFER, jtx.ManageSellOfferOp(
        selling=usd, buying=jtypes.NATIVE_ASSET, amount=120 * XLM,
        price=jtypes.Price(n=1, d=2), offerID=0))
    out.append(_close_with(lm, [_tx("gm-d", SEQ + 1, [sell])]))
    out.append(_close_with(lm, [_tx("gm-e", SEQ + 1, [cross])]))
    return out


def scenario_sponsorship(version):
    from tests.test_sponsorship import begin_op, end_op
    c = K("gm-sp")
    lm = _lm_with([("gm-f", 1000 * XLM)], version)
    return [_close_with(lm, [_tx(
        "gm-f", SEQ, [begin_op(c), jtu.create_account_op(c, 0),
                      end_op(source=c)], extra_signers=[c])])]


def scenario_liquidity_pool(version):
    from tests.test_liquidity_pools import (
        change_trust_op, deposit_op, op, pool_share_line,
    )
    T = jtx.OperationType
    lm = _lm_with([("gm-g", 100_000 * XLM), ("gm-pi", 100_000 * XLM)],
                  version)
    usd = _usd("gm-pi")
    line = pool_share_line(jtypes.NATIVE_ASSET, usd)
    pool_id = change_trust_asset_to_trustline_asset(line).value
    out = [_close_with(lm, [_tx("gm-g", SEQ, [change_trust_op(
        jtx.ChangeTrustAsset.make(usd.arm, usd.value), 10**14)])])]
    out.append(_close_with(lm, [_tx("gm-pi", SEQ, [op(
        T.PAYMENT, jtx.PaymentOp(
            destination=jtx.muxed_account(K("gm-g").public_key.raw),
            asset=usd, amount=50_000 * XLM))])]))
    out.append(_close_with(lm, [_tx("gm-g", SEQ + 1, [
        change_trust_op(line, 10**14)])]))
    out.append(_close_with(lm, [_tx("gm-g", SEQ + 2, [
        deposit_op(pool_id, 1000 * XLM, 5000 * XLM)])]))
    pps = op(T.PATH_PAYMENT_STRICT_SEND, jtx.PathPaymentStrictSendOp(
        sendAsset=jtypes.NATIVE_ASSET, sendAmount=10 * XLM,
        destination=jtx.muxed_account(K("gm-g").public_key.raw),
        destAsset=usd, destMin=1, path=[]))
    out.append(_close_with(lm, [_tx("gm-g", SEQ + 3, [pps])]))
    return out


def scenario_claimable_and_feebump(version):
    from tests.test_claimable_balances import claimant, create_cb_op
    from tests.test_transaction_frame import make_feebump
    lm = _lm_with([("gm-cb-a", 1000 * XLM), ("gm-cb-b", 1000 * XLM)],
                  version)
    out = [_close_with(lm, [_tx("gm-cb-a", SEQ, [create_cb_op(
        jtypes.NATIVE_ASSET, 25 * XLM, [claimant(K("gm-cb-b"))])])])]
    # the balance ID from the port's store: its one claimable balance
    cbs = [e for e in (prt.from_bytes(ptypes.LedgerEntry, raw)
                       for raw in lm.root.store.entries.values())
           if e.data.arm == ptypes.LedgerEntryType.CLAIMABLE_BALANCE]
    assert len(cbs) == 1
    balance_id = to_ref(ptypes.ClaimableBalanceID, jtypes.ClaimableBalanceID,
                        cbs[0].data.value.balanceID)
    claim = jtx.Operation(sourceAccount=None, body=jtx.OperationBody.make(
        jtx.OperationType.CLAIM_CLAIMABLE_BALANCE,
        jtx.ClaimClaimableBalanceOp(balanceID=balance_id)))
    out.append(_close_with(lm, [_tx("gm-cb-b", SEQ, [claim])]))
    # a fee-bump payment: b pays for a's zero-fee inner transaction
    inner = jtu.make_tx(K("gm-cb-a"), SEQ + 1,
                        [jtu.payment_op(K("gm-cb-b"), XLM)], fee=0,
                        network_id=NETWORK)
    out.append(_close_with(lm, [_port(make_feebump(
        K("gm-cb-b"), 400, inner, network_id=NETWORK))]))
    return out


SCENARIOS = {
    "claimable_and_feebump": scenario_claimable_and_feebump,
    "payments": scenario_payments,
    "account_lifecycle": scenario_account_lifecycle,
    "trust_and_offers": scenario_trust_and_offers,
    "sponsorship": scenario_sponsorship,
    "liquidity_pool": scenario_liquidity_pool,
}


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_txmeta_matches_baseline(name, version):
    results = SCENARIOS[name](version)
    assert all(r.failed_count == 0 for r in results), \
        f"{name}@{version} had failing transactions"
    assert outcome_hash(results) == BASELINE[f"{name}@p{version}"]
