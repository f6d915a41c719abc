"""The port's transaction and classic operation frames (``stellar_tpu_torch
.tx``) against the reference's (``stellar_tpu.tx``).

The copies are held to the reference's source (``_torch_port.check_copy``;
``transaction_frame`` is the validation half). A corpus of signed
envelopes goes through both packages' ``make_transaction_frame(...)
.check_valid(ltx)`` over the same ledger (the reference's root carried
from the port's byte for byte): every classic operation type valid, and
malformed where the reference has a malformed check; a fee bump, a v0
envelope, and transactions with a bad sequence number, too late, too
early, too low a fee, a missing source, too little weight, an extra
signature, a minimum sequence gap and the other preconditions. The
``TransactionResult`` bytes and every signature checker's ``used``
flags must be equal. Both packages verify with the pure-Python oracle
(no JAX compile).
"""

import hashlib

import pytest

import stellar_tpu.tx.ops  # noqa: F401 (fills the registry)
import stellar_tpu_torch.tx.ops  # noqa: F401
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.ledger import ledger_txn as jlt
from stellar_tpu.tx import op_frame as jop_frame
from stellar_tpu.tx import transaction_frame as jtf
from stellar_tpu.xdr import results as jresults
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.ledger import ledger_txn as plt
from stellar_tpu_torch.tx import op_frame as pop_frame
from stellar_tpu_torch.tx import signature_utils as psu
from stellar_tpu_torch.tx import transaction_frame as ptf
from stellar_tpu_torch.tx import tx_test_utils as tu
from stellar_tpu_torch.tx.ops.create_account import new_account_entry
from stellar_tpu_torch.xdr import results as presults
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx
from stellar_tpu_torch.xdr import types as pt

from tests._torch_port import check_copy, ref_root

MODULES = [
    "tx/account_utils.py", "tx/asset_utils.py", "tx/op_frame.py",
    "tx/sponsorship.py", "tx/offer_exchange.py", "tx/revoke_utils.py",
    "tx/transaction_frame.py", "tx/tx_test_utils.py", "tx/ops/__init__.py",
    "tx/ops/account_ops.py", "tx/ops/claimable_balances.py",
    "tx/ops/create_account.py", "tx/ops/liquidity_pool_ops.py",
    "tx/ops/misc.py", "tx/ops/offers.py", "tx/ops/payment.py",
    "tx/ops/soroban_ops.py", "tx/ops/sponsorship_ops.py",
    "tx/ops/trust_ops.py"]

OT = ptx.OperationType
NID = tu.TEST_NETWORK_ID
SEQ = 1 << 32          # every account's sequence number in the ledger
CLOSE_TIME = 1000


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


def test_registry_equals_reference_but_soroban():
    """The port registers every classic type the reference does; the
    three Soroban types wait for the Soroban slice, and a frame holding
    one raises ``NotImplementedError``, as for any unregistered type."""
    soroban = {OT.INVOKE_HOST_FUNCTION, OT.EXTEND_FOOTPRINT_TTL,
               OT.RESTORE_FOOTPRINT}
    assert set(jop_frame._REGISTRY) - set(pop_frame._REGISTRY) == soroban
    assert len(pop_frame._REGISTRY) == 24
    for t, cls in pop_frame._REGISTRY.items():
        assert cls.__name__ == jop_frame._REGISTRY[t].__name__
    alice = tu.keypair("alice")
    op = ptx.Operation(sourceAccount=None, body=ptx.OperationBody.make(
        OT.EXTEND_FOOTPRINT_TTL, ptx.ExtendFootprintTTLOp(
            ext=pt.ExtensionPoint.make(0), extendTo=100)))
    with pytest.raises(NotImplementedError, match="EXTEND_FOOTPRINT_TTL"):
        tu.make_tx(alice, SEQ + 1, [op])


# ---------------- the corpus ----------------

def _keys():
    return {n: tu.keypair(n) for n in (
        "alice", "bob", "issuer", "carol", "dave", "eve", "hank", "poor")}


def _aid(k):
    return pt.account_id(k.public_key.raw)


def _mux(k):
    return ptx.muxed_account(k.public_key.raw)


HASHX_PREIMAGE = b"the preimage of hank's hashX signer"


def _ledger(k):
    """Accounts at ``SEQ``: alice, bob, issuer, eve with a plain master
    key; carol needs weight 2 at every threshold but her master key has
    1; hank's master weight is 0 and a hashX signer stands in; poor has
    the reserve and 50 stroops. dave has no account."""
    root = tu.seed_root_with_accounts(
        [(k[n], 10**10) for n in ("alice", "bob", "issuer", "eve")],
        close_time=CLOSE_TIME)
    ltx = plt.LedgerTxn(root)
    for name, thresholds, signers, balance in (
            ("carol", b"\x01\x02\x02\x02", [], 10**10),
            ("hank", b"\x00\x01\x01\x01", [pt.Signer(
                key=pt.SignerKey.make(
                    pt.SignerKeyType.SIGNER_KEY_TYPE_HASH_X,
                    hashlib.sha256(HASHX_PREIMAGE).digest()),
                weight=1)], 10**10),
            ("poor", b"\x01\x00\x00\x00", [], 2 * 10**8 + 50)):
        entry = new_account_entry(_aid(k[name]), balance, SEQ)
        acc = entry.data.value
        acc.thresholds = thresholds
        acc.signers = signers
        acc.numSubEntries = len(signers)
        ltx.create(entry).deactivate()
    ltx.commit()
    hdr = plt.copy_header(root.header())
    hdr.ledgerVersion = 23
    root.set_header(hdr)
    return root


def _op(body_type, body=None, source=None):
    return ptx.Operation(sourceAccount=None if source is None else
                         _mux(source),
                         body=ptx.OperationBody.make(body_type, body))


def _operations(k):
    """name -> (source key, operation): a valid one of every classic type
    and, where the reference checks one, a malformed one."""
    alice, bob, issuer = k["alice"], k["bob"], k["issuer"]
    usd = pt.asset_alphanum4(b"USD", _aid(issuer))
    price = pt.Price(n=1, d=2)
    pool = hashlib.sha256(b"pool").digest()
    cb = pt.ClaimableBalanceID.make(0, hashlib.sha256(b"cb").digest())
    claimant = pt.Claimant.make(0, pt.ClaimantV0(
        destination=_aid(bob), predicate=pt.ClaimPredicate.make(
            pt.ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL)))
    usd_code = pt.AssetCode.make(pt.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                                 b"USD\x00")

    def set_options(**kw):
        fields = dict(inflationDest=None, clearFlags=None, setFlags=None,
                      masterWeight=None, lowThreshold=None,
                      medThreshold=None, highThreshold=None,
                      homeDomain=None, signer=None)
        fields.update(kw)
        return _op(OT.SET_OPTIONS, ptx.SetOptionsOp(**fields))

    def offer(kind, selling, buying, amount, price_, offer_id=0):
        if kind == OT.MANAGE_SELL_OFFER:
            return _op(kind, ptx.ManageSellOfferOp(
                selling=selling, buying=buying, amount=amount,
                price=price_, offerID=offer_id))
        if kind == OT.MANAGE_BUY_OFFER:
            return _op(kind, ptx.ManageBuyOfferOp(
                selling=selling, buying=buying, buyAmount=amount,
                price=price_, offerID=offer_id))
        return _op(kind, ptx.CreatePassiveSellOfferOp(
            selling=selling, buying=buying, amount=amount, price=price_))

    def strict_receive(dest_amount):
        return _op(OT.PATH_PAYMENT_STRICT_RECEIVE,
                   ptx.PathPaymentStrictReceiveOp(
                       sendAsset=pt.NATIVE_ASSET, sendMax=100,
                       destination=_mux(bob), destAsset=usd,
                       destAmount=dest_amount, path=[]))

    def strict_send(dest_min):
        return _op(OT.PATH_PAYMENT_STRICT_SEND, ptx.PathPaymentStrictSendOp(
            sendAsset=pt.NATIVE_ASSET, sendAmount=10, destination=_mux(bob),
            destAsset=usd, destMin=dest_min, path=[usd]))

    def revoke(key):
        return _op(OT.REVOKE_SPONSORSHIP, ptx.RevokeSponsorshipOp.make(
            ptx.RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY, key))

    offer_key = pt.LedgerKey.make(pt.LedgerEntryType.OFFER,
                                  pt.LedgerKeyOffer(sellerID=_aid(alice),
                                                    offerID=0))
    trust = pt.AUTHORIZED_FLAG
    return {
        "create account": (alice, _op(OT.CREATE_ACCOUNT, ptx.CreateAccountOp(
            destination=_aid(k["dave"]), startingBalance=10**8))),
        "create account malformed": (alice, _op(
            OT.CREATE_ACCOUNT, ptx.CreateAccountOp(
                destination=_aid(k["dave"]), startingBalance=-1))),
        "payment": (alice, tu.payment_op(bob, 5)),
        "payment malformed": (alice, tu.payment_op(bob, 0)),
        "strict receive": (alice, strict_receive(10)),
        "strict receive malformed": (alice, strict_receive(0)),
        "strict send": (alice, strict_send(1)),
        "strict send malformed": (alice, strict_send(0)),
        "sell offer": (alice, offer(OT.MANAGE_SELL_OFFER, pt.NATIVE_ASSET,
                                    usd, 100, price)),
        "sell offer malformed": (alice, offer(
            OT.MANAGE_SELL_OFFER, usd, usd, 100, price)),
        "sell offer delete unknown": (alice, offer(
            OT.MANAGE_SELL_OFFER, pt.NATIVE_ASSET, usd, 0, price)),
        "passive offer": (alice, offer(OT.CREATE_PASSIVE_SELL_OFFER,
                                       pt.NATIVE_ASSET, usd, 100, price)),
        "passive offer malformed": (alice, offer(
            OT.CREATE_PASSIVE_SELL_OFFER, pt.NATIVE_ASSET, usd, 100,
            pt.Price(n=0, d=1))),
        "buy offer": (alice, offer(OT.MANAGE_BUY_OFFER, pt.NATIVE_ASSET,
                                   usd, 100, price)),
        "buy offer malformed": (alice, offer(
            OT.MANAGE_BUY_OFFER, pt.NATIVE_ASSET, usd, -1, price)),
        "set options": (alice, set_options(homeDomain=b"example.com")),
        "set options signer": (alice, set_options(signer=pt.Signer(
            key=pt.SignerKey.make(pt.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                                  bob.public_key.raw), weight=1))),
        "set options malformed": (alice, set_options(setFlags=0x100)),
        "change trust": (alice, _op(OT.CHANGE_TRUST, ptx.ChangeTrustOp(
            line=ptx.ChangeTrustAsset.make(usd.arm, usd.value),
            limit=10**9))),
        "change trust malformed": (alice, _op(
            OT.CHANGE_TRUST, ptx.ChangeTrustOp(
                line=ptx.ChangeTrustAsset.make(usd.arm, usd.value),
                limit=-1))),
        "allow trust": (issuer, _op(OT.ALLOW_TRUST, ptx.AllowTrustOp(
            trustor=_aid(bob), asset=usd_code, authorize=trust))),
        "allow trust malformed": (issuer, _op(OT.ALLOW_TRUST, ptx.AllowTrustOp(
            trustor=_aid(issuer), asset=usd_code, authorize=trust))),
        "merge": (alice, _op(OT.ACCOUNT_MERGE, _mux(bob))),
        "merge malformed": (alice, _op(OT.ACCOUNT_MERGE, _mux(alice))),
        "inflation": (alice, _op(OT.INFLATION)),
        "manage data": (alice, _op(OT.MANAGE_DATA, ptx.ManageDataOp(
            dataName=b"key", dataValue=b"value"))),
        "manage data malformed": (alice, _op(OT.MANAGE_DATA, ptx.ManageDataOp(
            dataName=b"", dataValue=None))),
        "bump sequence": (alice, _op(OT.BUMP_SEQUENCE, ptx.BumpSequenceOp(
            bumpTo=SEQ + 50))),
        "bump sequence malformed": (alice, _op(
            OT.BUMP_SEQUENCE, ptx.BumpSequenceOp(bumpTo=-1))),
        "create claimable balance": (alice, _op(
            OT.CREATE_CLAIMABLE_BALANCE, ptx.CreateClaimableBalanceOp(
                asset=pt.NATIVE_ASSET, amount=100, claimants=[claimant]))),
        "create claimable balance malformed": (alice, _op(
            OT.CREATE_CLAIMABLE_BALANCE, ptx.CreateClaimableBalanceOp(
                asset=pt.NATIVE_ASSET, amount=100, claimants=[]))),
        "claim claimable balance": (alice, _op(
            OT.CLAIM_CLAIMABLE_BALANCE,
            ptx.ClaimClaimableBalanceOp(balanceID=cb))),
        "begin sponsoring": (alice, _op(
            OT.BEGIN_SPONSORING_FUTURE_RESERVES,
            ptx.BeginSponsoringFutureReservesOp(sponsoredID=_aid(bob)))),
        "begin sponsoring malformed": (alice, _op(
            OT.BEGIN_SPONSORING_FUTURE_RESERVES,
            ptx.BeginSponsoringFutureReservesOp(sponsoredID=_aid(alice)))),
        "end sponsoring": (alice, _op(OT.END_SPONSORING_FUTURE_RESERVES)),
        "revoke sponsorship": (alice, revoke(
            pop_frame.account_key(_aid(bob)))),
        "revoke sponsorship malformed": (alice, revoke(offer_key)),
        "revoke signer sponsorship": (alice, _op(
            OT.REVOKE_SPONSORSHIP, ptx.RevokeSponsorshipOp.make(
                ptx.RevokeSponsorshipType.REVOKE_SPONSORSHIP_SIGNER,
                ptx.RevokeSponsorshipOpSigner(
                    accountID=_aid(bob), signerKey=pt.SignerKey.make(
                        pt.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                        alice.public_key.raw))))),
        "clawback": (issuer, _op(OT.CLAWBACK, ptx.ClawbackOp(
            asset=usd, from_=_mux(bob), amount=5))),
        "clawback malformed": (issuer, _op(OT.CLAWBACK, ptx.ClawbackOp(
            asset=pt.NATIVE_ASSET, from_=_mux(bob), amount=5))),
        "clawback claimable balance": (issuer, _op(
            OT.CLAWBACK_CLAIMABLE_BALANCE,
            ptx.ClawbackClaimableBalanceOp(balanceID=cb))),
        "set trust line flags": (issuer, _op(
            OT.SET_TRUST_LINE_FLAGS, ptx.SetTrustLineFlagsOp(
                trustor=_aid(bob), asset=usd, clearFlags=0,
                setFlags=trust))),
        "set trust line flags malformed": (issuer, _op(
            OT.SET_TRUST_LINE_FLAGS, ptx.SetTrustLineFlagsOp(
                trustor=_aid(bob), asset=usd, clearFlags=0,
                setFlags=pt.TRUSTLINE_CLAWBACK_ENABLED_FLAG))),
        "pool deposit": (alice, _op(
            OT.LIQUIDITY_POOL_DEPOSIT, ptx.LiquidityPoolDepositOp(
                liquidityPoolID=pool, maxAmountA=100, maxAmountB=100,
                minPrice=pt.Price(n=1, d=2), maxPrice=pt.Price(n=2, d=1)))),
        "pool deposit malformed": (alice, _op(
            OT.LIQUIDITY_POOL_DEPOSIT, ptx.LiquidityPoolDepositOp(
                liquidityPoolID=pool, maxAmountA=100, maxAmountB=100,
                minPrice=pt.Price(n=2, d=1), maxPrice=pt.Price(n=1, d=2)))),
        "pool withdraw": (alice, _op(
            OT.LIQUIDITY_POOL_WITHDRAW, ptx.LiquidityPoolWithdrawOp(
                liquidityPoolID=pool, amount=10, minAmountA=0,
                minAmountB=0))),
        "pool withdraw malformed": (alice, _op(
            OT.LIQUIDITY_POOL_WITHDRAW, ptx.LiquidityPoolWithdrawOp(
                liquidityPoolID=pool, amount=0, minAmountA=0,
                minAmountB=0))),
    }


def _v2(**kw):
    fields = dict(timeBounds=None, ledgerBounds=None, minSeqNum=None,
                  minSeqAge=0, minSeqLedgerGap=0, extraSigners=[])
    fields.update(kw)
    return ptx.Preconditions.make(ptx.PreconditionType.PRECOND_V2,
                                  ptx.PreconditionsV2(**fields))


def _time(lo, hi):
    return ptx.Preconditions.make(ptx.PreconditionType.PRECOND_TIME,
                                  ptx.TimeBounds(minTime=lo, maxTime=hi))


def _with_signatures(env, sigs):
    env.value.signatures = list(env.value.signatures) + list(sigs)
    return env


def _fee_bump(inner_frame, fee_source, fee):
    fb = ptx.FeeBumpTransaction(
        feeSource=_mux(fee_source), fee=fee,
        innerTx=ptx.FeeBumpTransaction._types[2].make(
            pt.EnvelopeType.ENVELOPE_TYPE_TX, inner_frame.envelope.value),
        ext=ptx.FeeBumpTransaction._types[3].make(0))
    h = ptx.feebump_hash(NID, fb)
    return ptx.TransactionEnvelope.make(
        pt.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
        ptx.FeeBumpTransactionEnvelope(
            tx=fb, signatures=[fee_source.sign_decorated(h)]))


def _v0(source, ops):
    tx0 = ptx.TransactionV0(
        sourceAccountEd25519=source.public_key.raw, fee=100 * len(ops),
        seqNum=SEQ + 1, timeBounds=ptx.TimeBounds(minTime=0, maxTime=0),
        memo=ptx.MEMO_NONE, operations=ops,
        ext=ptx.TransactionV0._types[6].make(0))
    env = ptx.TransactionEnvelope.make(
        pt.EnvelopeType.ENVELOPE_TYPE_TX_V0,
        ptx.TransactionV0Envelope(tx=tx0, signatures=[]))
    h = ptf.make_transaction_frame(NID, env).contents_hash()
    env.value.signatures = [source.sign_decorated(h)]
    return env


def _transactions(k):
    """name -> port ``TransactionEnvelope`` beyond one operation each."""
    alice, bob, carol, dave, eve = (k[n] for n in (
        "alice", "bob", "carol", "dave", "eve"))
    pay = tu.payment_op(bob, 5)

    def tx(source, ops=None, seq=SEQ + 1, **kw):
        return tu.make_tx(source, seq, [pay] if ops is None else ops,
                          network_id=NID, **kw).envelope

    eve_key = pt.SignerKey.make(pt.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                                eve.public_key.raw)
    hank_tx = tu.make_tx(k["hank"], SEQ + 1, [pay], network_id=NID)
    hank_env = hank_tx.envelope
    hank_env.value.signatures = [psu.sign_hash_x(HASHX_PREIMAGE)]
    inner = tu.make_tx(alice, SEQ + 1, [pay], network_id=NID)
    bad_inner = tu.make_tx(alice, SEQ + 7, [pay], network_id=NID)
    return {
        "fee bump": _fee_bump(inner, bob, 400),
        "fee bump, outer fee too low": _fee_bump(inner, bob, 150),
        "fee bump, inner bad sequence": _fee_bump(bad_inner, bob, 400),
        "fee bump, no fee source": _fee_bump(inner, dave, 400),
        "v0 envelope": _v0(alice, [pay]),
        "two operations": tx(alice, [pay, tu.payment_op(carol, 7)]),
        "bad sequence": tx(alice, seq=SEQ + 2),
        "sequence of the ledger": tx(alice, seq=2 << 32),
        "too late": tx(alice, cond=_time(0, CLOSE_TIME - 1)),
        "too early": tx(alice, cond=_time(CLOSE_TIME + 10, 0)),
        "ledger bounds passed": tx(alice, cond=_v2(
            ledgerBounds=ptx.LedgerBounds(minLedger=0, maxLedger=2))),
        "insufficient fee": tx(alice, fee=50),
        "no operation": tx(alice, []),
        "missing account": tx(dave),
        "bad auth": tx(carol),
        "extra signature": tx(alice, extra_signers=[eve]),
        "min seq gap": tx(alice, cond=_v2(minSeqLedgerGap=5)),
        "min seq age": tx(alice, cond=_v2(minSeqAge=CLOSE_TIME + 1)),
        "min seq num admits a gap": tx(alice, seq=SEQ + 5,
                                       cond=_v2(minSeqNum=SEQ)),
        "extra signer present": tx(alice, cond=_v2(extraSigners=[eve_key]),
                                   extra_signers=[eve]),
        "extra signer missing": tx(alice, cond=_v2(extraSigners=[eve_key])),
        "extra signer twice": tx(alice, cond=_v2(
            extraSigners=[eve_key, eve_key]), extra_signers=[eve]),
        "hashX signer": hank_env,
        "insufficient balance": tx(k["poor"]),
        "op source without account, signed": tx(
            alice, [tu.payment_op(bob, 5, source=dave)],
            extra_signers=[dave]),
        "op source without account, unsigned": tx(
            alice, [tu.payment_op(bob, 5, source=dave)]),
        "op source below its threshold": tx(
            alice, [tu.payment_op(bob, 5, source=carol)],
            extra_signers=[carol]),
        "high threshold op": tx(carol, [_op(OT.ACCOUNT_MERGE, _mux(bob))]),
    }


def _corpus():
    k = _keys()
    out = {name: tu.make_tx(src, SEQ + 1, [op], network_id=NID).envelope
           for name, (src, op) in _operations(k).items()}
    out.update(_transactions(k))
    return k, out


class _Recording:
    """Wraps a package's ``SignatureChecker`` so each checker a
    ``check_valid`` makes is kept, in order."""

    def __init__(self, module, monkeypatch):
        self.made = []
        base = module.SignatureChecker
        made = self.made

        class Checker(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        monkeypatch.setattr(module, "SignatureChecker", Checker)


def _op_codes(res):
    """(top code, operation type, inner code) of each operation result."""
    out = []
    for r in getattr(res, "inner_result", res).op_results:
        inner = r.value if r.arm == 0 else None
        out.append((r.arm, None if inner is None else inner.arm,
                    None if inner is None else inner.value.arm))
    return out


def _result_bytes(frame, res, results_mod, runtime_mod):
    """The ``TransactionResult`` bytes (a fee bump's with its inner pair
    once the inner transaction was checked), or the encoder's error: a
    validation result holds each valid operation's success code without
    its payload (``OperationFrame.make_result(0)``), which the types
    whose success arm carries one (offers, path payments, account merge,
    inflation, claimable balance creation) cannot encode, in either
    package."""
    xdr = frame.to_result_xdr(res) if hasattr(res, "inner_result") \
        else res.to_xdr()
    try:
        return runtime_mod.to_bytes(results_mod.TransactionResult, xdr)
    except runtime_mod.XdrError as e:
        return f"XdrError: {e}"


def _check(frame, ltx, recording, results_mod, runtime_mod):
    recording.made.clear()
    res = frame.check_valid(ltx)
    return (res.code, _result_bytes(frame, res, results_mod, runtime_mod),
            _op_codes(res), [list(c.used) for c in recording.made])


@pytest.fixture
def oracles():
    saved = (jkeys._backend, pkeys._backend)
    jkeys.set_verifier_backend(jref.verify)
    pkeys.set_verifier_backend(None)    # the port's pure-Python oracle
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()


def test_frames_corpus_equals_reference(oracles, monkeypatch):
    k, corpus = _corpus()
    root = _ledger(k)
    jroot = ref_root(root)
    prec = _Recording(ptf, monkeypatch)
    jrec = _Recording(jtf, monkeypatch)
    ltx, jltx = plt.LedgerTxn(root), jlt.LedgerTxn(jroot)
    got = {}
    for name, env in corpus.items():
        raw = prt.to_bytes(ptx.TransactionEnvelope, env)
        pf = ptf.make_transaction_frame(
            NID, prt.from_bytes(ptx.TransactionEnvelope, raw))
        jf = jtf.make_transaction_frame(
            NID, jrt.from_bytes(jtx.TransactionEnvelope, raw))
        assert pf.contents_hash() == jf.contents_hash(), name
        port = _check(pf, ltx, prec, presults, prt)
        ref = _check(jf, jltx, jrec, jresults, jrt)
        assert port == ref, name
        got[name] = port
    assert ltx.get_changes() == [] and jltx.get_changes() == []
    ltx.rollback()
    jltx.rollback()
    C = presults.TransactionResultCode
    codes = {name: r[0] for name, r in got.items()}
    encoded = [n for n, r in got.items() if isinstance(r[1], bytes)]
    assert len(encoded) >= 60, sorted(set(got) - set(encoded))
    want = {
        "payment": C.txSUCCESS, "payment malformed": C.txFAILED,
        "fee bump": C.txFEE_BUMP_INNER_SUCCESS,
        "fee bump, outer fee too low": C.txINSUFFICIENT_FEE,
        "fee bump, inner bad sequence": C.txFEE_BUMP_INNER_FAILED,
        "fee bump, no fee source": C.txNO_ACCOUNT,
        "v0 envelope": C.txSUCCESS, "bad sequence": C.txBAD_SEQ,
        "too late": C.txTOO_LATE, "too early": C.txTOO_EARLY,
        "insufficient fee": C.txINSUFFICIENT_FEE,
        "no operation": C.txMISSING_OPERATION,
        "missing account": C.txNO_ACCOUNT, "bad auth": C.txBAD_AUTH,
        "extra signature": C.txBAD_AUTH_EXTRA,
        "min seq gap": C.txBAD_MIN_SEQ_AGE_OR_GAP,
        "min seq num admits a gap": C.txSUCCESS,
        "extra signer present": C.txSUCCESS,
        "extra signer missing": C.txBAD_AUTH,
        "extra signer twice": C.txMALFORMED,
        "hashX signer": C.txSUCCESS,
        "insufficient balance": C.txINSUFFICIENT_BALANCE,
        "op source without account, signed": C.txSUCCESS,
        "op source without account, unsigned": C.txFAILED,
        "op source below its threshold": C.txFAILED,
    }
    assert {n: codes[n] for n in want} == want
    valid = [n for n in _operations(k) if "malformed" not in n]
    malformed = [n for n in _operations(k) if "malformed" in n]
    assert len(malformed) == 20
    assert all(codes[n] == C.txFAILED for n in malformed)
    assert sum(codes[n] == C.txSUCCESS for n in valid) >= 20
    assert {corpus[n].value.tx.operations[0].body.arm
            for n in valid} == set(range(24))
    assert got["extra signature"][3] == [[True, False]]
