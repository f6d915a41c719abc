"""Transaction XDR: operations, envelopes, signature payloads.

Python declarations of ``Stellar-transaction.x`` (reference
``src/protocol-curr/xdr``), wire-compatible so transaction hashes and
signature payloads agree with the canonical protocol. Hashing helpers at
the bottom mirror ``TransactionFrame::getContentsHash``
(``src/transactions/TransactionFrame.cpp``).

The port's copy of ``stellar_tpu/xdr/tx.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.contract import (
    HostFunction, SorobanAuthorizationEntry,
)
from stellar_tpu_torch.xdr.runtime import (
    Enum, Int32, Int64, Opaque, Option, Struct, Uint32, Uint64, Union,
    VarArray, VarOpaque, Void, XdrString,
)
from stellar_tpu_torch.xdr.types import (
    AccountID, AlphaNum4, AlphaNum12, Asset, AssetCode, AssetType,
    Claimant, ClaimableBalanceID, DataValue, Duration, EnvelopeType,
    ExtensionPoint, Hash, LedgerKey, LiquidityPoolParameters, PoolID,
    Price, SequenceNumber, Signature, SignatureHint, Signer, SignerKey,
    String32, String64, TimePoint, Uint256,
)

MAX_OPS_PER_TX = 100
MAX_SIGNATURES = 20

# ---------------- accounts ----------------


class MuxedAccountMed25519(Struct):
    FIELDS = [("id", Uint64), ("ed25519", Uint256)]


_CryptoKeyTypeMuxed = Enum("CryptoKeyType.muxed", {
    "KEY_TYPE_ED25519": 0,
    "KEY_TYPE_MUXED_ED25519": 0x100,
})

MuxedAccount = Union("MuxedAccount", _CryptoKeyTypeMuxed, {
    _CryptoKeyTypeMuxed.KEY_TYPE_ED25519: Uint256,
    _CryptoKeyTypeMuxed.KEY_TYPE_MUXED_ED25519: MuxedAccountMed25519,
})

KEY_TYPE_ED25519 = 0
KEY_TYPE_MUXED_ED25519 = 0x100


def muxed_account(ed25519: bytes):
    return MuxedAccount.make(KEY_TYPE_ED25519, ed25519)


def muxed_ed25519(m) -> bytes:
    """Underlying ed25519 of a MuxedAccount (either arm)."""
    if m.arm == KEY_TYPE_ED25519:
        return m.value
    return m.value.ed25519


def muxed_to_account_id(m):
    from stellar_tpu_torch.xdr.types import account_id
    return account_id(muxed_ed25519(m))


class DecoratedSignature(Struct):
    FIELDS = [("hint", SignatureHint), ("signature", Signature)]


# ---------------- operation bodies ----------------

OperationType = Enum("OperationType", {
    "CREATE_ACCOUNT": 0,
    "PAYMENT": 1,
    "PATH_PAYMENT_STRICT_RECEIVE": 2,
    "MANAGE_SELL_OFFER": 3,
    "CREATE_PASSIVE_SELL_OFFER": 4,
    "SET_OPTIONS": 5,
    "CHANGE_TRUST": 6,
    "ALLOW_TRUST": 7,
    "ACCOUNT_MERGE": 8,
    "INFLATION": 9,
    "MANAGE_DATA": 10,
    "BUMP_SEQUENCE": 11,
    "MANAGE_BUY_OFFER": 12,
    "PATH_PAYMENT_STRICT_SEND": 13,
    "CREATE_CLAIMABLE_BALANCE": 14,
    "CLAIM_CLAIMABLE_BALANCE": 15,
    "BEGIN_SPONSORING_FUTURE_RESERVES": 16,
    "END_SPONSORING_FUTURE_RESERVES": 17,
    "REVOKE_SPONSORSHIP": 18,
    "CLAWBACK": 19,
    "CLAWBACK_CLAIMABLE_BALANCE": 20,
    "SET_TRUST_LINE_FLAGS": 21,
    "LIQUIDITY_POOL_DEPOSIT": 22,
    "LIQUIDITY_POOL_WITHDRAW": 23,
    "INVOKE_HOST_FUNCTION": 24,
    "EXTEND_FOOTPRINT_TTL": 25,
    "RESTORE_FOOTPRINT": 26,
})


class CreateAccountOp(Struct):
    FIELDS = [("destination", AccountID), ("startingBalance", Int64)]


class PaymentOp(Struct):
    FIELDS = [("destination", MuxedAccount), ("asset", Asset),
              ("amount", Int64)]


class PathPaymentStrictReceiveOp(Struct):
    FIELDS = [("sendAsset", Asset), ("sendMax", Int64),
              ("destination", MuxedAccount), ("destAsset", Asset),
              ("destAmount", Int64), ("path", VarArray(Asset, 5))]


class PathPaymentStrictSendOp(Struct):
    FIELDS = [("sendAsset", Asset), ("sendAmount", Int64),
              ("destination", MuxedAccount), ("destAsset", Asset),
              ("destMin", Int64), ("path", VarArray(Asset, 5))]


class ManageSellOfferOp(Struct):
    FIELDS = [("selling", Asset), ("buying", Asset), ("amount", Int64),
              ("price", Price), ("offerID", Int64)]


class ManageBuyOfferOp(Struct):
    FIELDS = [("selling", Asset), ("buying", Asset), ("buyAmount", Int64),
              ("price", Price), ("offerID", Int64)]


class CreatePassiveSellOfferOp(Struct):
    FIELDS = [("selling", Asset), ("buying", Asset), ("amount", Int64),
              ("price", Price)]


class SetOptionsOp(Struct):
    FIELDS = [("inflationDest", Option(AccountID)),
              ("clearFlags", Option(Uint32)),
              ("setFlags", Option(Uint32)),
              ("masterWeight", Option(Uint32)),
              ("lowThreshold", Option(Uint32)),
              ("medThreshold", Option(Uint32)),
              ("highThreshold", Option(Uint32)),
              ("homeDomain", Option(String32)),
              ("signer", Option(Signer))]


ChangeTrustAsset = Union("ChangeTrustAsset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: Void,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: AlphaNum4,
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: AlphaNum12,
    AssetType.ASSET_TYPE_POOL_SHARE: LiquidityPoolParameters,
})


class ChangeTrustOp(Struct):
    FIELDS = [("line", ChangeTrustAsset), ("limit", Int64)]


class AllowTrustOp(Struct):
    FIELDS = [("trustor", AccountID), ("asset", AssetCode),
              ("authorize", Uint32)]


class ManageDataOp(Struct):
    FIELDS = [("dataName", String64), ("dataValue", Option(DataValue))]


class BumpSequenceOp(Struct):
    FIELDS = [("bumpTo", SequenceNumber)]


class CreateClaimableBalanceOp(Struct):
    FIELDS = [("asset", Asset), ("amount", Int64),
              ("claimants", VarArray(Claimant, 10))]


class ClaimClaimableBalanceOp(Struct):
    FIELDS = [("balanceID", ClaimableBalanceID)]


class BeginSponsoringFutureReservesOp(Struct):
    FIELDS = [("sponsoredID", AccountID)]


RevokeSponsorshipType = Enum("RevokeSponsorshipType", {
    "REVOKE_SPONSORSHIP_LEDGER_ENTRY": 0,
    "REVOKE_SPONSORSHIP_SIGNER": 1,
})


class RevokeSponsorshipOpSigner(Struct):
    FIELDS = [("accountID", AccountID), ("signerKey", SignerKey)]


RevokeSponsorshipOp = Union("RevokeSponsorshipOp", RevokeSponsorshipType, {
    RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY: LedgerKey,
    RevokeSponsorshipType.REVOKE_SPONSORSHIP_SIGNER:
        RevokeSponsorshipOpSigner,
})


class ClawbackOp(Struct):
    FIELDS = [("asset", Asset), ("from_", MuxedAccount), ("amount", Int64)]


class ClawbackClaimableBalanceOp(Struct):
    FIELDS = [("balanceID", ClaimableBalanceID)]


class SetTrustLineFlagsOp(Struct):
    FIELDS = [("trustor", AccountID), ("asset", Asset),
              ("clearFlags", Uint32), ("setFlags", Uint32)]


class LiquidityPoolDepositOp(Struct):
    FIELDS = [("liquidityPoolID", PoolID), ("maxAmountA", Int64),
              ("maxAmountB", Int64), ("minPrice", Price),
              ("maxPrice", Price)]


class LiquidityPoolWithdrawOp(Struct):
    FIELDS = [("liquidityPoolID", PoolID), ("amount", Int64),
              ("minAmountA", Int64), ("minAmountB", Int64)]


class InvokeHostFunctionOp(Struct):
    FIELDS = [("hostFunction", HostFunction),
              ("auth", VarArray(SorobanAuthorizationEntry))]


class ExtendFootprintTTLOp(Struct):
    FIELDS = [("ext", ExtensionPoint), ("extendTo", Uint32)]


class RestoreFootprintOp(Struct):
    FIELDS = [("ext", ExtensionPoint)]


OperationBody = Union("Operation.body", OperationType, {
    OperationType.CREATE_ACCOUNT: CreateAccountOp,
    OperationType.PAYMENT: PaymentOp,
    OperationType.PATH_PAYMENT_STRICT_RECEIVE: PathPaymentStrictReceiveOp,
    OperationType.MANAGE_SELL_OFFER: ManageSellOfferOp,
    OperationType.CREATE_PASSIVE_SELL_OFFER: CreatePassiveSellOfferOp,
    OperationType.SET_OPTIONS: SetOptionsOp,
    OperationType.CHANGE_TRUST: ChangeTrustOp,
    OperationType.ALLOW_TRUST: AllowTrustOp,
    OperationType.ACCOUNT_MERGE: MuxedAccount,
    OperationType.INFLATION: Void,
    OperationType.MANAGE_DATA: ManageDataOp,
    OperationType.BUMP_SEQUENCE: BumpSequenceOp,
    OperationType.MANAGE_BUY_OFFER: ManageBuyOfferOp,
    OperationType.PATH_PAYMENT_STRICT_SEND: PathPaymentStrictSendOp,
    OperationType.CREATE_CLAIMABLE_BALANCE: CreateClaimableBalanceOp,
    OperationType.CLAIM_CLAIMABLE_BALANCE: ClaimClaimableBalanceOp,
    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
        BeginSponsoringFutureReservesOp,
    OperationType.END_SPONSORING_FUTURE_RESERVES: Void,
    OperationType.REVOKE_SPONSORSHIP: RevokeSponsorshipOp,
    OperationType.CLAWBACK: ClawbackOp,
    OperationType.CLAWBACK_CLAIMABLE_BALANCE: ClawbackClaimableBalanceOp,
    OperationType.SET_TRUST_LINE_FLAGS: SetTrustLineFlagsOp,
    OperationType.LIQUIDITY_POOL_DEPOSIT: LiquidityPoolDepositOp,
    OperationType.LIQUIDITY_POOL_WITHDRAW: LiquidityPoolWithdrawOp,
    OperationType.INVOKE_HOST_FUNCTION: InvokeHostFunctionOp,
    OperationType.EXTEND_FOOTPRINT_TTL: ExtendFootprintTTLOp,
    OperationType.RESTORE_FOOTPRINT: RestoreFootprintOp,
})


class Operation(Struct):
    FIELDS = [("sourceAccount", Option(MuxedAccount)),
              ("body", OperationBody)]


# ---------------- preconditions / memo ----------------


class TimeBounds(Struct):
    FIELDS = [("minTime", TimePoint), ("maxTime", TimePoint)]


class LedgerBounds(Struct):
    FIELDS = [("minLedger", Uint32), ("maxLedger", Uint32)]


class PreconditionsV2(Struct):
    FIELDS = [("timeBounds", Option(TimeBounds)),
              ("ledgerBounds", Option(LedgerBounds)),
              ("minSeqNum", Option(SequenceNumber)),
              ("minSeqAge", Duration),
              ("minSeqLedgerGap", Uint32),
              ("extraSigners", VarArray(SignerKey, 2))]


PreconditionType = Enum("PreconditionType", {
    "PRECOND_NONE": 0,
    "PRECOND_TIME": 1,
    "PRECOND_V2": 2,
})

Preconditions = Union("Preconditions", PreconditionType, {
    PreconditionType.PRECOND_NONE: Void,
    PreconditionType.PRECOND_TIME: TimeBounds,
    PreconditionType.PRECOND_V2: PreconditionsV2,
})

MemoType = Enum("MemoType", {
    "MEMO_NONE": 0,
    "MEMO_TEXT": 1,
    "MEMO_ID": 2,
    "MEMO_HASH": 3,
    "MEMO_RETURN": 4,
})

Memo = Union("Memo", MemoType, {
    MemoType.MEMO_NONE: Void,
    MemoType.MEMO_TEXT: XdrString(28),
    MemoType.MEMO_ID: Uint64,
    MemoType.MEMO_HASH: Hash,
    MemoType.MEMO_RETURN: Hash,
})

MEMO_NONE = Memo.make(MemoType.MEMO_NONE)

# ---------------- soroban resources ----------------


class LedgerFootprint(Struct):
    FIELDS = [("readOnly", VarArray(LedgerKey)),
              ("readWrite", VarArray(LedgerKey))]


class SorobanResources(Struct):
    FIELDS = [("footprint", LedgerFootprint),
              ("instructions", Uint32),
              ("readBytes", Uint32),
              ("writeBytes", Uint32)]


class SorobanTransactionData(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("resources", SorobanResources),
              ("resourceFee", Int64)]


# ---------------- transactions & envelopes ----------------


class Transaction(Struct):
    FIELDS = [("sourceAccount", MuxedAccount),
              ("fee", Uint32),
              ("seqNum", SequenceNumber),
              ("cond", Preconditions),
              ("memo", Memo),
              ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
              ("ext", Union("Transaction.ext", Int32, {
                  0: Void, 1: SorobanTransactionData}))]


class TransactionV1Envelope(Struct):
    FIELDS = [("tx", Transaction),
              ("signatures", VarArray(DecoratedSignature, MAX_SIGNATURES))]


class TransactionV0(Struct):
    """Legacy pre-protocol-13 transaction (still accepted on the wire)."""
    FIELDS = [("sourceAccountEd25519", Uint256),
              ("fee", Uint32),
              ("seqNum", SequenceNumber),
              ("timeBounds", Option(TimeBounds)),
              ("memo", Memo),
              ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
              ("ext", Union("TransactionV0.ext", Int32, {0: Void}))]


class TransactionV0Envelope(Struct):
    FIELDS = [("tx", TransactionV0),
              ("signatures", VarArray(DecoratedSignature, MAX_SIGNATURES))]


_FeeBumpInner = Union("FeeBumpTransaction.innerTx", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_TX: TransactionV1Envelope,
})


class FeeBumpTransaction(Struct):
    FIELDS = [("feeSource", MuxedAccount),
              ("fee", Int64),
              ("innerTx", _FeeBumpInner),
              ("ext", Union("FeeBumpTransaction.ext", Int32, {0: Void}))]


class FeeBumpTransactionEnvelope(Struct):
    FIELDS = [("tx", FeeBumpTransaction),
              ("signatures", VarArray(DecoratedSignature, MAX_SIGNATURES))]


TransactionEnvelope = Union("TransactionEnvelope", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_TX_V0: TransactionV0Envelope,
    EnvelopeType.ENVELOPE_TYPE_TX: TransactionV1Envelope,
    EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP: FeeBumpTransactionEnvelope,
})

_TaggedTransaction = Union(
    "TransactionSignaturePayload.taggedTransaction", EnvelopeType, {
        EnvelopeType.ENVELOPE_TYPE_TX: Transaction,
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP: FeeBumpTransaction,
    })


class TransactionSignaturePayload(Struct):
    FIELDS = [("networkId", Hash),
              ("taggedTransaction", _TaggedTransaction)]


# ---------------- hashing helpers ----------------


def transaction_sig_payload(network_id: bytes, tx: Transaction) -> bytes:
    """Bytes every signer signs: SHA-256 input for a v1 transaction."""
    from stellar_tpu_torch.xdr.runtime import to_bytes
    payload = TransactionSignaturePayload(
        networkId=network_id,
        taggedTransaction=_TaggedTransaction.make(
            EnvelopeType.ENVELOPE_TYPE_TX, tx))
    return to_bytes(TransactionSignaturePayload, payload)


def feebump_sig_payload(network_id: bytes, fb: FeeBumpTransaction) -> bytes:
    from stellar_tpu_torch.xdr.runtime import to_bytes
    payload = TransactionSignaturePayload(
        networkId=network_id,
        taggedTransaction=_TaggedTransaction.make(
            EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, fb))
    return to_bytes(TransactionSignaturePayload, payload)


def transaction_hash(network_id: bytes, tx: Transaction) -> bytes:
    """Contents hash = tx id (``TransactionFrame::getContentsHash``)."""
    from stellar_tpu_torch.crypto.sha import sha256
    return sha256(transaction_sig_payload(network_id, tx))


def feebump_hash(network_id: bytes, fb: FeeBumpTransaction) -> bytes:
    from stellar_tpu_torch.crypto.sha import sha256
    return sha256(feebump_sig_payload(network_id, fb))
