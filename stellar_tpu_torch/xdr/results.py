"""Transaction/operation result XDR (``Stellar-transaction.x`` results
section). Wire-compatible with the reference's result hashing (results
are part of history checkpoints and tx-meta baselines).

The port's copy of ``stellar_tpu/xdr/results.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.runtime import (
    Enum, Int32, Int64, Struct, Uint32, Union, VarArray, Void,
)
from stellar_tpu_torch.xdr.types import (
    AccountID, Asset, ClaimableBalanceID, Hash, OfferEntry, PoolID,
    Uint256,
)

# ---------------- claim atoms (offer crossing records) ----------------

ClaimAtomType = Enum("ClaimAtomType", {
    "CLAIM_ATOM_TYPE_V0": 0,
    "CLAIM_ATOM_TYPE_ORDER_BOOK": 1,
    "CLAIM_ATOM_TYPE_LIQUIDITY_POOL": 2,
})


class ClaimOfferAtomV0(Struct):
    FIELDS = [("sellerEd25519", Uint256),
              ("offerID", Int64),
              ("assetSold", Asset), ("amountSold", Int64),
              ("assetBought", Asset), ("amountBought", Int64)]


class ClaimOfferAtom(Struct):
    FIELDS = [("sellerID", AccountID), ("offerID", Int64),
              ("assetSold", Asset), ("amountSold", Int64),
              ("assetBought", Asset), ("amountBought", Int64)]


class ClaimLiquidityAtom(Struct):
    FIELDS = [("liquidityPoolID", PoolID),
              ("assetSold", Asset), ("amountSold", Int64),
              ("assetBought", Asset), ("amountBought", Int64)]


ClaimAtom = Union("ClaimAtom", ClaimAtomType, {
    ClaimAtomType.CLAIM_ATOM_TYPE_V0: ClaimOfferAtomV0,
    ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK: ClaimOfferAtom,
    ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL: ClaimLiquidityAtom,
})


def _codes(name, pairs):
    return Enum(name, dict(pairs))


def _result_union(name, code_enum, success_arms, void_codes):
    """Result union where listed codes carry payloads and the rest are
    void (XDR 'default: void' pattern used by every op result)."""
    arms = dict(success_arms)
    for c in void_codes:
        arms[c] = Void
    return Union(name, code_enum, arms, default=Void)


# ---------------- per-op results ----------------

CreateAccountResultCode = _codes("CreateAccountResultCode", {
    "CREATE_ACCOUNT_SUCCESS": 0, "CREATE_ACCOUNT_MALFORMED": -1,
    "CREATE_ACCOUNT_UNDERFUNDED": -2, "CREATE_ACCOUNT_LOW_RESERVE": -3,
    "CREATE_ACCOUNT_ALREADY_EXIST": -4})
CreateAccountResult = _result_union(
    "CreateAccountResult", CreateAccountResultCode, {}, [0])

PaymentResultCode = _codes("PaymentResultCode", {
    "PAYMENT_SUCCESS": 0, "PAYMENT_MALFORMED": -1,
    "PAYMENT_UNDERFUNDED": -2, "PAYMENT_SRC_NO_TRUST": -3,
    "PAYMENT_SRC_NOT_AUTHORIZED": -4, "PAYMENT_NO_DESTINATION": -5,
    "PAYMENT_NO_TRUST": -6, "PAYMENT_NOT_AUTHORIZED": -7,
    "PAYMENT_LINE_FULL": -8, "PAYMENT_NO_ISSUER": -9})
PaymentResult = _result_union("PaymentResult", PaymentResultCode, {}, [0])


class SimplePaymentResult(Struct):
    FIELDS = [("destination", AccountID), ("asset", Asset),
              ("amount", Int64)]


class PathPaymentStrictReceiveResultSuccess(Struct):
    FIELDS = [("offers", VarArray(ClaimAtom)),
              ("last", SimplePaymentResult)]


PathPaymentStrictReceiveResultCode = _codes(
    "PathPaymentStrictReceiveResultCode", {
        "PATH_PAYMENT_STRICT_RECEIVE_SUCCESS": 0,
        "PATH_PAYMENT_STRICT_RECEIVE_MALFORMED": -1,
        "PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED": -2,
        "PATH_PAYMENT_STRICT_RECEIVE_SRC_NO_TRUST": -3,
        "PATH_PAYMENT_STRICT_RECEIVE_SRC_NOT_AUTHORIZED": -4,
        "PATH_PAYMENT_STRICT_RECEIVE_NO_DESTINATION": -5,
        "PATH_PAYMENT_STRICT_RECEIVE_NO_TRUST": -6,
        "PATH_PAYMENT_STRICT_RECEIVE_NOT_AUTHORIZED": -7,
        "PATH_PAYMENT_STRICT_RECEIVE_LINE_FULL": -8,
        "PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER": -9,
        "PATH_PAYMENT_STRICT_RECEIVE_TOO_FEW_OFFERS": -10,
        "PATH_PAYMENT_STRICT_RECEIVE_OFFER_CROSS_SELF": -11,
        "PATH_PAYMENT_STRICT_RECEIVE_OVER_SENDMAX": -12})
PathPaymentStrictReceiveResult = _result_union(
    "PathPaymentStrictReceiveResult", PathPaymentStrictReceiveResultCode,
    {0: PathPaymentStrictReceiveResultSuccess, -9: Asset}, [])


class PathPaymentStrictSendResultSuccess(Struct):
    FIELDS = [("offers", VarArray(ClaimAtom)),
              ("last", SimplePaymentResult)]


PathPaymentStrictSendResultCode = _codes(
    "PathPaymentStrictSendResultCode", {
        "PATH_PAYMENT_STRICT_SEND_SUCCESS": 0,
        "PATH_PAYMENT_STRICT_SEND_MALFORMED": -1,
        "PATH_PAYMENT_STRICT_SEND_UNDERFUNDED": -2,
        "PATH_PAYMENT_STRICT_SEND_SRC_NO_TRUST": -3,
        "PATH_PAYMENT_STRICT_SEND_SRC_NOT_AUTHORIZED": -4,
        "PATH_PAYMENT_STRICT_SEND_NO_DESTINATION": -5,
        "PATH_PAYMENT_STRICT_SEND_NO_TRUST": -6,
        "PATH_PAYMENT_STRICT_SEND_NOT_AUTHORIZED": -7,
        "PATH_PAYMENT_STRICT_SEND_LINE_FULL": -8,
        "PATH_PAYMENT_STRICT_SEND_NO_ISSUER": -9,
        "PATH_PAYMENT_STRICT_SEND_TOO_FEW_OFFERS": -10,
        "PATH_PAYMENT_STRICT_SEND_OFFER_CROSS_SELF": -11,
        "PATH_PAYMENT_STRICT_SEND_UNDER_DESTMIN": -12})
PathPaymentStrictSendResult = _result_union(
    "PathPaymentStrictSendResult", PathPaymentStrictSendResultCode,
    {0: PathPaymentStrictSendResultSuccess, -9: Asset}, [])

ManageOfferEffect = Enum("ManageOfferEffect", {
    "MANAGE_OFFER_CREATED": 0, "MANAGE_OFFER_UPDATED": 1,
    "MANAGE_OFFER_DELETED": 2})


class ManageOfferSuccessResult(Struct):
    FIELDS = [("offersClaimed", VarArray(ClaimAtom)),
              ("offer", Union("ManageOfferSuccessResult.offer",
                              ManageOfferEffect, {
                                  0: OfferEntry, 1: OfferEntry, 2: Void}))]


ManageSellOfferResultCode = _codes("ManageSellOfferResultCode", {
    "MANAGE_SELL_OFFER_SUCCESS": 0, "MANAGE_SELL_OFFER_MALFORMED": -1,
    "MANAGE_SELL_OFFER_SELL_NO_TRUST": -2,
    "MANAGE_SELL_OFFER_BUY_NO_TRUST": -3,
    "MANAGE_SELL_OFFER_SELL_NOT_AUTHORIZED": -4,
    "MANAGE_SELL_OFFER_BUY_NOT_AUTHORIZED": -5,
    "MANAGE_SELL_OFFER_LINE_FULL": -6,
    "MANAGE_SELL_OFFER_UNDERFUNDED": -7,
    "MANAGE_SELL_OFFER_CROSS_SELF": -8,
    "MANAGE_SELL_OFFER_SELL_NO_ISSUER": -9,
    "MANAGE_SELL_OFFER_BUY_NO_ISSUER": -10,
    "MANAGE_SELL_OFFER_NOT_FOUND": -11,
    "MANAGE_SELL_OFFER_LOW_RESERVE": -12})
ManageSellOfferResult = _result_union(
    "ManageSellOfferResult", ManageSellOfferResultCode,
    {0: ManageOfferSuccessResult}, [])

ManageBuyOfferResultCode = _codes("ManageBuyOfferResultCode", {
    "MANAGE_BUY_OFFER_SUCCESS": 0, "MANAGE_BUY_OFFER_MALFORMED": -1,
    "MANAGE_BUY_OFFER_SELL_NO_TRUST": -2,
    "MANAGE_BUY_OFFER_BUY_NO_TRUST": -3,
    "MANAGE_BUY_OFFER_SELL_NOT_AUTHORIZED": -4,
    "MANAGE_BUY_OFFER_BUY_NOT_AUTHORIZED": -5,
    "MANAGE_BUY_OFFER_LINE_FULL": -6, "MANAGE_BUY_OFFER_UNDERFUNDED": -7,
    "MANAGE_BUY_OFFER_CROSS_SELF": -8,
    "MANAGE_BUY_OFFER_SELL_NO_ISSUER": -9,
    "MANAGE_BUY_OFFER_BUY_NO_ISSUER": -10,
    "MANAGE_BUY_OFFER_NOT_FOUND": -11,
    "MANAGE_BUY_OFFER_LOW_RESERVE": -12})
ManageBuyOfferResult = _result_union(
    "ManageBuyOfferResult", ManageBuyOfferResultCode,
    {0: ManageOfferSuccessResult}, [])

SetOptionsResultCode = _codes("SetOptionsResultCode", {
    "SET_OPTIONS_SUCCESS": 0, "SET_OPTIONS_LOW_RESERVE": -1,
    "SET_OPTIONS_TOO_MANY_SIGNERS": -2, "SET_OPTIONS_BAD_FLAGS": -3,
    "SET_OPTIONS_INVALID_INFLATION": -4, "SET_OPTIONS_CANT_CHANGE": -5,
    "SET_OPTIONS_UNKNOWN_FLAG": -6,
    "SET_OPTIONS_THRESHOLD_OUT_OF_RANGE": -7,
    "SET_OPTIONS_BAD_SIGNER": -8, "SET_OPTIONS_INVALID_HOME_DOMAIN": -9,
    "SET_OPTIONS_AUTH_REVOCABLE_REQUIRED": -10})
SetOptionsResult = _result_union(
    "SetOptionsResult", SetOptionsResultCode, {}, [0])

ChangeTrustResultCode = _codes("ChangeTrustResultCode", {
    "CHANGE_TRUST_SUCCESS": 0, "CHANGE_TRUST_MALFORMED": -1,
    "CHANGE_TRUST_NO_ISSUER": -2, "CHANGE_TRUST_INVALID_LIMIT": -3,
    "CHANGE_TRUST_LOW_RESERVE": -4, "CHANGE_TRUST_SELF_NOT_ALLOWED": -5,
    "CHANGE_TRUST_TRUST_LINE_MISSING": -6,
    "CHANGE_TRUST_CANNOT_DELETE": -7,
    "CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES": -8})
ChangeTrustResult = _result_union(
    "ChangeTrustResult", ChangeTrustResultCode, {}, [0])

AllowTrustResultCode = _codes("AllowTrustResultCode", {
    "ALLOW_TRUST_SUCCESS": 0, "ALLOW_TRUST_MALFORMED": -1,
    "ALLOW_TRUST_NO_TRUST_LINE": -2, "ALLOW_TRUST_TRUST_NOT_REQUIRED": -3,
    "ALLOW_TRUST_CANT_REVOKE": -4, "ALLOW_TRUST_SELF_NOT_ALLOWED": -5,
    "ALLOW_TRUST_LOW_RESERVE": -6})
AllowTrustResult = _result_union(
    "AllowTrustResult", AllowTrustResultCode, {}, [0])

AccountMergeResultCode = _codes("AccountMergeResultCode", {
    "ACCOUNT_MERGE_SUCCESS": 0, "ACCOUNT_MERGE_MALFORMED": -1,
    "ACCOUNT_MERGE_NO_ACCOUNT": -2, "ACCOUNT_MERGE_IMMUTABLE_SET": -3,
    "ACCOUNT_MERGE_HAS_SUB_ENTRIES": -4,
    "ACCOUNT_MERGE_SEQNUM_TOO_FAR": -5, "ACCOUNT_MERGE_DEST_FULL": -6,
    "ACCOUNT_MERGE_IS_SPONSOR": -7})
AccountMergeResult = _result_union(
    "AccountMergeResult", AccountMergeResultCode, {0: Int64}, [])


class InflationPayout(Struct):
    FIELDS = [("destination", AccountID), ("amount", Int64)]


InflationResultCode = _codes("InflationResultCode", {
    "INFLATION_SUCCESS": 0, "INFLATION_NOT_TIME": -1})
InflationResult = _result_union(
    "InflationResult", InflationResultCode,
    {0: VarArray(InflationPayout)}, [])

ManageDataResultCode = _codes("ManageDataResultCode", {
    "MANAGE_DATA_SUCCESS": 0, "MANAGE_DATA_NOT_SUPPORTED_YET": -1,
    "MANAGE_DATA_NAME_NOT_FOUND": -2, "MANAGE_DATA_LOW_RESERVE": -3,
    "MANAGE_DATA_INVALID_NAME": -4})
ManageDataResult = _result_union(
    "ManageDataResult", ManageDataResultCode, {}, [0])

BumpSequenceResultCode = _codes("BumpSequenceResultCode", {
    "BUMP_SEQUENCE_SUCCESS": 0, "BUMP_SEQUENCE_BAD_SEQ": -1})
BumpSequenceResult = _result_union(
    "BumpSequenceResult", BumpSequenceResultCode, {}, [0])

CreateClaimableBalanceResultCode = _codes(
    "CreateClaimableBalanceResultCode", {
        "CREATE_CLAIMABLE_BALANCE_SUCCESS": 0,
        "CREATE_CLAIMABLE_BALANCE_MALFORMED": -1,
        "CREATE_CLAIMABLE_BALANCE_LOW_RESERVE": -2,
        "CREATE_CLAIMABLE_BALANCE_NO_TRUST": -3,
        "CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED": -4,
        "CREATE_CLAIMABLE_BALANCE_UNDERFUNDED": -5})
CreateClaimableBalanceResult = _result_union(
    "CreateClaimableBalanceResult", CreateClaimableBalanceResultCode,
    {0: ClaimableBalanceID}, [])

ClaimClaimableBalanceResultCode = _codes(
    "ClaimClaimableBalanceResultCode", {
        "CLAIM_CLAIMABLE_BALANCE_SUCCESS": 0,
        "CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST": -1,
        "CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM": -2,
        "CLAIM_CLAIMABLE_BALANCE_LINE_FULL": -3,
        "CLAIM_CLAIMABLE_BALANCE_NO_TRUST": -4,
        "CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED": -5})
ClaimClaimableBalanceResult = _result_union(
    "ClaimClaimableBalanceResult", ClaimClaimableBalanceResultCode, {}, [0])

BeginSponsoringFutureReservesResultCode = _codes(
    "BeginSponsoringFutureReservesResultCode", {
        "BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS": 0,
        "BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED": -1,
        "BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED": -2,
        "BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE": -3})
BeginSponsoringFutureReservesResult = _result_union(
    "BeginSponsoringFutureReservesResult",
    BeginSponsoringFutureReservesResultCode, {}, [0])

EndSponsoringFutureReservesResultCode = _codes(
    "EndSponsoringFutureReservesResultCode", {
        "END_SPONSORING_FUTURE_RESERVES_SUCCESS": 0,
        "END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED": -1})
EndSponsoringFutureReservesResult = _result_union(
    "EndSponsoringFutureReservesResult",
    EndSponsoringFutureReservesResultCode, {}, [0])

RevokeSponsorshipResultCode = _codes("RevokeSponsorshipResultCode", {
    "REVOKE_SPONSORSHIP_SUCCESS": 0,
    "REVOKE_SPONSORSHIP_DOES_NOT_EXIST": -1,
    "REVOKE_SPONSORSHIP_NOT_SPONSOR": -2,
    "REVOKE_SPONSORSHIP_LOW_RESERVE": -3,
    "REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE": -4,
    "REVOKE_SPONSORSHIP_MALFORMED": -5})
RevokeSponsorshipResult = _result_union(
    "RevokeSponsorshipResult", RevokeSponsorshipResultCode, {}, [0])

ClawbackResultCode = _codes("ClawbackResultCode", {
    "CLAWBACK_SUCCESS": 0, "CLAWBACK_MALFORMED": -1,
    "CLAWBACK_NOT_CLAWBACK_ENABLED": -2, "CLAWBACK_NO_TRUST": -3,
    "CLAWBACK_UNDERFUNDED": -4})
ClawbackResult = _result_union(
    "ClawbackResult", ClawbackResultCode, {}, [0])

ClawbackClaimableBalanceResultCode = _codes(
    "ClawbackClaimableBalanceResultCode", {
        "CLAWBACK_CLAIMABLE_BALANCE_SUCCESS": 0,
        "CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST": -1,
        "CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER": -2,
        "CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED": -3})
ClawbackClaimableBalanceResult = _result_union(
    "ClawbackClaimableBalanceResult",
    ClawbackClaimableBalanceResultCode, {}, [0])

SetTrustLineFlagsResultCode = _codes("SetTrustLineFlagsResultCode", {
    "SET_TRUST_LINE_FLAGS_SUCCESS": 0,
    "SET_TRUST_LINE_FLAGS_MALFORMED": -1,
    "SET_TRUST_LINE_FLAGS_NO_TRUST_LINE": -2,
    "SET_TRUST_LINE_FLAGS_CANT_REVOKE": -3,
    "SET_TRUST_LINE_FLAGS_INVALID_STATE": -4,
    "SET_TRUST_LINE_FLAGS_LOW_RESERVE": -5})
SetTrustLineFlagsResult = _result_union(
    "SetTrustLineFlagsResult", SetTrustLineFlagsResultCode, {}, [0])

LiquidityPoolDepositResultCode = _codes("LiquidityPoolDepositResultCode", {
    "LIQUIDITY_POOL_DEPOSIT_SUCCESS": 0,
    "LIQUIDITY_POOL_DEPOSIT_MALFORMED": -1,
    "LIQUIDITY_POOL_DEPOSIT_NO_TRUST": -2,
    "LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED": -3,
    "LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED": -4,
    "LIQUIDITY_POOL_DEPOSIT_LINE_FULL": -5,
    "LIQUIDITY_POOL_DEPOSIT_BAD_PRICE": -6,
    "LIQUIDITY_POOL_DEPOSIT_POOL_FULL": -7})
LiquidityPoolDepositResult = _result_union(
    "LiquidityPoolDepositResult", LiquidityPoolDepositResultCode, {}, [0])

LiquidityPoolWithdrawResultCode = _codes(
    "LiquidityPoolWithdrawResultCode", {
        "LIQUIDITY_POOL_WITHDRAW_SUCCESS": 0,
        "LIQUIDITY_POOL_WITHDRAW_MALFORMED": -1,
        "LIQUIDITY_POOL_WITHDRAW_NO_TRUST": -2,
        "LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED": -3,
        "LIQUIDITY_POOL_WITHDRAW_LINE_FULL": -4,
        "LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM": -5})
LiquidityPoolWithdrawResult = _result_union(
    "LiquidityPoolWithdrawResult", LiquidityPoolWithdrawResultCode, {}, [0])

InvokeHostFunctionResultCode = _codes("InvokeHostFunctionResultCode", {
    "INVOKE_HOST_FUNCTION_SUCCESS": 0,
    "INVOKE_HOST_FUNCTION_MALFORMED": -1,
    "INVOKE_HOST_FUNCTION_TRAPPED": -2,
    "INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED": -3,
    "INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED": -4,
    "INVOKE_HOST_FUNCTION_INSUFFICIENT_REFUNDABLE_FEE": -5})
InvokeHostFunctionResult = _result_union(
    "InvokeHostFunctionResult", InvokeHostFunctionResultCode,
    {0: Hash}, [])

ExtendFootprintTTLResultCode = _codes("ExtendFootprintTTLResultCode", {
    "EXTEND_FOOTPRINT_TTL_SUCCESS": 0,
    "EXTEND_FOOTPRINT_TTL_MALFORMED": -1,
    "EXTEND_FOOTPRINT_TTL_RESOURCE_LIMIT_EXCEEDED": -2,
    "EXTEND_FOOTPRINT_TTL_INSUFFICIENT_REFUNDABLE_FEE": -3})
ExtendFootprintTTLResult = _result_union(
    "ExtendFootprintTTLResult", ExtendFootprintTTLResultCode, {}, [0])

RestoreFootprintResultCode = _codes("RestoreFootprintResultCode", {
    "RESTORE_FOOTPRINT_SUCCESS": 0,
    "RESTORE_FOOTPRINT_MALFORMED": -1,
    "RESTORE_FOOTPRINT_RESOURCE_LIMIT_EXCEEDED": -2,
    "RESTORE_FOOTPRINT_INSUFFICIENT_REFUNDABLE_FEE": -3})
RestoreFootprintResult = _result_union(
    "RestoreFootprintResult", RestoreFootprintResultCode, {}, [0])

# ---------------- operation result ----------------

from stellar_tpu_torch.xdr.tx import OperationType  # noqa: E402

OperationResultCode = _codes("OperationResultCode", {
    "opINNER": 0, "opBAD_AUTH": -1, "opNO_ACCOUNT": -2,
    "opNOT_SUPPORTED": -3, "opTOO_MANY_SUBENTRIES": -4,
    "opEXCEEDED_WORK_LIMIT": -5, "opTOO_MANY_SPONSORING": -6})

OperationInnerResult = Union("OperationResult.tr", OperationType, {
    OperationType.CREATE_ACCOUNT: CreateAccountResult,
    OperationType.PAYMENT: PaymentResult,
    OperationType.PATH_PAYMENT_STRICT_RECEIVE:
        PathPaymentStrictReceiveResult,
    OperationType.MANAGE_SELL_OFFER: ManageSellOfferResult,
    OperationType.CREATE_PASSIVE_SELL_OFFER: ManageSellOfferResult,
    OperationType.SET_OPTIONS: SetOptionsResult,
    OperationType.CHANGE_TRUST: ChangeTrustResult,
    OperationType.ALLOW_TRUST: AllowTrustResult,
    OperationType.ACCOUNT_MERGE: AccountMergeResult,
    OperationType.INFLATION: InflationResult,
    OperationType.MANAGE_DATA: ManageDataResult,
    OperationType.BUMP_SEQUENCE: BumpSequenceResult,
    OperationType.MANAGE_BUY_OFFER: ManageBuyOfferResult,
    OperationType.PATH_PAYMENT_STRICT_SEND: PathPaymentStrictSendResult,
    OperationType.CREATE_CLAIMABLE_BALANCE: CreateClaimableBalanceResult,
    OperationType.CLAIM_CLAIMABLE_BALANCE: ClaimClaimableBalanceResult,
    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
        BeginSponsoringFutureReservesResult,
    OperationType.END_SPONSORING_FUTURE_RESERVES:
        EndSponsoringFutureReservesResult,
    OperationType.REVOKE_SPONSORSHIP: RevokeSponsorshipResult,
    OperationType.CLAWBACK: ClawbackResult,
    OperationType.CLAWBACK_CLAIMABLE_BALANCE:
        ClawbackClaimableBalanceResult,
    OperationType.SET_TRUST_LINE_FLAGS: SetTrustLineFlagsResult,
    OperationType.LIQUIDITY_POOL_DEPOSIT: LiquidityPoolDepositResult,
    OperationType.LIQUIDITY_POOL_WITHDRAW: LiquidityPoolWithdrawResult,
    OperationType.INVOKE_HOST_FUNCTION: InvokeHostFunctionResult,
    OperationType.EXTEND_FOOTPRINT_TTL: ExtendFootprintTTLResult,
    OperationType.RESTORE_FOOTPRINT: RestoreFootprintResult,
})

OperationResult = Union("OperationResult", OperationResultCode, {
    OperationResultCode.opINNER: OperationInnerResult,
}, default=Void)

# ---------------- transaction result ----------------

TransactionResultCode = _codes("TransactionResultCode", {
    "txFEE_BUMP_INNER_SUCCESS": 1, "txSUCCESS": 0, "txFAILED": -1,
    "txTOO_EARLY": -2, "txTOO_LATE": -3, "txMISSING_OPERATION": -4,
    "txBAD_SEQ": -5, "txBAD_AUTH": -6, "txINSUFFICIENT_BALANCE": -7,
    "txNO_ACCOUNT": -8, "txINSUFFICIENT_FEE": -9, "txBAD_AUTH_EXTRA": -10,
    "txINTERNAL_ERROR": -11, "txNOT_SUPPORTED": -12,
    "txFEE_BUMP_INNER_FAILED": -13, "txBAD_SPONSORSHIP": -14,
    "txBAD_MIN_SEQ_AGE_OR_GAP": -15, "txMALFORMED": -16,
    "txSOROBAN_INVALID": -17})


class InnerTransactionResult(Struct):
    # feeCharged is always 0 in the inner result per protocol
    FIELDS = [("feeCharged", Int64),
              ("result", Union("InnerTransactionResult.result",
                               TransactionResultCode, {
                                   TransactionResultCode.txSUCCESS:
                                       VarArray(OperationResult),
                                   TransactionResultCode.txFAILED:
                                       VarArray(OperationResult),
                               }, default=Void)),
              ("ext", Union("InnerTransactionResult.ext", Int32,
                            {0: Void}))]


class InnerTransactionResultPair(Struct):
    FIELDS = [("transactionHash", Hash),
              ("result", InnerTransactionResult)]


_TxResultResult = Union("TransactionResult.result", TransactionResultCode, {
    TransactionResultCode.txFEE_BUMP_INNER_SUCCESS:
        InnerTransactionResultPair,
    TransactionResultCode.txFEE_BUMP_INNER_FAILED:
        InnerTransactionResultPair,
    TransactionResultCode.txSUCCESS: VarArray(OperationResult),
    TransactionResultCode.txFAILED: VarArray(OperationResult),
}, default=Void)


class TransactionResult(Struct):
    FIELDS = [("feeCharged", Int64),
              ("result", _TxResultResult),
              ("ext", Union("TransactionResult.ext", Int32, {0: Void}))]


class TransactionResultPair(Struct):
    FIELDS = [("transactionHash", Hash), ("result", TransactionResult)]


class TransactionResultSet(Struct):
    FIELDS = [("results", VarArray(TransactionResultPair))]


def op_success(op_type: int, inner) -> "Union.Value":
    """Wrap a per-op success payload into an OperationResult."""
    return OperationResult.make(
        OperationResultCode.opINNER,
        OperationInnerResult.make(op_type, inner))


def tx_success(op_results) -> TransactionResult:
    return TransactionResult(
        feeCharged=0,
        result=_TxResultResult.make(TransactionResultCode.txSUCCESS,
                                    list(op_results)),
        ext=TransactionResult._types[2].make(0))


def tx_result(code: int, op_results=None, fee_charged: int = 0):
    if code in (TransactionResultCode.txSUCCESS,
                TransactionResultCode.txFAILED):
        payload = list(op_results or [])
    elif code in (TransactionResultCode.txFEE_BUMP_INNER_SUCCESS,
                  TransactionResultCode.txFEE_BUMP_INNER_FAILED):
        payload = op_results
    else:
        payload = None
    return TransactionResult(
        feeCharged=fee_charged,
        result=_TxResultResult.make(code, payload),
        ext=TransactionResult._types[2].make(0))
