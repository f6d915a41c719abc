"""Claimable balances + clawbacks + inflation (reference
``CreateClaimableBalanceOpFrame.cpp``, ``ClaimClaimableBalanceOpFrame
.cpp``, ``ClawbackOpFrame.cpp``, ``ClawbackClaimableBalanceOpFrame.cpp``,
``InflationOpFrame.cpp``).

The port's copy of ``stellar_tpu/tx/ops/claimable_balances.py``, with
the port's imports.
"""

from __future__ import annotations

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx.account_utils import (
    add_balance, get_available_balance,
)
from stellar_tpu_torch.tx.asset_utils import (
    get_issuer, is_asset_valid, is_native, trustline_key,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, ThresholdLevel, account_key, register_op,
)
from stellar_tpu_torch.tx.ops.account_ops import is_clawback_enabled
from stellar_tpu_torch.tx.sponsorship import (
    SponsorshipResult, create_entry_with_possible_sponsorship,
    remove_entry_with_possible_sponsorship,
)
from stellar_tpu_torch.xdr.results import (
    ClaimClaimableBalanceResultCode, ClawbackClaimableBalanceResultCode,
    ClawbackResultCode, CreateClaimableBalanceResultCode,
    InflationResultCode,
)
from stellar_tpu_torch.xdr.runtime import Packer, to_bytes
from stellar_tpu_torch.xdr.tx import OperationType, muxed_to_account_id
from stellar_tpu_torch.xdr.types import (
    CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG, ClaimPredicate,
    ClaimPredicateType, ClaimableBalanceEntry, ClaimableBalanceID,
    ClaimableBalanceIDType, EnvelopeType, LedgerEntry, LedgerEntryType,
    LedgerKey, LedgerKeyClaimableBalance, TRUSTLINE_CLAWBACK_ENABLED_FLAG,
)

CBCode = CreateClaimableBalanceResultCode
ClaimCode = ClaimClaimableBalanceResultCode
PT = ClaimPredicateType


def claimable_balance_key(balance_id) -> "LedgerKey.Value":
    return LedgerKey.make(
        LedgerEntryType.CLAIMABLE_BALANCE,
        LedgerKeyClaimableBalance(balanceID=balance_id))


def operation_balance_id(tx_source_id, seq_num: int, op_index: int) -> bytes:
    """SHA-256 of HashIDPreimage{ENVELOPE_TYPE_OP_ID, operationID}
    (reference ``getBalanceID``)."""
    p = Packer()
    p.pack_int(EnvelopeType.ENVELOPE_TYPE_OP_ID)
    from stellar_tpu_torch.xdr.types import PublicKey
    PublicKey.pack(p, tx_source_id)
    p.pack_hyper(seq_num)
    p.pack_uint(op_index)
    return sha256(p.bytes())


def validate_predicate(pred, depth: int = 1) -> bool:
    """Reference ``validatePredicate``: depth <= 4, binary and/or,
    non-null not, non-negative times."""
    if depth > 4:
        return False
    t, v = pred.arm, pred.value
    if t == PT.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if t in (PT.CLAIM_PREDICATE_AND, PT.CLAIM_PREDICATE_OR):
        return len(v) == 2 and all(
            validate_predicate(x, depth + 1) for x in v)
    if t == PT.CLAIM_PREDICATE_NOT:
        return v is not None and validate_predicate(v, depth + 1)
    if t in (PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME,
             PT.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME):
        return v >= 0
    return False


def predicate_satisfied(pred, close_time: int) -> bool:
    """Evaluate against the closing ledger's time (relative predicates
    were converted to absolute at create; reference
    ``ClaimableBalanceIsClaimableUtils``)."""
    t, v = pred.arm, pred.value
    if t == PT.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if t == PT.CLAIM_PREDICATE_AND:
        return all(predicate_satisfied(x, close_time) for x in v)
    if t == PT.CLAIM_PREDICATE_OR:
        return any(predicate_satisfied(x, close_time) for x in v)
    if t == PT.CLAIM_PREDICATE_NOT:
        return not predicate_satisfied(v, close_time)
    if t == PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return close_time < v
    raise ValueError("relative predicate must be absolute by apply time")


def _to_absolute(pred, close_time: int):
    """Convert BEFORE_RELATIVE_TIME to absolute at create time
    (reference ``updatePredicatesForApply``)."""
    t, v = pred.arm, pred.value
    if t in (PT.CLAIM_PREDICATE_AND, PT.CLAIM_PREDICATE_OR):
        return ClaimPredicate.make(t, [_to_absolute(x, close_time)
                                       for x in v])
    if t == PT.CLAIM_PREDICATE_NOT:
        return ClaimPredicate.make(t, _to_absolute(v, close_time))
    if t == PT.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        INT64_MAX = 0x7FFFFFFFFFFFFFFF
        absolute = min(close_time + v, INT64_MAX)
        return ClaimPredicate.make(
            PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME, absolute)
    return pred


@register_op(OperationType.CREATE_CLAIMABLE_BALANCE)
class CreateClaimableBalanceOpFrame(OperationFrame):

    def do_check_valid(self, ledger_version: int):
        b = self.body
        if not is_asset_valid(b.asset, ledger_version) or \
                b.amount <= 0 or not b.claimants:
            return False, self.make_result(
                CBCode.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        dests = set()
        for c in b.claimants:
            dkey = c.value.destination.value
            if dkey in dests:
                return False, self.make_result(
                    CBCode.CREATE_CLAIMABLE_BALANCE_MALFORMED)
            dests.add(dkey)
            if not validate_predicate(c.value.predicate):
                return False, self.make_result(
                    CBCode.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        return True, None

    def do_apply(self, outer):
        b = self.body
        src_id = self.source_account_id()
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            balance_id = ClaimableBalanceID.make(
                ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
                operation_balance_id(
                    self.parent_tx.source_account_id(),
                    self.parent_tx.seq_num, self.index))
            from stellar_tpu_torch.xdr.types import Claimant, ClaimantV0
            claimants = [
                Claimant.make(0, ClaimantV0(
                    destination=c.value.destination,
                    predicate=_to_absolute(c.value.predicate,
                                           header.scpValue.closeTime)))
                for c in b.claimants]
            flags = 0
            if not is_native(b.asset):
                issuer = ltx.load_without_record(
                    account_key(get_issuer(b.asset)))
                if issuer is not None and \
                        is_clawback_enabled(issuer.data.value):
                    flags = CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG
            cb_entry = ClaimableBalanceEntry(
                balanceID=balance_id, claimants=claimants, asset=b.asset,
                amount=b.amount, ext=_cb_ext(flags))
            le = LedgerEntry(
                lastModifiedLedgerSeq=header.ledgerSeq,
                data=LedgerEntry._types[1].make(
                    LedgerEntryType.CLAIMABLE_BALANCE, cb_entry),
                ext=LedgerEntry._types[2].make(0))
            # reserve: claimants.size() * baseReserve charged to the
            # active sponsor, else self-sponsored by the source
            # (claimable balances always record a sponsor)
            with ltx.load(account_key(src_id)) as src:
                res = create_entry_with_possible_sponsorship(
                    ltx, header, le, src.entry)
            if res != SponsorshipResult.SUCCESS:
                ltx.rollback()
                return False, self.sponsorship_failure(
                    res, CBCode.CREATE_CLAIMABLE_BALANCE_LOW_RESERVE)

            # move the amount out of the source
            if is_native(b.asset):
                with ltx.load(account_key(src_id)) as src:
                    if get_available_balance(header, src.entry) < b.amount:
                        ltx.rollback()
                        return False, self.make_result(
                            CBCode.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
                    ok = add_balance(header, src.entry, -b.amount)
                    assert ok
            elif get_issuer(b.asset) != src_id:
                h = ltx.load(trustline_key(src_id, b.asset))
                if h is None:
                    ltx.rollback()
                    return False, self.make_result(
                        CBCode.CREATE_CLAIMABLE_BALANCE_NO_TRUST)
                with h:
                    from stellar_tpu_torch.tx.account_utils import (
                        is_authorized,
                    )
                    if not is_authorized(h.data):
                        ltx.rollback()
                        return False, self.make_result(
                            CBCode.CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
                    if not add_balance(header, h.entry, -b.amount):
                        ltx.rollback()
                        return False, self.make_result(
                            CBCode.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)

            ltx.create(le).deactivate()
            ltx.commit()
        return True, self.make_result(
            CBCode.CREATE_CLAIMABLE_BALANCE_SUCCESS, balance_id)


def _cb_ext(flags: int):
    from stellar_tpu_torch.xdr.types import (
        ClaimableBalanceEntry, ClaimableBalanceEntryExtensionV1,
    )
    if flags == 0:
        return ClaimableBalanceEntry._types[4].make(0)
    v1 = ClaimableBalanceEntryExtensionV1(
        ext=ClaimableBalanceEntryExtensionV1._types[0].make(0),
        flags=flags)
    return ClaimableBalanceEntry._types[4].make(1, v1)


@register_op(OperationType.CLAIM_CLAIMABLE_BALANCE)
class ClaimClaimableBalanceOpFrame(OperationFrame):

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    def do_check_valid(self, ledger_version: int):
        return True, None

    def do_apply(self, outer):
        src_id = self.source_account_id()
        key = claimable_balance_key(self.body.balanceID)
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            entry = ltx.load_without_record(key)
            if entry is None:
                return False, self.make_result(
                    ClaimCode.CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
            cb = entry.data.value
            claimant = next(
                (c for c in cb.claimants
                 if c.value.destination == src_id), None)
            if claimant is None or not predicate_satisfied(
                    claimant.value.predicate, header.scpValue.closeTime):
                return False, self.make_result(
                    ClaimCode.CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM)
            # credit the claimant
            if is_native(cb.asset):
                with ltx.load(account_key(src_id)) as h:
                    if not add_balance(header, h.entry, cb.amount):
                        ltx.rollback()
                        return False, self.make_result(
                            ClaimCode.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
            elif get_issuer(cb.asset) != src_id:
                h = ltx.load(trustline_key(src_id, cb.asset))
                if h is None:
                    return False, self.make_result(
                        ClaimCode.CLAIM_CLAIMABLE_BALANCE_NO_TRUST)
                with h:
                    from stellar_tpu_torch.tx.account_utils import (
                        is_authorized,
                    )
                    if not is_authorized(h.data):
                        return False, self.make_result(
                            ClaimCode
                            .CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
                    if not add_balance(header, h.entry, cb.amount):
                        ltx.rollback()
                        return False, self.make_result(
                            ClaimCode.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
            with ltx.load(account_key(src_id)) as src:
                remove_entry_with_possible_sponsorship(
                    ltx, header, entry, src.entry)
            ltx.erase(key)
            ltx.commit()
        return True, self.make_result(
            ClaimCode.CLAIM_CLAIMABLE_BALANCE_SUCCESS)


@register_op(OperationType.CLAWBACK)
class ClawbackOpFrame(OperationFrame):

    def do_check_valid(self, ledger_version: int):
        b = self.body
        if not is_asset_valid(b.asset, ledger_version) or \
                is_native(b.asset) or b.amount <= 0:
            return False, self.make_result(
                ClawbackResultCode.CLAWBACK_MALFORMED)
        if get_issuer(b.asset) != self.source_account_id():
            return False, self.make_result(
                ClawbackResultCode.CLAWBACK_MALFORMED)
        return True, None

    def do_apply(self, ltx):
        Code = ClawbackResultCode
        b = self.body
        from_id = muxed_to_account_id(b.from_)
        h = ltx.load(trustline_key(from_id, b.asset))
        if h is None:
            return False, self.make_result(Code.CLAWBACK_NO_TRUST)
        with h:
            tl = h.data
            if not (tl.flags & TRUSTLINE_CLAWBACK_ENABLED_FLAG):
                return False, self.make_result(
                    Code.CLAWBACK_NOT_CLAWBACK_ENABLED)
            from stellar_tpu_torch.tx.account_utils import (
                get_selling_liabilities,
            )
            if tl.balance - get_selling_liabilities(h.entry) < b.amount:
                return False, self.make_result(Code.CLAWBACK_UNDERFUNDED)
            tl.balance -= b.amount  # burned
        return True, self.make_result(Code.CLAWBACK_SUCCESS)


@register_op(OperationType.CLAWBACK_CLAIMABLE_BALANCE)
class ClawbackClaimableBalanceOpFrame(OperationFrame):

    def do_check_valid(self, ledger_version: int):
        return True, None

    def do_apply(self, outer):
        Code = ClawbackClaimableBalanceResultCode
        key = claimable_balance_key(self.body.balanceID)
        with LedgerTxn(outer) as ltx:
            entry = ltx.load_without_record(key)
            if entry is None:
                return False, self.make_result(
                    Code.CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
            cb = entry.data.value
            if is_native(cb.asset) or \
                    get_issuer(cb.asset) != self.source_account_id():
                return False, self.make_result(
                    Code.CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER)
            flags = cb.ext.value.flags if cb.ext.arm == 1 else 0
            if not (flags & CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG):
                return False, self.make_result(
                    Code.CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED)
            with ltx.load(account_key(self.source_account_id())) as src:
                remove_entry_with_possible_sponsorship(
                    ltx, ltx.header(), entry, src.entry)
            ltx.erase(key)  # amount burned with the entry
            ltx.commit()
        return True, self.make_result(
            Code.CLAWBACK_CLAIMABLE_BALANCE_SUCCESS)


INFLATION_FREQUENCY = 7 * 24 * 60 * 60  # seconds (reference)
INFLATION_START_TIME = 1404172800  # 2014-07-01, reference Inflation.cpp


@register_op(OperationType.INFLATION)
class InflationOpFrame(OperationFrame):

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    def do_check_valid(self, ledger_version: int):
        return True, None

    def do_apply(self, ltx):
        """Modern-protocol inflation: the op still runs on schedule but
        pays nothing (mechanism retired in protocol 12; reference
        InflationOpFrame keeps only the NOT_TIME check + empty payout)."""
        with ltx.load_header() as hh:
            header = hh.header
            close_time = header.scpValue.closeTime
            due = INFLATION_START_TIME + \
                INFLATION_FREQUENCY * (header.inflationSeq + 1)
            if close_time < due:
                return False, self.make_result(
                    InflationResultCode.INFLATION_NOT_TIME)
            header.inflationSeq += 1
        return True, self.make_result(
            InflationResultCode.INFLATION_SUCCESS, [])
