"""SetOptions + AccountMerge (reference ``SetOptionsOpFrame.cpp``,
``MergeOpFrame.cpp``).

The port's copy of ``stellar_tpu/tx/ops/account_ops.py``, with the
port's imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx.account_utils import (
    account_ext_v2, add_balance, get_starting_sequence_number,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, ThresholdLevel, account_key, register_op,
)
from stellar_tpu_torch.tx.signature_utils import does_hint_match
from stellar_tpu_torch.xdr.results import (
    AccountMergeResultCode, SetOptionsResultCode,
)
from stellar_tpu_torch.xdr.tx import OperationType, muxed_to_account_id
from stellar_tpu_torch.xdr.types import (
    AUTH_CLAWBACK_ENABLED_FLAG, AUTH_IMMUTABLE_FLAG, AUTH_REQUIRED_FLAG,
    AUTH_REVOCABLE_FLAG, MASK_ACCOUNT_FLAGS_V17, MAX_SIGNERS,
    SignerKeyType,
)

UINT8_MAX = 255
ALL_AUTH_FLAGS = (AUTH_REQUIRED_FLAG | AUTH_REVOCABLE_FLAG |
                  AUTH_IMMUTABLE_FLAG)


def is_immutable_auth(acc) -> bool:
    return bool(acc.flags & AUTH_IMMUTABLE_FLAG)


def is_auth_required(acc) -> bool:
    return bool(acc.flags & AUTH_REQUIRED_FLAG)


def is_auth_revocable(acc) -> bool:
    return bool(acc.flags & AUTH_REVOCABLE_FLAG)


def is_clawback_enabled(acc) -> bool:
    return bool(acc.flags & AUTH_CLAWBACK_ENABLED_FLAG)


def _clawback_flag_valid(flags: int) -> bool:
    """Clawback requires revocable (reference
    ``accountFlagClawbackIsValid``)."""
    if flags & AUTH_CLAWBACK_ENABLED_FLAG:
        return bool(flags & AUTH_REVOCABLE_FLAG)
    return True


def _is_string_valid(s: bytes) -> bool:
    return all(0x20 <= c <= 0x7E for c in s)


@register_op(OperationType.SET_OPTIONS)
class SetOptionsOpFrame(OperationFrame):

    def threshold_level(self) -> int:
        # touching thresholds or signers needs HIGH (reference
        # SetOptionsOpFrame::getThresholdLevel)
        o = self.body
        if (o.masterWeight is not None or o.lowThreshold is not None or
                o.medThreshold is not None or o.highThreshold is not None
                or o.signer is not None):
            return ThresholdLevel.HIGH
        return ThresholdLevel.MEDIUM

    def do_check_valid(self, ledger_version: int):
        Code = SetOptionsResultCode
        o = self.body
        for flags in (o.setFlags, o.clearFlags):
            if flags is not None and flags & ~MASK_ACCOUNT_FLAGS_V17:
                return False, self.make_result(
                    Code.SET_OPTIONS_UNKNOWN_FLAG)
        if o.setFlags is not None and o.clearFlags is not None and \
                o.setFlags & o.clearFlags:
            return False, self.make_result(Code.SET_OPTIONS_BAD_FLAGS)
        for th in (o.masterWeight, o.lowThreshold, o.medThreshold,
                   o.highThreshold):
            if th is not None and th > UINT8_MAX:
                return False, self.make_result(
                    Code.SET_OPTIONS_THRESHOLD_OUT_OF_RANGE)
        if o.signer is not None:
            key = o.signer.key
            src = self.source_account_id()
            if key.arm == SignerKeyType.SIGNER_KEY_TYPE_ED25519 and \
                    key.value == src.value:
                return False, self.make_result(
                    Code.SET_OPTIONS_BAD_SIGNER)
            if o.signer.weight > UINT8_MAX:
                return False, self.make_result(
                    Code.SET_OPTIONS_BAD_SIGNER)
            if key.arm == \
                    SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD \
                    and len(key.value.payload) == 0:
                return False, self.make_result(
                    Code.SET_OPTIONS_BAD_SIGNER)
        if o.homeDomain is not None and \
                not _is_string_valid(o.homeDomain):
            return False, self.make_result(
                Code.SET_OPTIONS_INVALID_HOME_DOMAIN)
        return True, None

    def do_apply(self, ltx):
        Code = SetOptionsResultCode
        o = self.body
        header = ltx.header()
        with ltx.load(account_key(self.source_account_id())) as src:
            acc = src.data
            if o.inflationDest is not None:
                if o.inflationDest != acc.accountID and \
                        not ltx.exists(account_key(o.inflationDest)):
                    return False, self.make_result(
                        Code.SET_OPTIONS_INVALID_INFLATION)
                acc.inflationDest = o.inflationDest
            for flags, setter in ((o.clearFlags, False),
                                  (o.setFlags, True)):
                if flags is None:
                    continue
                if flags & ALL_AUTH_FLAGS and is_immutable_auth(acc):
                    return False, self.make_result(
                        Code.SET_OPTIONS_CANT_CHANGE)
                acc.flags = (acc.flags | flags) if setter \
                    else (acc.flags & ~flags)
            if (o.setFlags is not None or o.clearFlags is not None) \
                    and not _clawback_flag_valid(acc.flags):
                return False, self.make_result(
                    Code.SET_OPTIONS_AUTH_REVOCABLE_REQUIRED)
            if o.homeDomain is not None:
                acc.homeDomain = o.homeDomain
            th = bytearray(acc.thresholds)
            if o.masterWeight is not None:
                th[0] = o.masterWeight & UINT8_MAX
            if o.lowThreshold is not None:
                th[1] = o.lowThreshold & UINT8_MAX
            if o.medThreshold is not None:
                th[2] = o.medThreshold & UINT8_MAX
            if o.highThreshold is not None:
                th[3] = o.highThreshold & UINT8_MAX
            acc.thresholds = bytes(th)
            if o.signer is not None:
                ok, fail = self._apply_signer(ltx, header, src.entry,
                                              o.signer)
                if not ok:
                    return False, fail
        return True, self.make_result(Code.SET_OPTIONS_SUCCESS)

    def _apply_signer(self, ltx, header, acc_le, signer):
        """Add / update / delete (weight 0) a signer with sponsorship
        accounting (reference ``addOrChangeSigner`` / ``deleteSigner``,
        SetOptionsOpFrame.cpp)."""
        from stellar_tpu_torch.tx.sponsorship import (
            SponsorshipResult, create_signer_with_possible_sponsorship,
            remove_signer_with_possible_sponsorship,
        )
        Code = SetOptionsResultCode
        acc = acc_le.data.value
        existing = [i for i, s in enumerate(acc.signers)
                    if s.key == signer.key]
        if signer.weight == 0:
            if existing:
                remove_signer_with_possible_sponsorship(
                    ltx, header, acc_le, existing[0])
            return True, None
        if existing:
            acc.signers[existing[0]].weight = signer.weight
            return True, None
        if len(acc.signers) >= MAX_SIGNERS:
            return False, self.make_result(
                Code.SET_OPTIONS_TOO_MANY_SIGNERS)
        # sorted insert keeps signers ordered by key encoding, with the
        # parallel signerSponsoringIDs slot inserted at the same index
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.types import SignerKey
        kb = to_bytes(SignerKey, signer.key)
        n = sum(1 for s in acc.signers
                if to_bytes(SignerKey, s.key) < kb)
        acc.signers.insert(n, signer)
        v2 = account_ext_v2(acc)
        if v2 is not None:
            v2.signerSponsoringIDs.insert(n, None)
        res = create_signer_with_possible_sponsorship(ltx, header,
                                                      acc_le, n)
        if res != SponsorshipResult.SUCCESS:
            del acc.signers[n]
            if v2 is not None:
                del v2.signerSponsoringIDs[n]
            return False, self.sponsorship_failure(
                res, Code.SET_OPTIONS_LOW_RESERVE)
        return True, None


@register_op(OperationType.ACCOUNT_MERGE)
class MergeOpFrame(OperationFrame):

    def threshold_level(self) -> int:
        return ThresholdLevel.HIGH

    def dest_id(self):
        return muxed_to_account_id(self.body)

    def do_check_valid(self, ledger_version: int):
        if self.dest_id() == self.source_account_id():
            return False, self.make_result(
                AccountMergeResultCode.ACCOUNT_MERGE_MALFORMED)
        return True, None

    def do_apply(self, outer):
        Code = AccountMergeResultCode
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            if not ltx.exists(account_key(self.dest_id())):
                return False, self.make_result(Code.ACCOUNT_MERGE_NO_ACCOUNT)
            src_handle = ltx.load(account_key(self.source_account_id()))
            acc = src_handle.data
            balance = acc.balance
            if is_immutable_auth(acc):
                src_handle.deactivate()
                return False, self.make_result(
                    Code.ACCOUNT_MERGE_IMMUTABLE_SET)
            if acc.numSubEntries != len(acc.signers):
                src_handle.deactivate()
                return False, self.make_result(
                    Code.ACCOUNT_MERGE_HAS_SUB_ENTRIES)
            # can't merge if the account could re-appear with a reusable
            # seq num (reference isSeqnumTooFar)
            if acc.seqNum >= get_starting_sequence_number(header.ledgerSeq):
                src_handle.deactivate()
                return False, self.make_result(
                    Code.ACCOUNT_MERGE_SEQNUM_TOO_FAR)
            # an account may not merge while it sponsors anything (active
            # directive or recorded reserves); being sponsored is fine —
            # signer and entry sponsorships release below (reference
            # MergeOpFrame.cpp:226-256)
            from stellar_tpu_torch.tx.sponsorship import (
                load_sponsorship_counter,
                remove_entry_with_possible_sponsorship,
                remove_signer_with_possible_sponsorship,
            )
            v2 = account_ext_v2(acc)
            if load_sponsorship_counter(
                    ltx, self.source_account_id()) is not None or \
                    (v2 is not None and v2.numSponsoring != 0):
                src_handle.deactivate()
                return False, self.make_result(
                    Code.ACCOUNT_MERGE_IS_SPONSOR)
            while acc.signers:
                remove_signer_with_possible_sponsorship(
                    ltx, header, src_handle.entry, len(acc.signers) - 1)
            src_le = src_handle.entry
            src_handle.deactivate()
            remove_entry_with_possible_sponsorship(ltx, header, src_le,
                                                   src_le)

            with ltx.load(account_key(self.dest_id())) as dest:
                if not add_balance(header, dest.entry, balance):
                    ltx.rollback()
                    return False, self.make_result(
                        Code.ACCOUNT_MERGE_DEST_FULL)
            ltx.erase(account_key(self.source_account_id()))
            ltx.commit()
        return True, self.make_result(Code.ACCOUNT_MERGE_SUCCESS, balance)
