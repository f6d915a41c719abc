"""Sponsorship operations: BeginSponsoringFutureReserves,
EndSponsoringFutureReserves, RevokeSponsorship (reference
``src/transactions/BeginSponsoringFutureReservesOpFrame.cpp``,
``EndSponsoringFutureReservesOpFrame.cpp``, ``RevokeSponsorshipOpFrame.cpp``).

Begin/End bracket a run of operations whose reserves the sponsor pays;
the directive itself is a tx-scoped internal LedgerTxn entry (see
``stellar_tpu_torch/tx/sponsorship.py``). Revoke removes or transfers the
sponsorship of one existing ledger entry or signer.

The port's copy of ``stellar_tpu/tx/ops/sponsorship_ops.py``, with the
port's imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, LedgerTxnError
from stellar_tpu_torch.tx import sponsorship as sp
from stellar_tpu_torch.tx.asset_utils import get_issuer, is_asset_valid
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, account_key, register_op,
)
from stellar_tpu_torch.xdr.results import (
    BeginSponsoringFutureReservesResultCode as BeginCode,
    EndSponsoringFutureReservesResultCode as EndCode,
    OperationResultCode, RevokeSponsorshipResultCode as RevokeCode,
)
from stellar_tpu_torch.xdr.tx import OperationType, RevokeSponsorshipType
from stellar_tpu_torch.xdr.types import (
    AssetType, LedgerEntryType, account_ed25519, account_id,
)


@register_op(OperationType.BEGIN_SPONSORING_FUTURE_RESERVES)
class BeginSponsoringFutureReservesOpFrame(OperationFrame):
    """Reference ``BeginSponsoringFutureReservesOpFrame.cpp``."""

    def do_check_valid(self, ledger_version: int):
        if self.body.sponsoredID == self.source_account_id():
            return False, self.make_result(
                BeginCode.BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED)
        return True, None

    def do_apply(self, ltx):
        source = self.source_account_id()
        sponsored = self.body.sponsoredID
        if sp.load_sponsorship(ltx, sponsored) is not None:
            return False, self.make_result(
                BeginCode.BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED)
        # No chains: the sponsor must not itself be sponsored, and the
        # sponsored account must not be sponsoring anyone.
        if sp.load_sponsorship(ltx, source) is not None or \
                sp.load_sponsorship_counter(ltx, sponsored) is not None:
            return False, self.make_result(
                BeginCode.BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE)

        ltx.set_internal(sp.sponsorship_key(sponsored),
                         account_ed25519(source))
        ck = sp.sponsorship_counter_key(source)
        ltx.set_internal(ck, (sp.load_sponsorship_counter(ltx, source) or 0)
                         + 1)
        return True, self.make_result(
            BeginCode.BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS)


@register_op(OperationType.END_SPONSORING_FUTURE_RESERVES)
class EndSponsoringFutureReservesOpFrame(OperationFrame):
    """Reference ``EndSponsoringFutureReservesOpFrame.cpp``. Note the
    *source* of this op is the sponsored account."""

    def do_check_valid(self, ledger_version: int):
        return True, None

    def do_apply(self, ltx):
        source = self.source_account_id()
        sponsoring_raw = sp.load_sponsorship(ltx, source)
        if sponsoring_raw is None:
            return False, self.make_result(
                EndCode.END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED)
        sponsoring = account_id(sponsoring_raw)
        count = sp.load_sponsorship_counter(ltx, sponsoring)
        if not count:
            raise LedgerTxnError("no sponsorship counter")
        ck = sp.sponsorship_counter_key(sponsoring)
        ltx.set_internal(ck, count - 1 if count > 1 else None)
        ltx.set_internal(sp.sponsorship_key(source), None)
        return True, self.make_result(
            EndCode.END_SPONSORING_FUTURE_RESERVES_SUCCESS)


def _owner_account_id(le):
    """The account whose reserve an entry consumes (reference
    ``getAccountID`` in RevokeSponsorshipOpFrame.cpp). For claimable
    balances this is the current sponsor."""
    t = le.data.arm
    v = le.data.value
    if t == LedgerEntryType.ACCOUNT:
        return v.accountID
    if t == LedgerEntryType.TRUSTLINE:
        return v.accountID
    if t == LedgerEntryType.OFFER:
        return v.sellerID
    if t == LedgerEntryType.DATA:
        return v.accountID
    if t == LedgerEntryType.CLAIMABLE_BALANCE:
        return le.ext.value.sponsoringID
    raise LedgerTxnError("invalid key type")


@register_op(OperationType.REVOKE_SPONSORSHIP)
class RevokeSponsorshipOpFrame(OperationFrame):
    """Reference ``RevokeSponsorshipOpFrame.cpp``."""

    def do_check_valid(self, ledger_version: int):
        if self.operation.body.value.arm != \
                RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
            return True, None
        lk = self.operation.body.value.value
        t = lk.arm
        if t == LedgerEntryType.TRUSTLINE:
            tl = lk.value
            asset = tl.asset
            bad = (asset.arm == AssetType.ASSET_TYPE_NATIVE)
            if not bad and asset.arm in (
                    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12):
                bad = (not is_asset_valid(asset, ledger_version) or
                       get_issuer(asset) == tl.accountID)
            if bad:
                return False, self.make_result(
                    RevokeCode.REVOKE_SPONSORSHIP_MALFORMED)
        elif t == LedgerEntryType.OFFER:
            if lk.value.offerID <= 0:
                return False, self.make_result(
                    RevokeCode.REVOKE_SPONSORSHIP_MALFORMED)
        elif t == LedgerEntryType.DATA:
            name = lk.value.dataName
            if len(name) < 1:
                return False, self.make_result(
                    RevokeCode.REVOKE_SPONSORSHIP_MALFORMED)
        elif t not in (LedgerEntryType.ACCOUNT,
                       LedgerEntryType.CLAIMABLE_BALANCE):
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_MALFORMED)
        return True, None

    def _sponsorship_failure(self, res: int):
        """Map a SponsorshipResult to the op failure (reference
        ``processSponsorshipResult``)."""
        if res == sp.SponsorshipResult.LOW_RESERVE:
            return self.make_result(RevokeCode.REVOKE_SPONSORSHIP_LOW_RESERVE)
        if res == sp.SponsorshipResult.TOO_MANY_SPONSORING:
            return self.make_top_result(
                OperationResultCode.opTOO_MANY_SPONSORING)
        raise LedgerTxnError("unexpected sponsorship result")

    def do_apply(self, outer):
        with LedgerTxn(outer) as ltx:
            body = self.operation.body.value
            if body.arm == \
                    RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
                ok, res = self._update_entry(ltx, body.value)
            else:
                ok, res = self._update_signer(ltx, body.value)
            if ok:
                ltx.commit()
            return ok, res

    # ---------------- ledger-entry arm ----------------

    def _update_entry(self, ltx, lk):
        source = self.source_account_id()
        h = ltx.load(lk)
        if h is None:
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        le = h.entry
        sponsoring = sp.get_sponsoring_id(le)
        was_sponsored = sponsoring is not None
        if was_sponsored:
            if sponsoring != source:
                return False, self.make_result(
                    RevokeCode.REVOKE_SPONSORSHIP_NOT_SPONSOR)
        elif _owner_account_id(le) != source:
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_NOT_SPONSOR)

        # SponsoringFutureReserves(source)=<none> -> entry reverts to owner
        # SponsoringFutureReserves(source)=owner  -> entry reverts to owner
        # SponsoringFutureReserves(source)=C!=owner -> transfer to C
        will_be_sponsored = False
        new_sponsor_raw = sp.load_sponsorship(ltx, source)
        if new_sponsor_raw is not None and \
                account_id(new_sponsor_raw) != _owner_account_id(le):
            will_be_sponsored = True

        if not will_be_sponsored and \
                le.data.arm == LedgerEntryType.CLAIMABLE_BALANCE:
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE)

        header = ltx.header()
        h.deactivate()  # helpers reload accounts; avoid exclusivity clash
        is_account = le.data.arm == LedgerEntryType.ACCOUNT

        if was_sponsored and will_be_sponsored:
            with ltx.load(account_key(sponsoring)) as old_sp, \
                    ltx.load(account_key(account_id(new_sponsor_raw))) \
                    as new_sp:
                res = sp.can_transfer_entry_sponsorship(
                    header, le, old_sp.entry, new_sp.entry)
                if res != sp.SponsorshipResult.SUCCESS:
                    return False, self._sponsorship_failure(res)
                sp.transfer_entry_sponsorship(le, old_sp.entry, new_sp.entry)
        elif was_sponsored:
            with ltx.load(account_key(sponsoring)) as old_sp:
                if is_account:
                    sponsored_le = le
                    res = sp.can_remove_entry_sponsorship(
                        header, le, old_sp.entry, sponsored_le)
                    if res != sp.SponsorshipResult.SUCCESS:
                        return False, self._sponsorship_failure(res)
                    sp.remove_entry_sponsorship(le, old_sp.entry,
                                                sponsored_le)
                else:
                    with ltx.load(account_key(_owner_account_id(le))) as ow:
                        res = sp.can_remove_entry_sponsorship(
                            header, le, old_sp.entry, ow.entry)
                        if res != sp.SponsorshipResult.SUCCESS:
                            return False, self._sponsorship_failure(res)
                        sp.remove_entry_sponsorship(le, old_sp.entry,
                                                    ow.entry)
        elif will_be_sponsored:
            with ltx.load(account_key(account_id(new_sponsor_raw))) \
                    as new_sp:
                if is_account:
                    res = sp.can_establish_entry_sponsorship(
                        header, le, new_sp.entry, le)
                    if res != sp.SponsorshipResult.SUCCESS:
                        return False, self._sponsorship_failure(res)
                    sp.establish_entry_sponsorship(le, new_sp.entry, le)
                else:
                    with ltx.load(account_key(_owner_account_id(le))) as ow:
                        res = sp.can_establish_entry_sponsorship(
                            header, le, new_sp.entry, ow.entry)
                        if res != sp.SponsorshipResult.SUCCESS:
                            return False, self._sponsorship_failure(res)
                        sp.establish_entry_sponsorship(le, new_sp.entry,
                                                       ow.entry)
        # else: neither sponsored before nor after — no-op

        return True, self.make_result(RevokeCode.REVOKE_SPONSORSHIP_SUCCESS)

    # ---------------- signer arm ----------------

    def _update_signer(self, ltx, signer_body):
        source = self.source_account_id()
        target = signer_body.accountID
        h = ltx.load(account_key(target))
        if h is None:
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        acc_le = h.entry
        acc = acc_le.data.value
        matches = [i for i, s in enumerate(acc.signers)
                   if s.key == signer_body.signerKey]
        if not matches:
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        index = matches[0]

        sid = sp._signer_sponsoring_id(acc, index)
        was_sponsored = sid is not None
        if was_sponsored:
            if sid != source:
                return False, self.make_result(
                    RevokeCode.REVOKE_SPONSORSHIP_NOT_SPONSOR)
        elif target != source:
            return False, self.make_result(
                RevokeCode.REVOKE_SPONSORSHIP_NOT_SPONSOR)

        will_be_sponsored = False
        new_sponsor_raw = sp.load_sponsorship(ltx, source)
        if new_sponsor_raw is not None and \
                account_id(new_sponsor_raw) != target:
            will_be_sponsored = True

        header = ltx.header()
        if was_sponsored and will_be_sponsored:
            with ltx.load(account_key(sid)) as old_sp, \
                    ltx.load(account_key(account_id(new_sponsor_raw))) \
                    as new_sp:
                res = sp.can_transfer_signer_sponsorship(
                    header, index, old_sp.entry, new_sp.entry, acc_le)
                if res != sp.SponsorshipResult.SUCCESS:
                    return False, self._sponsorship_failure(res)
                sp.transfer_signer_sponsorship(index, old_sp.entry,
                                               new_sp.entry, acc_le)
        elif was_sponsored:
            with ltx.load(account_key(sid)) as old_sp:
                res = sp.can_remove_signer_sponsorship(
                    header, index, old_sp.entry, acc_le)
                if res != sp.SponsorshipResult.SUCCESS:
                    return False, self._sponsorship_failure(res)
                sp.remove_signer_sponsorship(index, old_sp.entry, acc_le)
        elif will_be_sponsored:
            with ltx.load(account_key(account_id(new_sponsor_raw))) \
                    as new_sp:
                res = sp.can_establish_signer_sponsorship(
                    header, index, new_sp.entry, acc_le)
                if res != sp.SponsorshipResult.SUCCESS:
                    return False, self._sponsorship_failure(res)
                sp.establish_signer_sponsorship(index, new_sp.entry, acc_le)
        # else: no-op

        return True, self.make_result(RevokeCode.REVOKE_SPONSORSHIP_SUCCESS)
