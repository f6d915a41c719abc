"""CreateAccount (reference ``src/transactions/CreateAccountOpFrame.cpp``,
``doApplyFromV14`` path: reserve charged via possible sponsorship).

The port's copy of ``stellar_tpu/tx/ops/create_account.py``, with the
port's imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx.account_utils import (
    add_balance, get_available_balance, get_starting_sequence_number,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, account_key, register_op,
)
from stellar_tpu_torch.tx.sponsorship import (
    SponsorshipResult, create_entry_with_possible_sponsorship,
)
from stellar_tpu_torch.xdr.results import (
    CreateAccountResultCode as Code, OperationResultCode,
)
from stellar_tpu_torch.xdr.tx import OperationType
from stellar_tpu_torch.xdr.types import (
    AccountEntry, LedgerEntry, LedgerEntryType, _AccountEntryExt,
)


def new_account_entry(account_id, balance: int, seq_num: int,
                      last_modified: int = 0) -> LedgerEntry:
    acc = AccountEntry(
        accountID=account_id, balance=balance, seqNum=seq_num,
        numSubEntries=0, inflationDest=None, flags=0, homeDomain=b"",
        thresholds=b"\x01\x00\x00\x00", signers=[],
        ext=_AccountEntryExt.make(0))
    return LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=LedgerEntry._types[1].make(LedgerEntryType.ACCOUNT, acc),
        ext=LedgerEntry._types[2].make(0))


@register_op(OperationType.CREATE_ACCOUNT)
class CreateAccountOpFrame(OperationFrame):

    def do_check_valid(self, ledger_version: int):
        if self.body.startingBalance < 0:
            return False, self.make_result(Code.CREATE_ACCOUNT_MALFORMED)
        if self.body.destination == self.source_account_id():
            return False, self.make_result(Code.CREATE_ACCOUNT_MALFORMED)
        return True, None

    def do_apply(self, outer):
        if outer.exists(account_key(self.body.destination)):
            return False, self.make_result(Code.CREATE_ACCOUNT_ALREADY_EXIST)

        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            entry = new_account_entry(
                self.body.destination, self.body.startingBalance,
                get_starting_sequence_number(header.ledgerSeq),
                last_modified=header.ledgerSeq)
            # Reserve for the new account: paid by the account's own
            # starting balance, or by an active sponsor.
            res = create_entry_with_possible_sponsorship(
                ltx, header, entry, None)
            if res == SponsorshipResult.LOW_RESERVE:
                return False, self.make_result(
                    Code.CREATE_ACCOUNT_LOW_RESERVE)
            if res == SponsorshipResult.TOO_MANY_SPONSORING:
                return False, self.make_top_result(
                    OperationResultCode.opTOO_MANY_SPONSORING)
            assert res == SponsorshipResult.SUCCESS

            src = ltx.load(account_key(self.source_account_id()))
            if get_available_balance(header, src.entry) < \
                    self.body.startingBalance:
                src.deactivate()
                return False, self.make_result(
                    Code.CREATE_ACCOUNT_UNDERFUNDED)
            ok = add_balance(header, src.entry, -self.body.startingBalance)
            assert ok
            src.deactivate()

            ltx.create(entry).deactivate()
            ltx.commit()
        return True, self.make_result(Code.CREATE_ACCOUNT_SUCCESS)
