"""ManageData + BumpSequence (reference ``ManageDataOpFrame.cpp``,
``BumpSequenceOpFrame.cpp``).

The port's copy of ``stellar_tpu/tx/ops/misc.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx.sponsorship import (
    SponsorshipResult, create_entry_with_possible_sponsorship,
    remove_entry_with_possible_sponsorship,
)
from stellar_tpu_torch.tx.op_frame import (
    OperationFrame, ThresholdLevel, account_key, register_op,
)
from stellar_tpu_torch.xdr.results import (
    BumpSequenceResultCode, ManageDataResultCode,
)
from stellar_tpu_torch.xdr.tx import OperationType
from stellar_tpu_torch.xdr.types import (
    DataEntry, LedgerEntry, LedgerEntryType, LedgerKey, LedgerKeyData,
)

def _is_string_valid(s: bytes) -> bool:
    """Printable ASCII only (reference ``isStringValid``,
    ``src/util/types.cpp``: rejects >0x7F and control chars)."""
    return all(0x20 <= c <= 0x7E for c in s)


def data_key(account_id, name: bytes) -> "LedgerKey.Value":
    return LedgerKey.make(LedgerEntryType.DATA,
                          LedgerKeyData(accountID=account_id, dataName=name))


@register_op(OperationType.MANAGE_DATA)
class ManageDataOpFrame(OperationFrame):

    def do_check_valid(self, ledger_version: int):
        name = self.body.dataName
        if not (1 <= len(name) <= 64) or not _is_string_valid(name):
            return False, self.make_result(
                ManageDataResultCode.MANAGE_DATA_INVALID_NAME)
        return True, None

    def do_apply(self, outer):
        Code = ManageDataResultCode
        src_id = self.source_account_id()
        key = data_key(src_id, self.body.dataName)
        with LedgerTxn(outer) as ltx:
            header = ltx.header()
            if self.body.dataValue is not None:
                existing = ltx.load(key)
                if existing is not None:
                    existing.data.dataValue = self.body.dataValue
                    existing.deactivate()
                else:
                    de = DataEntry(
                        accountID=src_id, dataName=self.body.dataName,
                        dataValue=self.body.dataValue,
                        ext=DataEntry._types[3].make(0))
                    le = LedgerEntry(
                        lastModifiedLedgerSeq=header.ledgerSeq,
                        data=LedgerEntry._types[1].make(
                            LedgerEntryType.DATA, de),
                        ext=LedgerEntry._types[2].make(0))
                    with ltx.load(account_key(src_id)) as src:
                        res = create_entry_with_possible_sponsorship(
                            ltx, header, le, src.entry)
                    if res != SponsorshipResult.SUCCESS:
                        ltx.rollback()
                        return False, self.sponsorship_failure(
                            res, Code.MANAGE_DATA_LOW_RESERVE)
                    ltx.create(le).deactivate()
            else:
                le = ltx.load_without_record(key)
                if le is None:
                    ltx.rollback()
                    return False, self.make_result(
                        Code.MANAGE_DATA_NAME_NOT_FOUND)
                ltx.erase(key)
                with ltx.load(account_key(src_id)) as src:
                    remove_entry_with_possible_sponsorship(
                        ltx, header, le, src.entry)
            ltx.commit()
        return True, self.make_result(Code.MANAGE_DATA_SUCCESS)


@register_op(OperationType.BUMP_SEQUENCE)
class BumpSequenceOpFrame(OperationFrame):

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    def do_check_valid(self, ledger_version: int):
        if self.body.bumpTo < 0:
            return False, self.make_result(
                BumpSequenceResultCode.BUMP_SEQUENCE_BAD_SEQ)
        return True, None

    def do_apply(self, ltx):
        with ltx.load(account_key(self.source_account_id())) as src:
            acc = src.data
            if self.body.bumpTo > acc.seqNum:
                acc.seqNum = self.body.bumpTo
                maybe_update_account_on_seq_update(ltx.header(), acc)
        return True, self.make_result(
            BumpSequenceResultCode.BUMP_SEQUENCE_SUCCESS)


def maybe_update_account_on_seq_update(header, acc):
    """Stamp seqLedger/seqTime when the account tracks them (ext v3;
    reference ``maybeUpdateAccountOnLedgerSeqUpdate``)."""
    from stellar_tpu_torch.tx.account_utils import account_ext_v2
    v2 = account_ext_v2(acc)
    if v2 is not None and v2.ext.arm == 3:
        v3 = v2.ext.value
        v3.seqLedger = header.ledgerSeq
        v3.seqTime = header.scpValue.closeTime
