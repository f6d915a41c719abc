"""OperationFrame base: per-operation validation/apply plumbing
(reference ``src/transactions/OperationFrame.cpp``).

Each operation type subclasses :class:`OperationFrame` and implements
``do_check_valid`` (stateless validation) and ``do_apply`` (state
mutation under a nested LedgerTxn). The base provides source-account
resolution, threshold-level signature checks, and the result plumbing.

Current-protocol semantics only (>= 19): at apply time the op source
account must exist (opNO_ACCOUNT) and per-op signatures are re-checked
at the transaction level (``TransactionFrame.process_signatures``), not
here.

The port's copy of ``stellar_tpu/tx/op_frame.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Type

from stellar_tpu_torch.xdr.results import (
    OperationInnerResult, OperationResult, OperationResultCode,
)
from stellar_tpu_torch.xdr.tx import (
    Operation, OperationType, muxed_to_account_id,
)
from stellar_tpu_torch.xdr.types import (
    LedgerKey, LedgerKeyAccount, LedgerEntryType, THRESHOLD_HIGH,
    THRESHOLD_LOW, THRESHOLD_MED,
)

if TYPE_CHECKING:
    from stellar_tpu_torch.tx.signature_checker import SignatureChecker
    from stellar_tpu_torch.tx.transaction_frame import TransactionFrame

__all__ = ["OperationFrame", "register_op", "make_op_frame",
            "account_key", "ThresholdLevel"]


class ThresholdLevel:
    LOW = THRESHOLD_LOW
    MEDIUM = THRESHOLD_MED
    HIGH = THRESHOLD_HIGH


from stellar_tpu_torch.utils.cache import RandomEvictionCache

_ACCOUNT_KEY_CACHE: RandomEvictionCache = RandomEvictionCache(65536)


def account_key(account_id) -> "LedgerKey.Value":
    """Memoized by the 32-byte account id: the apply loop resolves the
    same hot accounts' keys thousands of times per close, and the
    LedgerKey (+ its cached encoding, see ledger_txn.key_bytes) is
    immutable once built. Random eviction (not FIFO) so a churning
    account stream cannot deterministically flush the hot set."""
    aid = account_id.value
    if type(aid) is bytes:
        k = _ACCOUNT_KEY_CACHE.maybe_get(aid)
        if k is None:
            k = LedgerKey.make(LedgerEntryType.ACCOUNT,
                               LedgerKeyAccount(accountID=account_id))
            _ACCOUNT_KEY_CACHE.put(aid, k)
        return k
    return LedgerKey.make(LedgerEntryType.ACCOUNT,
                          LedgerKeyAccount(accountID=account_id))


_REGISTRY: Dict[int, Type["OperationFrame"]] = {}


def register_op(op_type: int):
    def deco(cls):
        cls.OP_TYPE = op_type
        _REGISTRY[op_type] = cls
        return cls
    return deco


def make_op_frame(op: Operation, parent_tx: "TransactionFrame",
                  index: int) -> "OperationFrame":
    cls = _REGISTRY.get(op.body.arm)
    if cls is None:
        raise NotImplementedError(
            f"operation type {OperationType.name_of(op.body.arm)} "
            "not implemented")
    return cls(op, parent_tx, index)


class OperationFrame:
    OP_TYPE: int = -1

    def __init__(self, op: Operation, parent_tx: "TransactionFrame",
                 index: int):
        self.operation = op
        self.parent_tx = parent_tx
        self.index = index
        self.body = op.body.value

    # ---------------- source / result helpers ----------------

    def source_account_id(self):
        """Op source (explicit or the tx's) as AccountID
        (reference ``getSourceID``)."""
        if self.operation.sourceAccount is not None:
            return muxed_to_account_id(self.operation.sourceAccount)
        return self.parent_tx.source_account_id()

    def make_result(self, inner_code: int, payload=None) -> OperationResult:
        """opINNER result carrying this op type's inner code."""
        from stellar_tpu_torch.xdr.results import OperationInnerResult
        inner_union = OperationInnerResult.arms[self.OP_TYPE]
        return OperationResult.make(
            OperationResultCode.opINNER,
            OperationInnerResult.make(
                self.OP_TYPE, inner_union.make(inner_code, payload)))

    @staticmethod
    def make_top_result(code: int) -> OperationResult:
        """Top-level failure (opBAD_AUTH, opNO_ACCOUNT, ...)."""
        return OperationResult.make(code)

    def sponsorship_failure(self, res: int,
                            low_reserve_code: int) -> OperationResult:
        """Map a failed SponsorshipResult to this op's failure result:
        LOW_RESERVE carries the op's own inner code, the counter overflows
        map to top-level op codes (the switch every reference op frame
        repeats after ``createEntryWithPossibleSponsorship``)."""
        from stellar_tpu_torch.tx.sponsorship import SponsorshipResult
        if res == SponsorshipResult.LOW_RESERVE:
            return self.make_result(low_reserve_code)
        if res == SponsorshipResult.TOO_MANY_SUBENTRIES:
            return self.make_top_result(
                OperationResultCode.opTOO_MANY_SUBENTRIES)
        if res == SponsorshipResult.TOO_MANY_SPONSORING:
            return self.make_top_result(
                OperationResultCode.opTOO_MANY_SPONSORING)
        raise ValueError(f"unexpected sponsorship result {res}")

    # ---------------- signature / validity ----------------

    def threshold_level(self) -> int:
        return ThresholdLevel.MEDIUM

    def check_signature(self, checker: "SignatureChecker", ltx,
                        for_apply: bool):
        """Verify the op source signed at the needed threshold
        (reference ``OperationFrame::checkSignature``).
        Returns (ok, failure_result_or_None)."""
        source_id = self.source_account_id()
        entry = ltx.load_without_record(account_key(source_id))
        if entry is not None:
            acc = entry.data.value
            needed = acc.thresholds[self.threshold_level()]
            if not self.parent_tx.check_signature_for_account(
                    checker, acc, needed):
                return False, self.make_top_result(
                    OperationResultCode.opBAD_AUTH)
            return True, None
        if for_apply or self.operation.sourceAccount is None:
            return False, self.make_top_result(
                OperationResultCode.opNO_ACCOUNT)
        if not self.parent_tx.check_signature_no_account(checker, source_id):
            return False, self.make_top_result(
                OperationResultCode.opBAD_AUTH)
        return True, None

    def check_valid(self, checker: "SignatureChecker", ltx,
                    for_apply: bool):
        """(ok, failure_result). Mirrors ``OperationFrame::checkValid``
        for protocol >= 19."""
        # anchor for state-scoped lookups inside do_check_valid (e.g.
        # the node's soroban network config); cleared on exit so queued
        # frames don't pin dead LedgerTxn chains
        self._active_ltx = ltx
        try:
            if not for_apply:
                ok, fail = self.check_signature(checker, ltx, for_apply)
                if not ok:
                    return False, fail
            else:
                if ltx.load_without_record(
                        account_key(self.source_account_id())) is None:
                    return False, self.make_top_result(
                        OperationResultCode.opNO_ACCOUNT)
            ledger_version = ltx.header().ledgerVersion
            return self.do_check_valid(ledger_version)
        finally:
            self._active_ltx = None

    def apply(self, checker: "SignatureChecker", ltx):
        """(ok, result). checkValid(forApply) then doApply
        (reference ``OperationFrame::apply``)."""
        ok, fail = self.check_valid(checker, ltx, for_apply=True)
        if not ok:
            return False, fail
        self._active_ltx = ltx
        try:
            return self.do_apply(ltx)
        finally:
            self._active_ltx = None

    # ---------------- per-op hooks ----------------

    def do_check_valid(self, ledger_version: int):
        """(ok, failure_result_or_None): checks independent of state."""
        raise NotImplementedError

    def do_apply(self, ltx):
        """(ok, result): mutate state under ``ltx``."""
        raise NotImplementedError
