"""TransactionFrame: validation, fee/seq processing, and apply
(reference ``src/transactions/TransactionFrame.cpp``).

Lifecycle (current protocol >= 19):

* ``check_valid`` — pre-consensus validation: structure, preconditions,
  sequence number, signatures (low threshold + extra signers), balance
  can cover the fee, then per-op ``do_check_valid`` + op signature
  thresholds; used by the tx queue and txset validation.
* ``process_fee_seq_num`` — ledger-close fee phase: charge
  min(balance, fee) into the fee pool (no reserve check — reference
  ``processFeeSeqNum``).
* ``apply`` — re-validate under the apply snapshot, bump the sequence
  number even when invalid (``processSeqNum``), settle signature
  bookkeeping (one-time signer removal, BAD_AUTH_EXTRA), then apply each
  operation in its own nested LedgerTxn, rolling everything back if any
  op fails (``applyOperations``).

Fee-bump envelopes are handled by :class:`FeeBumpTransactionFrame`.

The port's copy of ``stellar_tpu/tx/transaction_frame.py``, with the
port's imports."""

from __future__ import annotations

from typing import List, Optional, Sequence

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.tx.account_utils import (
    INT64_MAX, account_ext_v2, get_available_balance,
)
from stellar_tpu_torch.tx.op_frame import account_key, make_op_frame
from stellar_tpu_torch.tx.signature_checker import SignatureChecker
from stellar_tpu_torch.tx.sponsorship import (
    remove_signer_with_possible_sponsorship,
)
from stellar_tpu_torch.xdr.results import (
    OperationResult, TransactionResult, TransactionResultCode as TxCode,
    tx_result,
)
from stellar_tpu_torch.xdr.runtime import Packer, to_bytes
from stellar_tpu_torch.xdr.tx import (
    DecoratedSignature, FeeBumpTransaction, MAX_OPS_PER_TX,
    Preconditions, PreconditionType, Transaction, TransactionEnvelope,
    TransactionV1Envelope, muxed_account, muxed_to_account_id,
)
from stellar_tpu_torch.xdr.types import (
    EnvelopeType, Signer, SignerKey, SignerKeyType,
)

# the signatures VarArray type shared by every envelope form
_SIGS_T = dict(TransactionV1Envelope.FIELDS)["signatures"]

__all__ = [
    "ValidationType", "MutableTxResult", "TransactionFrame",
    "FeeBumpTransactionFrame", "make_transaction_frame",
]

# escalate internal apply errors instead of failing the tx (reference
# HALT_ON_INTERNAL_TRANSACTION_ERROR; set by Application from Config)
HALT_ON_INTERNAL_ERROR = False

# ([durations_us], [weights]) weighted per-op apply sleep, or None
# (reference OP_APPLY_SLEEP_TIME_{DURATION,WEIGHT}_FOR_TESTING). The
# pick rotates deterministically so stressed runs stay reproducible.
OP_APPLY_SLEEP = None
_OP_SLEEP_TICK = [0]


def _op_apply_sleep():
    import time as _time
    durs, weights = OP_APPLY_SLEEP
    total = sum(weights)
    tick = _OP_SLEEP_TICK[0] % total
    _OP_SLEEP_TICK[0] += 1
    for d, w in zip(durs, weights):
        if tick < w:
            if d > 0:
                _time.sleep(d / 1_000_000.0)
            return
        tick -= w


class ValidationType:
    INVALID = 0            # fast fail
    UPDATE_SEQ_NUM = 1     # invalid, but seq num still consumed on apply
    POST_AUTH = 2          # invalid after auth (fee was charged)
    MAYBE_VALID = 3


class MutableTxResult:
    """Accumulates the result of one transaction (reference
    ``MutableTransactionResult``)."""

    def __init__(self, code: int = TxCode.txSUCCESS, fee_charged: int = 0):
        self.code = code
        self.fee_charged = fee_charged
        self.op_results: List = []

    def set_code(self, code: int):
        self.code = code

    def to_xdr(self) -> TransactionResult:
        ops = self.op_results if self.code in (
            TxCode.txSUCCESS, TxCode.txFAILED) else None
        return tx_result(self.code, ops, self.fee_charged)

    @property
    def is_success(self) -> bool:
        return self.code == TxCode.txSUCCESS


class TxApplyMeta:
    """Collects entry-change meta during apply (reference
    ``TransactionMetaFrame``)."""

    def __init__(self):
        self.tx_changes_before: List = []
        self.operations: List = []
        self.tx_changes_after: List = []


class TransactionFrame:
    """A v0/v1 transaction envelope bound to a network id."""

    def __init__(self, network_id: bytes, envelope):
        self.network_id = network_id
        self.envelope = envelope
        etype = envelope.arm
        if etype == EnvelopeType.ENVELOPE_TYPE_TX:
            self.tx: Transaction = envelope.value.tx
        elif etype == EnvelopeType.ENVELOPE_TYPE_TX_V0:
            self.tx = _v0_to_v1(envelope.value.tx)
        else:
            raise ValueError("not a v0/v1 transaction envelope")
        self.signatures: Sequence[DecoratedSignature] = \
            envelope.value.signatures
        self._hash: Optional[bytes] = None
        self._size: Optional[int] = None
        self._body_bytes: Optional[bytes] = None
        self._env_bytes: Optional[bytes] = None
        self.op_frames = [make_op_frame(op, self, i)
                          for i, op in enumerate(self.tx.operations)]

    # ---------------- identity / accessors ----------------

    def invalidate_identity_caches(self) -> None:
        """Drop every serialization-derived memo. MUST be called after
        mutating ``self.tx`` / signatures (test-only idiom): resetting
        ``_hash`` alone would rehash a stale memoized body."""
        self._hash = None
        self._size = None
        self._body_bytes = None
        self._env_bytes = None
        if hasattr(self, "_full_hash"):
            del self._full_hash

    def tx_body_bytes(self) -> bytes:
        """Memoized XDR of the (v1-form) transaction body. The sig
        payload and the v1 envelope encoding both embed exactly these
        bytes (RFC 4506 struct layout: TransactionSignaturePayload =
        networkId ++ envType ++ body; TransactionEnvelope(TX) =
        envType ++ body ++ signatures), so everything identity-shaped
        on this frame derives from one serialization."""
        if self._body_bytes is None:
            self._body_bytes = to_bytes(Transaction, self.tx)
        return self._body_bytes

    def envelope_bytes(self) -> bytes:
        """Memoized XDR of the full envelope (wire form, incl. sigs)."""
        if self._env_bytes is None:
            if self.envelope.arm == EnvelopeType.ENVELOPE_TYPE_TX:
                p = Packer()
                EnvelopeType.pack(p, EnvelopeType.ENVELOPE_TYPE_TX)
                p.buf += self.tx_body_bytes()
                _SIGS_T.pack(p, self.envelope.value.signatures)
                self._env_bytes = p.bytes()
            else:  # v0 wire form differs from the v1 body
                self._env_bytes = to_bytes(TransactionEnvelope,
                                           self.envelope)
        return self._env_bytes

    def contents_preimage(self) -> bytes:
        """The signature-payload bytes whose SHA-256 is the tx id —
        exposed so bulk paths can batch-hash a whole set's ids through
        the hash workload (``tx_set.prefetch_contents_hashes``)."""
        p = Packer()
        p.pack_fopaque(32, self.network_id)
        EnvelopeType.pack(p, EnvelopeType.ENVELOPE_TYPE_TX)
        p.buf += self.tx_body_bytes()
        return p.bytes()

    def contents_hash(self) -> bytes:
        """Tx id: SHA-256 of the signature payload (reference
        ``getContentsHash``; v0 envelopes hash as their v1 form)."""
        if self._hash is None:
            self._hash = sha256(self.contents_preimage())
        return self._hash

    def source_account_id(self):
        return muxed_to_account_id(self.tx.sourceAccount)

    @property
    def seq_num(self) -> int:
        return self.tx.seqNum

    def num_operations(self) -> int:
        return len(self.tx.operations)

    def full_fee(self) -> int:
        return self.tx.fee

    def inclusion_fee(self) -> int:
        if self.is_soroban():
            return self.full_fee() - self.declared_soroban_resource_fee()
        return self.full_fee()

    def size_bytes(self) -> int:
        """Envelope wire size (feeds bandwidth/historical resource
        fees). Memoized: the envelope is immutable and fee/surge
        paths ask several times per close."""
        if self._size is None:
            self._size = len(self.envelope_bytes())
        return self._size

    def note_soroban_consumption(self, refundable_consumed: int, events):
        """Called by the Soroban op frame after the host ran: how much
        of the refundable fee (rent + events) was actually used."""
        self._soroban_refundable_consumed = refundable_consumed
        self._soroban_events = events

    def is_soroban(self) -> bool:
        return self.tx.ext.arm == 1

    def declared_soroban_resource_fee(self) -> int:
        return self.tx.ext.value.resourceFee if self.is_soroban() else 0

    def fee(self, header, base_fee: Optional[int], applying: bool) -> int:
        """Effective fee under a discounted base fee (reference
        ``TransactionFrame::getFee``)."""
        if base_fee is None:
            return self.full_fee()
        adjusted = base_fee * max(1, self.num_operations())
        resource = self.declared_soroban_resource_fee()
        if applying:
            return resource + min(self.inclusion_fee(), adjusted)
        return resource + adjusted

    # -- preconditions --

    def time_bounds(self):
        c = self.tx.cond
        if c.arm == PreconditionType.PRECOND_TIME:
            return c.value
        if c.arm == PreconditionType.PRECOND_V2:
            return c.value.timeBounds
        return None

    def ledger_bounds(self):
        c = self.tx.cond
        return c.value.ledgerBounds \
            if c.arm == PreconditionType.PRECOND_V2 else None

    def min_seq_num(self):
        c = self.tx.cond
        return c.value.minSeqNum \
            if c.arm == PreconditionType.PRECOND_V2 else None

    def min_seq_age(self) -> int:
        c = self.tx.cond
        return c.value.minSeqAge \
            if c.arm == PreconditionType.PRECOND_V2 else 0

    def min_seq_ledger_gap(self) -> int:
        c = self.tx.cond
        return c.value.minSeqLedgerGap \
            if c.arm == PreconditionType.PRECOND_V2 else 0

    def extra_signers(self) -> list:
        c = self.tx.cond
        return list(c.value.extraSigners) \
            if c.arm == PreconditionType.PRECOND_V2 else []

    # ---------------- signature plumbing ----------------

    def make_signature_checker(self, ledger_version: int) -> SignatureChecker:
        return SignatureChecker(ledger_version, self.contents_hash(),
                                self.signatures)

    def check_signature_for_account(self, checker: SignatureChecker, acc,
                                    needed_weight: int) -> bool:
        """Master key + account signers vs needed weight (reference
        ``TransactionFrame::checkSignature``)."""
        signers = []
        if acc.thresholds[0]:
            signers.append(Signer(
                key=SignerKey.make(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                                   acc.accountID.value),
                weight=acc.thresholds[0]))
        signers.extend(acc.signers)
        return checker.check_signature(signers, needed_weight)

    def check_signature_no_account(self, checker: SignatureChecker,
                                   account_id) -> bool:
        """Missing op-source account: master key with weight 1, needed 0
        (reference ``checkSignatureNoAccount``)."""
        signers = [Signer(
            key=SignerKey.make(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                               account_id.value),
            weight=1)]
        return checker.check_signature(signers, 0)

    def check_extra_signers(self, checker: SignatureChecker) -> bool:
        extra = self.extra_signers()
        if not extra:
            return True
        signers = [Signer(key=k, weight=1) for k in extra]
        return checker.check_signature(signers, len(signers))

    # ---------------- validation ----------------

    def is_too_early(self, header, lower_offset: int = 0) -> bool:
        tb = self.time_bounds()
        if tb and tb.minTime and \
                tb.minTime > header.scpValue.closeTime + lower_offset:
            return True
        lb = self.ledger_bounds()
        return bool(lb and lb.minLedger > header.ledgerSeq)

    def is_too_late(self, header, upper_offset: int = 0) -> bool:
        tb = self.time_bounds()
        if tb and tb.maxTime and \
                tb.maxTime < header.scpValue.closeTime + upper_offset:
            return True
        lb = self.ledger_bounds()
        return bool(lb and lb.maxLedger != 0
                    and lb.maxLedger <= header.ledgerSeq)

    def is_bad_seq(self, header, current: int) -> bool:
        if self.seq_num == (header.ledgerSeq << 32):
            return True
        msn = self.min_seq_num()
        if msn is not None:
            return current < msn or current >= self.seq_num
        return current == INT64_MAX or current + 1 != self.seq_num

    def is_too_early_for_account(self, header, acc, lower_offset: int) -> bool:
        """minSeqAge / minSeqLedgerGap vs the account's seqTime/seqLedger
        (reference ``isTooEarlyForAccount``)."""
        v2 = account_ext_v2(acc)
        v3 = v2.ext.value if (v2 is not None and v2.ext.arm == 3) else None
        acc_seq_time = v3.seqTime if v3 else 0
        min_seq_age = self.min_seq_age()
        lower_close = header.scpValue.closeTime + lower_offset
        if min_seq_age > lower_close or \
                lower_close - min_seq_age < acc_seq_time:
            return True
        acc_seq_ledger = v3.seqLedger if v3 else 0
        gap = self.min_seq_ledger_gap()
        if gap > header.ledgerSeq or \
                header.ledgerSeq - gap < acc_seq_ledger:
            return True
        return False

    def _soroban_ops_consistent(self) -> bool:
        """Soroban data ext <=> exactly one Soroban op (reference
        ``validateSorobanOpsConsistency``)."""
        from stellar_tpu_torch.xdr.tx import OperationType
        soroban_types = (OperationType.INVOKE_HOST_FUNCTION,
                         OperationType.EXTEND_FOOTPRINT_TTL,
                         OperationType.RESTORE_FOOTPRINT)
        n_soroban = sum(1 for op in self.tx.operations
                        if op.body.arm in soroban_types)
        if self.is_soroban():
            return n_soroban == 1 and self.num_operations() == 1
        return n_soroban == 0

    def _common_valid_pre_seq_num(self, ltx, result: MutableTxResult,
                                  lower_offset: int, upper_offset: int,
                                  charge_fee: bool = True) -> bool:
        """Account-independent checks (reference
        ``commonValidPreSeqNum``)."""
        extra = self.extra_signers()
        if extra:
            if len(extra) == 2 and extra[0] == extra[1]:
                result.set_code(TxCode.txMALFORMED)
                return False
            for s in extra:
                if s.arm == \
                        SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD \
                        and len(s.value.payload) == 0:
                    result.set_code(TxCode.txMALFORMED)
                    return False
        if self.num_operations() == 0:
            result.set_code(TxCode.txMISSING_OPERATION)
            return False
        if self.num_operations() > MAX_OPS_PER_TX:
            result.set_code(TxCode.txMALFORMED)
            return False
        if not self._soroban_ops_consistent():
            result.set_code(TxCode.txMALFORMED)
            return False
        header = ltx.header()
        if self.is_too_early(header, lower_offset):
            result.set_code(TxCode.txTOO_EARLY)
            return False
        if self.is_too_late(header, upper_offset):
            result.set_code(TxCode.txTOO_LATE)
            return False
        # fee-bumped inner txs (charge_fee False) may bid any fee >= 0;
        # the outer envelope pays (reference gates this on chargeFee)
        if charge_fee and self.full_fee() < self.fee(
                header, header.baseFee, applying=False):
            result.set_code(TxCode.txINSUFFICIENT_FEE)
            return False
        if not charge_fee and self.inclusion_fee() < 0:
            result.set_code(TxCode.txINSUFFICIENT_FEE)
            return False
        if ltx.load_without_record(
                account_key(self.source_account_id())) is None:
            result.set_code(TxCode.txNO_ACCOUNT)
            return False
        return True

    def common_valid(self, checker: SignatureChecker, ltx,
                     current: int, applying: bool, charge_fee: bool,
                     result: MutableTxResult, lower_offset: int = 0,
                     upper_offset: int = 0) -> int:
        """Returns a ValidationType (reference ``commonValid``)."""
        if not self._common_valid_pre_seq_num(
                ltx, result, lower_offset, upper_offset, charge_fee):
            return ValidationType.INVALID

        header = ltx.header()
        src_entry = ltx.load_without_record(
            account_key(self.source_account_id()))
        acc = src_entry.data.value

        if current == 0:
            current = acc.seqNum
        if self.is_bad_seq(header, current):
            result.set_code(TxCode.txBAD_SEQ)
            return ValidationType.INVALID

        cv = ValidationType.UPDATE_SEQ_NUM

        if self.is_too_early_for_account(header, acc, lower_offset):
            result.set_code(TxCode.txBAD_MIN_SEQ_AGE_OR_GAP)
            return cv
        if not self.check_signature_for_account(
                checker, acc, acc.thresholds[1]):
            result.set_code(TxCode.txBAD_AUTH)
            return cv
        if not self.check_extra_signers(checker):
            result.set_code(TxCode.txBAD_AUTH)
            return cv

        cv = ValidationType.POST_AUTH

        # when applying, the fee was already taken in the fee phase
        fee_to_pay = 0 if applying else self.full_fee()
        if charge_fee and \
                get_available_balance(header, src_entry) < fee_to_pay:
            result.set_code(TxCode.txINSUFFICIENT_BALANCE)
            return cv

        return ValidationType.MAYBE_VALID

    def check_valid(self, ltx, current: int = 0, lower_offset: int = 0,
                    upper_offset: int = 0,
                    charge_fee: bool = True) -> MutableTxResult:
        """Full pre-consensus validation incl. per-op checks (reference
        ``checkValidWithOptionallyChargedFee``)."""
        result = MutableTxResult(
            fee_charged=self.fee(ltx.header(), ltx.header().baseFee
                                 if charge_fee else None, applying=False))
        checker = self.make_signature_checker(ltx.header().ledgerVersion)
        cv = self.common_valid(checker, ltx, current, applying=False,
                               charge_fee=charge_fee, result=result,
                               lower_offset=lower_offset,
                               upper_offset=upper_offset)
        if cv != ValidationType.MAYBE_VALID:
            return result

        ok_all = True
        for op in self.op_frames:
            ok, fail = op.check_valid(checker, ltx, for_apply=False)
            self_res = fail if fail is not None else op.make_result(0)
            result.op_results.append(self_res)
            if not ok:
                ok_all = False
        if not ok_all:
            result.set_code(TxCode.txFAILED)
            return result
        if not checker.check_all_signatures_used():
            result.set_code(TxCode.txBAD_AUTH_EXTRA)
            return result
        result.set_code(TxCode.txSUCCESS)
        return result

    # ---------------- ledger-close processing ----------------

    def process_fee_seq_num(self, ltx, base_fee: Optional[int]
                            ) -> MutableTxResult:
        """Fee phase: charge min(balance, fee) (reference
        ``processFeeSeqNum``)."""
        with LedgerTxn(ltx) as inner:
            with inner.load_header() as hh:
                header = hh.header
                fee = self.fee(header, base_fee, applying=True)
                result = MutableTxResult(fee_charged=fee)
                src = inner.load(account_key(self.source_account_id()))
                if src is None:
                    raise RuntimeError("fee source account missing")
                acc = src.data
                if fee > 0:
                    charged = min(acc.balance, fee)
                    result.fee_charged = charged
                    acc.balance -= charged
                    header.feePool += charged
                src.deactivate()
            result.fee_changes = inner.get_changes()  # meta: feeProcessing
            inner.commit()
        self._fee_charged = result.fee_charged
        return result

    def process_seq_num(self, ltx):
        """Consume the sequence number (reference ``processSeqNum``)."""
        from stellar_tpu_torch.tx.ops.misc import (
            maybe_update_account_on_seq_update,
        )
        with ltx.load(account_key(self.source_account_id())) as src:
            if src.data.seqNum > self.seq_num:
                raise RuntimeError("unexpected sequence number")
            src.data.seqNum = self.seq_num
            maybe_update_account_on_seq_update(ltx.header(), src.data)

    def remove_one_time_signers(self, ltx):
        """Drop pre-auth-tx signers matching this tx from every source
        account (reference ``removeOneTimeSignerFromAllSourceAccounts``)."""
        # collect unique source account ids (tx + op sources)
        seen = []
        for aid in [self.source_account_id()] + \
                [op.source_account_id() for op in self.op_frames]:
            if aid not in seen:
                seen.append(aid)
        h = self.contents_hash()
        for aid in seen:
            handle = ltx.load(account_key(aid))
            if handle is None:
                continue
            acc = handle.data
            doomed = [i for i, s in enumerate(acc.signers)
                      if s.key.arm ==
                      SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX
                      and s.key.value == h]
            for i in reversed(doomed):
                remove_signer_with_possible_sponsorship(
                    ltx, ltx.header(), handle.entry, i)
            handle.deactivate()

    def process_signatures(self, cv: int, checker: SignatureChecker,
                           ltx, result: MutableTxResult) -> bool:
        """Post-validation signature settlement (reference
        ``processSignatures``)."""
        maybe_valid = cv == ValidationType.MAYBE_VALID
        if not maybe_valid:
            self.remove_one_time_signers(ltx)
            return False

        all_ops_valid = True
        if result.code in (TxCode.txSUCCESS, TxCode.txFAILED):
            with LedgerTxn(ltx) as scope:
                for i, op in enumerate(self.op_frames):
                    ok, fail = op.check_signature(
                        checker, scope, for_apply=False)
                    if not ok:
                        result.op_results[i] = fail
                        all_ops_valid = False
                scope.rollback()

        self.remove_one_time_signers(ltx)

        if not all_ops_valid:
            result.set_code(TxCode.txFAILED)
            return False
        if not checker.check_all_signatures_used():
            result.set_code(TxCode.txBAD_AUTH_EXTRA)
            return False
        return maybe_valid

    # ---------------- apply ----------------

    def apply(self, ltx, meta: Optional[TxApplyMeta] = None,
              charge_fee: bool = True) -> MutableTxResult:
        """Apply under the close snapshot (reference
        ``TransactionFrame::apply``). Returns the final result; state
        effects are committed into ``ltx``."""
        if meta is None:
            meta = TxApplyMeta()
        checker = self.make_signature_checker(ltx.header().ledgerVersion)
        # the fee phase (process_fee_seq_num) already ran; carry what it
        # actually charged so refunds can be computed against it
        result = MutableTxResult(
            fee_charged=getattr(self, "_fee_charged", 0))
        # op results pre-seeded as successes so op signature failures can
        # be recorded positionally
        result.op_results = [op.make_result(0) for op in self.op_frames]

        tx_level = LedgerTxn(ltx)
        cv = self.common_valid(checker, tx_level, 0, applying=True,
                               charge_fee=charge_fee, result=result)
        if cv >= ValidationType.UPDATE_SEQ_NUM:
            self.process_seq_num(tx_level)
        sigs_valid = self.process_signatures(cv, checker, tx_level, result)
        meta.tx_changes_before.extend(tx_level.get_changes())
        tx_level.commit()

        ok = sigs_valid and cv == ValidationType.MAYBE_VALID
        if not ok:
            if result.code == TxCode.txSUCCESS:
                result.set_code(TxCode.txFAILED)
            self._process_soroban_refund(ltx, result)
            return result

        result = self._apply_operations(checker, ltx, meta, result)
        self._process_soroban_refund(ltx, result)
        return result

    def soroban_refund_amount(self, success: bool, cfg=None) -> int:
        """Unused refundable resource fee: declared - non-refundable -
        consumed(rent + events); consumption only counts on success."""
        if not self.is_soroban():
            return 0
        from stellar_tpu_torch.ledger.network_config import compute_resource_fee
        if cfg is None:
            from stellar_tpu_torch.tx.ops.soroban_ops import (
                default_soroban_config,
            )
            cfg = default_soroban_config()
        res = self.tx.ext.value.resources
        fp = res.footprint
        non_ref, _ = compute_resource_fee(
            cfg, res.instructions, len(fp.readOnly), len(fp.readWrite),
            res.readBytes, res.writeBytes, self.size_bytes())
        consumed = getattr(self, "_soroban_refundable_consumed", 0) \
            if success else 0
        return max(0, self.declared_soroban_resource_fee() - non_ref -
                   consumed)

    def _process_soroban_refund(self, ltx, result: MutableTxResult,
                                refund_to=None):
        """Return the unused refundable portion of the resource fee to
        the fee source (reference ``processRefund``)."""
        from stellar_tpu_torch.ledger.ledger_txn import soroban_config_of
        refund = min(self.soroban_refund_amount(result.is_success,
                                                soroban_config_of(ltx)),
                     result.fee_charged)  # only what was charged
        if refund <= 0:
            return
        with LedgerTxn(ltx) as scope:
            src = scope.load(account_key(
                refund_to if refund_to is not None
                else self.source_account_id()))
            if src is not None:
                src.data.balance += refund
                src.deactivate()
                with scope.load_header() as hh:
                    hh.header.feePool -= refund
                result.fee_charged -= refund
                scope.commit()
            else:
                scope.rollback()

    def _apply_operations(self, checker, ltx, meta: TxApplyMeta,
                          result: MutableTxResult) -> MutableTxResult:
        """Per-op apply loop (reference ``applyOperations``)."""
        success = True
        op_metas = []
        tx_txn = LedgerTxn(ltx)
        try:
            for i, op in enumerate(self.op_frames):
                if OP_APPLY_SLEEP is not None:
                    _op_apply_sleep()
                op_txn = LedgerTxn(tx_txn)
                ok, op_res = op.apply(checker, op_txn)
                result.op_results[i] = op_res
                if not ok:
                    success = False
                if success:
                    op_metas.append(op_txn.get_changes())
                if ok:
                    # post-condition checks over the op's delta
                    # (reference checkOnOperationApply via AppConnector)
                    from stellar_tpu_torch.invariant import get_active_manager
                    mgr = get_active_manager()
                    if mgr is not None:
                        mgr.check_on_operation_apply(
                            op, op_res, op_txn.get_delta(),
                            op_txn.header())
                    op_txn.commit()
                else:
                    op_txn.rollback()
            # a Begin without its matching End leaves a live sponsorship
            # directive: the whole tx fails (reference
            # TransactionFrame.cpp:1693, txBAD_SPONSORSHIP)
            bad_sponsorship = False
            if success:
                from stellar_tpu_torch.tx.sponsorship import (
                    has_sponsorship_entries,
                )
                if has_sponsorship_entries(tx_txn):
                    success = False
                    bad_sponsorship = True
            if success:
                tx_txn.commit()
                meta.operations.extend(op_metas)
                result.set_code(TxCode.txSUCCESS)
            else:
                tx_txn.rollback()
                result.set_code(TxCode.txBAD_SPONSORSHIP
                                if bad_sponsorship else TxCode.txFAILED)
        except Exception as e:
            if tx_txn._open:
                tx_txn.rollback()
            from stellar_tpu_torch.invariant.invariants import (
                InvariantDoesNotHold,
            )
            if isinstance(e, InvariantDoesNotHold):
                raise  # node-integrity failure: always fatal
            result.set_code(TxCode.txINTERNAL_ERROR)
            # reference default: the tx fails with txINTERNAL_ERROR and
            # the node keeps closing; HALT_ON_INTERNAL_TRANSACTION_
            # ERROR escalates for debugging (Config.h)
            if HALT_ON_INTERNAL_ERROR:
                raise
            import logging
            logging.getLogger("stellar_tpu.tx").exception(
                "internal error applying tx %s",
                self.contents_hash().hex())
        return result


def _v0_to_v1(tx_v0) -> Transaction:
    """Normalize a legacy TransactionV0 to the v1 shape it hashes as."""
    cond = Preconditions.make(PreconditionType.PRECOND_NONE) \
        if tx_v0.timeBounds is None else \
        Preconditions.make(PreconditionType.PRECOND_TIME, tx_v0.timeBounds)
    return Transaction(
        sourceAccount=muxed_account(tx_v0.sourceAccountEd25519),
        fee=tx_v0.fee, seqNum=tx_v0.seqNum, cond=cond, memo=tx_v0.memo,
        operations=tx_v0.operations,
        ext=Transaction._types[6].make(0))


class FeeBumpTransactionFrame:
    """Fee-bump envelope: outer fee account pays, inner tx applies
    (reference ``FeeBumpTransactionFrame.cpp``)."""

    def __init__(self, network_id: bytes, envelope):
        if envelope.arm != EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            raise ValueError("not a fee-bump envelope")
        self.network_id = network_id
        self.envelope = envelope
        self.fee_bump: FeeBumpTransaction = envelope.value.tx
        self.signatures = envelope.value.signatures
        inner_env = TransactionEnvelope.make(
            EnvelopeType.ENVELOPE_TYPE_TX, self.fee_bump.innerTx.value)
        self.inner = TransactionFrame(network_id, inner_env)
        self._hash: Optional[bytes] = None
        self._body_bytes: Optional[bytes] = None
        self._env_bytes: Optional[bytes] = None

    def invalidate_identity_caches(self) -> None:
        """See ``TransactionFrame.invalidate_identity_caches``."""
        self._hash = None
        self._body_bytes = None
        self._env_bytes = None
        if hasattr(self, "_full_hash"):
            del self._full_hash
        self.inner.invalidate_identity_caches()

    def tx_body_bytes(self) -> bytes:
        """Memoized XDR of the FeeBumpTransaction body (see
        ``TransactionFrame.tx_body_bytes`` for the layout argument)."""
        if self._body_bytes is None:
            self._body_bytes = to_bytes(FeeBumpTransaction,
                                        self.fee_bump)
        return self._body_bytes

    def envelope_bytes(self) -> bytes:
        if self._env_bytes is None:
            p = Packer()
            EnvelopeType.pack(p, EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP)
            p.buf += self.tx_body_bytes()
            _SIGS_T.pack(p, self.envelope.value.signatures)
            self._env_bytes = p.bytes()
        return self._env_bytes

    def contents_preimage(self) -> bytes:
        """Signature-payload bytes (fee-bump form) — see the classic
        frame's ``contents_preimage``."""
        p = Packer()
        p.pack_fopaque(32, self.network_id)
        EnvelopeType.pack(p, EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP)
        p.buf += self.tx_body_bytes()
        return p.bytes()

    def contents_hash(self) -> bytes:
        if self._hash is None:
            self._hash = sha256(self.contents_preimage())
        return self._hash

    def fee_source_id(self):
        return muxed_to_account_id(self.fee_bump.feeSource)

    def source_account_id(self):
        return self.inner.source_account_id()

    @property
    def seq_num(self) -> int:
        return self.inner.seq_num

    def num_operations(self) -> int:
        return self.inner.num_operations()

    def full_fee(self) -> int:
        return self.fee_bump.fee

    def inclusion_fee(self) -> int:
        return self.full_fee() - self.inner.declared_soroban_resource_fee()

    def is_soroban(self) -> bool:
        return self.inner.is_soroban()

    def fee(self, header, base_fee: Optional[int], applying: bool) -> int:
        if base_fee is None:
            return self.full_fee()
        adjusted = base_fee * (self.num_operations() + 1)
        resource = self.inner.declared_soroban_resource_fee()
        if applying:
            return resource + min(self.inclusion_fee(), adjusted)
        return resource + adjusted

    def check_valid(self, ltx, current: int = 0, lower_offset: int = 0,
                    upper_offset: int = 0) -> MutableTxResult:
        header = ltx.header()
        result = MutableTxResult(
            fee_charged=self.fee(header, header.baseFee, applying=False))
        # outer: fee source exists, fee >= (ops+1)*baseFee and >= inner
        # full fee, signatures at low threshold
        if self.full_fee() < self.fee(header, header.baseFee,
                                      applying=False):
            result.set_code(TxCode.txINSUFFICIENT_FEE)
            return result
        # the outer fee-per-operation rate must beat the inner's:
        # outerInclusion * innerOps >= innerInclusion * outerOps
        # (reference FeeBumpTransactionFrame::commonValidPreSeqNum)
        v1 = self.inclusion_fee() * self.inner.num_operations()
        v2 = self.inner.inclusion_fee() * (self.inner.num_operations() + 1)
        if v1 < v2:
            result.set_code(TxCode.txINSUFFICIENT_FEE)
            return result
        fee_entry = ltx.load_without_record(
            account_key(self.fee_source_id()))
        if fee_entry is None:
            result.set_code(TxCode.txNO_ACCOUNT)
            return result
        checker = SignatureChecker(header.ledgerVersion,
                                   self.contents_hash(), self.signatures)
        acc = fee_entry.data.value
        if not TransactionFrame.check_signature_for_account(
                self, checker, acc, acc.thresholds[1]):
            result.set_code(TxCode.txBAD_AUTH)
            return result
        if not checker.check_all_signatures_used():
            result.set_code(TxCode.txBAD_AUTH_EXTRA)
            return result
        if get_available_balance(header, fee_entry) < self.full_fee():
            result.set_code(TxCode.txINSUFFICIENT_BALANCE)
            return result
        inner_res = self.inner.check_valid(
            ltx, current, lower_offset, upper_offset, charge_fee=False)
        if inner_res.is_success:
            result.set_code(TxCode.txFEE_BUMP_INNER_SUCCESS)
        else:
            result.set_code(TxCode.txFEE_BUMP_INNER_FAILED)
        result.inner_result = inner_res
        return result

    check_signature_for_account = TransactionFrame.check_signature_for_account

    def process_fee_seq_num(self, ltx, base_fee: Optional[int]
                            ) -> MutableTxResult:
        with LedgerTxn(ltx) as inner:
            with inner.load_header() as hh:
                header = hh.header
                fee = self.fee(header, base_fee, applying=True)
                result = MutableTxResult(fee_charged=fee)
                src = inner.load(account_key(self.fee_source_id()))
                if src is None:
                    raise RuntimeError("fee source account missing")
                acc = src.data
                if fee > 0:
                    charged = min(acc.balance, fee)
                    result.fee_charged = charged
                    acc.balance -= charged
                    header.feePool += charged
                src.deactivate()
            result.fee_changes = inner.get_changes()  # meta: feeProcessing
            inner.commit()
        self._fee_charged = result.fee_charged
        return result

    def apply(self, ltx, meta: Optional[TxApplyMeta] = None
              ) -> MutableTxResult:
        """Outer wraps the inner apply result (fee already charged in the
        fee phase; inner applies with charge_fee=False). A one-time
        pre-auth signer on the fee source is consumed first (reference
        ``FeeBumpTransactionFrame::apply`` →
        ``removeOneTimeSignerKeyFromFeeSource``)."""
        if meta is None:
            meta = TxApplyMeta()
        fee_txn = LedgerTxn(ltx)
        h = self.contents_hash()
        handle = fee_txn.load(account_key(self.fee_source_id()))
        if handle is not None:
            acc = handle.data
            doomed = [i for i, s in enumerate(acc.signers)
                      if s.key.arm ==
                      SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX
                      and s.key.value == h]
            for i in reversed(doomed):
                remove_signer_with_possible_sponsorship(
                    fee_txn, fee_txn.header(), handle.entry, i)
            handle.deactivate()
        meta.tx_changes_before.extend(fee_txn.get_changes())
        fee_txn.commit()

        inner_res = self.inner.apply(ltx, meta, charge_fee=False)
        result = MutableTxResult(
            fee_charged=getattr(self, "_fee_charged", 0))
        result.set_code(TxCode.txFEE_BUMP_INNER_SUCCESS
                        if inner_res.is_success
                        else TxCode.txFEE_BUMP_INNER_FAILED)
        result.inner_result = inner_res
        # a Soroban inner tx refunds unused resource fee to the OUTER
        # fee source, which paid it (reference FeeBump processRefund)
        from stellar_tpu_torch.ledger.ledger_txn import soroban_config_of
        refund = min(self.inner.soroban_refund_amount(
            inner_res.is_success, soroban_config_of(ltx)),
            result.fee_charged)
        if refund > 0:
            with LedgerTxn(ltx) as scope:
                src = scope.load(account_key(self.fee_source_id()))
                if src is not None:
                    src.data.balance += refund
                    src.deactivate()
                    with scope.load_header() as hh:
                        hh.header.feePool -= refund
                    result.fee_charged -= refund
                    scope.commit()
                else:
                    scope.rollback()
        return result

    def to_result_xdr(self, result: MutableTxResult) -> TransactionResult:
        from stellar_tpu_torch.xdr.results import (
            InnerTransactionResult, InnerTransactionResultPair,
        )
        inner = result.inner_result
        inner_ops = inner.op_results if inner.code in (
            TxCode.txSUCCESS, TxCode.txFAILED) else None
        ir = InnerTransactionResult(
            feeCharged=0,
            result=InnerTransactionResult._types[1].make(
                inner.code, inner_ops),
            ext=InnerTransactionResult._types[2].make(0))
        pair = InnerTransactionResultPair(
            transactionHash=self.inner.contents_hash(), result=ir)
        return tx_result(result.code, pair, result.fee_charged)


def make_transaction_frame(network_id: bytes, envelope):
    """Frame factory over any envelope arm (reference
    ``TransactionFrameBase::makeTransactionFromWire``)."""
    if envelope.arm == EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
        return FeeBumpTransactionFrame(network_id, envelope)
    return TransactionFrame(network_id, envelope)
