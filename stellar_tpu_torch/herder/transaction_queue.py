"""TransactionQueue: pre-consensus admission + per-account pending
chains (reference ``src/herder/TransactionQueue.h:44-137``).

Semantics kept: per-source-account sequence chains, fee-based
replace-by-fee (new tx must bid >= FEE_MULTIPLIER x the old), size
limiting in operations with lowest-fee eviction, ageing — a tx's account
is banned for ``BAN_LEDGERS`` ledgers when its txs sit unincluded for
``PENDING_DEPTH`` ledgers ("shift" per close).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

__all__ = ["TransactionQueue", "AddResult"]


class AddResult:
    ADD_STATUS_PENDING = 0
    ADD_STATUS_DUPLICATE = 1
    ADD_STATUS_ERROR = 2
    ADD_STATUS_TRY_AGAIN_LATER = 3
    ADD_STATUS_BANNED = 4
    ADD_STATUS_FILTERED = 5

    def __init__(self, code: int, tx_result=None):
        self.code = code
        self.tx_result = tx_result


FEE_MULTIPLIER = 10  # reference TransactionQueue::FEE_MULTIPLIER


class TransactionQueue:
    PENDING_DEPTH = 4   # ledgers a tx may age in the queue
    BAN_LEDGERS = 10    # reference default ban depth

    def __init__(self, max_ops: int,
                 check_valid: Callable,
                 pending_depth: int = PENDING_DEPTH,
                 ban_ledgers: int = BAN_LEDGERS,
                 excluded_op_types=frozenset()):
        self.max_ops = max_ops
        # (frame, current_seq) -> MutableTxResult; current_seq 0 means
        # "use the account's ledger seq"
        self.check_valid = check_valid
        self.pending_depth = pending_depth
        self.ban_ledgers = ban_ledgers
        # OperationType values refused at admission (reference
        # EXCLUDE_TRANSACTIONS_CONTAINING_OPERATION_TYPE)
        self.excluded_op_types = frozenset(excluded_op_types)
        # account raw key -> list of frames in seq order (+ age)
        self.accounts: Dict[bytes, List] = {}
        self.ages: Dict[bytes, int] = {}
        self.known_hashes: Dict[bytes, object] = {}
        self.banned: Dict[bytes, int] = {}  # tx hash -> ledgers left

    # ---------------- introspection ----------------

    def size_ops(self) -> int:
        return sum(max(1, f.num_operations())
                   for q in self.accounts.values() for f in q)

    def get_transactions(self) -> List:
        return [f for q in self.accounts.values() for f in q]

    def contains(self, frame) -> bool:
        return frame.contents_hash() in self.known_hashes

    # ---------------- admission ----------------

    def try_add(self, frame) -> AddResult:
        """Reference ``TransactionQueue::tryAdd``."""
        h = frame.contents_hash()
        if h in self.banned:
            return AddResult(AddResult.ADD_STATUS_BANNED)
        if h in self.known_hashes:
            return AddResult(AddResult.ADD_STATUS_DUPLICATE)
        if self.excluded_op_types:
            inner = getattr(frame, "inner", frame)
            if any(op.body.arm in self.excluded_op_types
                   for op in inner.tx.operations):
                return AddResult(AddResult.ADD_STATUS_FILTERED)

        acc = frame.source_account_id().value
        chain = self.accounts.get(acc, [])

        # validate against the predecessor's seq (the chain tail), not
        # the ledger's — chain extensions are the point of the queue
        current_seq = 0
        if chain and frame.seq_num == chain[-1].seq_num + 1:
            current_seq = chain[-1].seq_num
        res = self.check_valid(frame, current_seq)
        if not _ok(res):
            return AddResult(AddResult.ADD_STATUS_ERROR, res)

        # seq chain: must extend the chain or replace-by-fee an entry
        replaced = None
        if chain:
            last = chain[-1]
            if frame.seq_num == last.seq_num + 1:
                pass  # extends
            else:
                for i, old in enumerate(chain):
                    if old.seq_num == frame.seq_num:
                        if frame.full_fee() < \
                                old.full_fee() * FEE_MULTIPLIER:
                            return AddResult(
                                AddResult.ADD_STATUS_TRY_AGAIN_LATER)
                        replaced = i
                        break
                else:
                    return AddResult(AddResult.ADD_STATUS_TRY_AGAIN_LATER)

        # capacity: evict lowest-fee-rate tail or reject
        new_ops = max(1, frame.num_operations())
        if replaced is None and self.size_ops() + new_ops > self.max_ops:
            if not self._evict_for(frame, new_ops):
                return AddResult(AddResult.ADD_STATUS_TRY_AGAIN_LATER)

        if replaced is not None:
            old = chain[replaced]
            del self.known_hashes[old.contents_hash()]
            chain[replaced] = frame
        else:
            chain = self.accounts.setdefault(acc, chain)
            if not chain:
                self.accounts[acc] = chain
            chain.append(frame)
            self.ages.setdefault(acc, 0)
        self.known_hashes[h] = frame
        return AddResult(AddResult.ADD_STATUS_PENDING)

    def _evict_for(self, frame, need_ops: int) -> bool:
        """Evict strictly-lower-fee-rate txs to make room; False if the
        newcomer doesn't outbid anyone."""
        from stellar_tpu_torch.herder.tx_set import fee_rate_less_than
        victims = []
        freed = 0
        # consider account tails with lower fee rate than the newcomer —
        # never the newcomer's own chain (evicting its predecessor would
        # orphan its sequence)
        self_acc = frame.source_account_id().value
        flat = [(q[-1], acc) for acc, q in self.accounts.items()
                if q and acc != self_acc]
        flat.sort(key=lambda t: t[0].inclusion_fee() /
                  max(1, t[0].num_operations()))
        for old, acc in flat:
            if not fee_rate_less_than(old, frame):
                break
            victims.append((old, acc))
            freed += max(1, old.num_operations())
            if self.size_ops() + need_ops - freed <= self.max_ops:
                for v, a in victims:
                    self._remove_tx(v, a)
                return True
        return False

    def _remove_tx(self, frame, acc: bytes):
        chain = self.accounts.get(acc, [])
        if frame in chain:
            # dropping mid-chain invalidates successors too
            i = chain.index(frame)
            for f in chain[i:]:
                self.known_hashes.pop(f.contents_hash(), None)
            del chain[i:]
        if not chain:
            self.accounts.pop(acc, None)
            self.ages.pop(acc, None)

    # ---------------- ledger-close bookkeeping ----------------

    def remove_applied(self, frames: List):
        """Drop txs included in a ledger; reset their accounts' age."""
        for f in frames:
            h = f.contents_hash()
            known = self.known_hashes.pop(h, None)
            acc = f.source_account_id().value
            chain = self.accounts.get(acc)
            if chain:
                kept = [x for x in chain
                        if x.seq_num > f.seq_num]
                for x in chain:
                    if x.seq_num <= f.seq_num and x is not known:
                        self.known_hashes.pop(x.contents_hash(), None)
                if kept:
                    self.accounts[acc] = kept
                else:
                    self.accounts.pop(acc, None)
                    self.ages.pop(acc, None)
            if acc in self.ages:
                self.ages[acc] = 0

    def shift(self):
        """Per-close ageing: old accounts' txs get banned + dropped
        (reference ``TransactionQueue::shift``)."""
        self.banned = {h: n - 1 for h, n in self.banned.items() if n > 1}
        for acc in list(self.accounts):
            self.ages[acc] = self.ages.get(acc, 0) + 1
            if self.ages[acc] >= self.pending_depth:
                for f in self.accounts[acc]:
                    h = f.contents_hash()
                    self.known_hashes.pop(h, None)
                    self.banned[h] = self.ban_ledgers
                self.accounts.pop(acc)
                self.ages.pop(acc)

    def is_banned(self, tx_hash: bytes) -> bool:
        return tx_hash in self.banned


def _ok(res) -> bool:
    from stellar_tpu_torch.xdr.results import TransactionResultCode as TC
    return res.code in (TC.txSUCCESS, TC.txFEE_BUMP_INNER_SUCCESS)
