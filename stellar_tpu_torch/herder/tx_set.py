"""TxSetFrame: transaction-set construction, hashing, validation, and
apply ordering (reference ``src/herder/TxSetFrame.cpp``).

Pipeline (mirrors the reference's three-stage design):

* ``make_tx_set_from_transactions`` — nominate-time construction: group
  per source account in sequence order, surge-price down to the ledger's
  operation capacity, compute the discounted base fee, emit the
  GeneralizedTransactionSet XDR whose SHA-256 is the set's identity.
* ``TxSetXDRFrame`` — wire form + hash, convertible to an
  ``ApplicableTxSetFrame`` against the current ledger
  (``prepareForApply``).
* ``ApplicableTxSetFrame.check_valid`` — structural checks + per-tx
  ``checkValid``; all ed25519 signatures in the set are first verified
  in ONE device batch (``batch_verify_into_cache``), so the per-signer
  logic afterwards only hits the verify cache. This is sig hot path #3
  (``TxSetFrame.cpp:1633``) riding the device.
* ``get_txs_in_apply_order`` — per-account batches shuffled by
  hash XOR setHash (reference ``ApplyTxSorter`` /
  ``sortedForApplySequential``) so apply order is unpredictable but
  deterministic.

The port's copy of ``stellar_tpu/herder/tx_set.py``, with the port's
imports. ``prefetch_contents_hashes`` goes through the port's
``hash_many``, which raises with no card from ``MIN_DEVICE_HASH_BATCH``
frames on; the reference's falls back to ``hashlib`` there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from stellar_tpu_torch.crypto.keys import batch_verify_into_cache
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.tx.op_frame import account_key
from stellar_tpu_torch.xdr.ledger import (
    GeneralizedTransactionSet, TransactionPhase, TransactionSetV1,
    TxSetComponent, TxSetComponentType, TxSetComponentTxsMaybeDiscountedFee,
    generalized_tx_set_hash,
)
from stellar_tpu_torch.xdr.runtime import to_bytes
from stellar_tpu_torch.xdr.tx import TransactionEnvelope
from stellar_tpu_torch.xdr.types import SignerKeyType

__all__ = [
    "full_tx_hash", "fee_rate_less_than", "compute_per_op_fee",
    "make_tx_set_from_transactions", "TxSetXDRFrame",
    "ApplicableTxSetFrame", "prefetch_signature_batch",
]


def prefetch_contents_hashes(frames) -> None:
    """Batch-compute and memoize the contents hash (tx id) of every
    frame in one pass through the hash workload
    (``crypto.batch_hasher.hash_many``) — the TxSet half of the
    "bucket-list and TxSet hashing remain serial host SHA-256" item:
    catchup's recorded-results split calls ``contents_hash()`` per
    frame, which this turns into cache hits. Bit-identical (the
    workload's oracle IS hashlib); frames already hashed are skipped."""
    from stellar_tpu_torch.crypto.batch_hasher import hash_many
    todo = [f for f in frames
            if getattr(f, "_hash", None) is None
            and hasattr(f, "contents_preimage")]
    if not todo:
        return
    for f, digest in zip(todo,
                         hash_many([f.contents_preimage()
                                    for f in todo])):
        f._hash = digest


def full_tx_hash(frame) -> bytes:
    """Hash of the whole envelope incl. signatures (reference
    ``getFullHash``) — distinct from the contents hash. Memoized on the
    frame (hot: sorting, apply ordering, canonical-order checks)."""
    h = getattr(frame, "_full_hash", None)
    if h is None:
        eb = getattr(frame, "envelope_bytes", None)
        h = sha256(eb() if eb is not None
                   else to_bytes(TransactionEnvelope, frame.envelope))
        frame._full_hash = h
    return h


def fee_rate_less_than(a, b) -> bool:
    """a bids a strictly lower fee-per-op than b (reference
    ``feeRate3WayCompare``: cross-multiplied, overflow-free)."""
    return a.inclusion_fee() * b.num_operations() < \
        b.inclusion_fee() * a.num_operations()


def compute_per_op_fee(frame) -> int:
    """Inclusion fee per operation, rounded down (current protocol;
    reference ``computePerOpFee``)."""
    return frame.inclusion_fee() // max(1, frame.num_operations())


def _xored(h: bytes, set_hash: bytes) -> bytes:
    return bytes(a ^ b for a, b in zip(h, set_hash))


def _build_account_queues(frames) -> Dict[bytes, List]:
    """Per-source-account tx lists in ascending seq order (reference
    ``TxSetUtils::buildAccountTxQueues``)."""
    queues: Dict[bytes, List] = {}
    for f in frames:
        aid = f.source_account_id().value
        queues.setdefault(aid, []).append(f)
    for q in queues.values():
        q.sort(key=lambda f: f.seq_num)
    return queues


DEX_OP_TYPES = None  # lazily-built frozenset of OperationType values


def _is_dex_tx(frame) -> bool:
    """True when any op trades against the order book (reference
    ``TxSetUtils::hasDexOperations``)."""
    global DEX_OP_TYPES
    if DEX_OP_TYPES is None:
        from stellar_tpu_torch.xdr.tx import OperationType as OT
        DEX_OP_TYPES = frozenset({
            OT.MANAGE_SELL_OFFER, OT.MANAGE_BUY_OFFER,
            OT.CREATE_PASSIVE_SELL_OFFER,
            OT.PATH_PAYMENT_STRICT_RECEIVE,
            OT.PATH_PAYMENT_STRICT_SEND,
        })
    inner = getattr(frame, "inner", frame)
    return any(op.body.arm in DEX_OP_TYPES
               for op in inner.tx.operations)


def make_tx_set_from_transactions(
        frames: Sequence, lcl_header, lcl_hash: bytes,
        soroban_config=None, parallel_soroban: Optional[bool] = None,
        max_dex_ops: Optional[int] = None,
) -> Tuple["ApplicableTxSetFrame", List]:
    """Build a valid (surge-priced) tx set from candidate frames.

    Returns (applicable_frame, excluded_frames). Two phases (reference
    generalized tx sets from protocol 20): the CLASSIC phase is limited
    in operations by ``lcl_header.maxTxSetSize``; the SOROBAN phase in
    transactions by the network config's per-ledger cap. Each phase
    surge-prices independently: when it overflows, lowest-fee-rate
    account tails are trimmed and that phase's discounted base fee
    becomes the lowest included per-op bid (reference
    ``makeTxSetFromTransactions`` + ``SurgePricingPriorityQueue`` +
    ``computeLaneBaseFee``).

    ``parallel_soroban`` (default: ledgerVersion >= 23) emits the
    soroban phase in the PARALLEL representation: footprint-disjoint
    conflict clusters packed into sequential stages (reference
    ``TxSetFrame.cpp:677-903`` building stages/clusters) — the
    device-side batch hook: clusters of one stage are data-parallel.
    """
    from stellar_tpu_torch.herder.surge_pricing import (
        SurgePricingLaneConfig, SurgePricingPriorityQueue,
    )
    from stellar_tpu_torch.protocol import SOROBAN_PROTOCOL_VERSION

    classic = [f for f in frames if not f.is_soroban()]
    soroban = [f for f in frames if f.is_soroban()]

    if max_dex_ops is not None:
        # DEX lane (reference MAX_DEX_TX_OPERATIONS_IN_TX_SET): order-
        # book-touching txs additionally cap at lane 1. (The wire form
        # stays single-component: the cap is enforced at construction;
        # per-lane discounted components are not emitted.)
        lane_cfg = SurgePricingLaneConfig(
            [lcl_header.maxTxSetSize, max_dex_ops],
            lane_of=lambda f: 1 if _is_dex_tx(f) else 0)
    else:
        lane_cfg = SurgePricingLaneConfig([lcl_header.maxTxSetSize])
    inc_c, exc_c, full_c = \
        SurgePricingPriorityQueue.most_top_txs_within_limits(
            classic, lane_cfg)
    base_fee_c = SurgePricingPriorityQueue.lane_base_fee(
        inc_c, lcl_header.baseFee, bool(full_c))

    soroban_phase = lcl_header.ledgerVersion >= SOROBAN_PROTOCOL_VERSION
    inc_s: List = []
    excluded = list(exc_c)
    base_fee_s = lcl_header.baseFee
    if soroban_phase:
        if soroban_config is None:
            from stellar_tpu_torch.tx.ops.soroban_ops import (
                default_soroban_config,
            )
            soroban_config = default_soroban_config()
        cap = soroban_config.ledger_max_tx_count
        inc_s, exc_s, full_s = \
            SurgePricingPriorityQueue.most_top_txs_within_limits(
                soroban, SurgePricingLaneConfig(
                    [cap], resources_of=lambda f: 1))
        inc_s, over_cap = _enforce_soroban_ledger_caps(
            inc_s, soroban_config)
        exc_s = list(exc_s) + over_cap
        base_fee_s = SurgePricingPriorityQueue.lane_base_fee(
            inc_s, lcl_header.baseFee, bool(full_s) or bool(over_cap))
        excluded.extend(exc_s)
    else:
        excluded.extend(soroban)

    if parallel_soroban is None:
        from stellar_tpu_torch.protocol import (
            PARALLEL_SOROBAN_PHASE_PROTOCOL_VERSION,
        )
        parallel_soroban = soroban_phase and \
            lcl_header.ledgerVersion >= \
            PARALLEL_SOROBAN_PHASE_PROTOCOL_VERSION
    stages = None
    if parallel_soroban and soroban_phase:
        stages = _build_parallel_stages(inc_s, soroban_config)
    xdr_set = _to_generalized_xdr(inc_c, base_fee_c, inc_s, base_fee_s,
                                  lcl_hash, soroban_phase,
                                  parallel_stages=stages)
    discounts = {id(f): base_fee_c for f in inc_c}
    discounts.update({id(f): base_fee_s for f in inc_s})
    applicable = ApplicableTxSetFrame(xdr_set, inc_c + inc_s, discounts,
                                      soroban_frames=inc_s,
                                      parallel_stages=stages)
    return applicable, excluded


def _parallel_footprint(f) -> Tuple[set, set]:
    """(written_kbs, touched_kbs) for conflict analysis. The source and
    fee-source account keys count as writes: two txs from one account
    mutate its sequence number, so they must serialize in one cluster
    (the reference's per-account soroban queue limit makes this rare,
    but a built set must stay correct without it)."""
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.tx.op_frame import account_key
    from stellar_tpu_torch.xdr.types import LedgerKey
    inner = getattr(f, "inner", f)
    fp = inner.tx.ext.value.resources.footprint
    rw = {to_bytes(LedgerKey, k) for k in fp.readWrite}
    ro = {to_bytes(LedgerKey, k) for k in fp.readOnly}
    rw.add(key_bytes(account_key(f.source_account_id())))
    if hasattr(f, "fee_source_id"):
        rw.add(key_bytes(account_key(f.fee_source_id())))
    return rw, rw | ro


def _cluster_order(members: List) -> List:
    """Deterministic in-cluster order: cross-account positions follow
    full-hash order, but each account's own txs fill its positions in
    ascending sequence order — a cluster is a dependency chain, and a
    same-account pair hash-ordered backwards would fail bad-seq at
    validation (code-review r3 finding)."""
    hashed = _sorted_in_hash_order(members)
    by_acct: Dict[bytes, List] = {}
    for f in hashed:
        by_acct.setdefault(f.source_account_id().value, []).append(f)
    for q in by_acct.values():
        q.sort(key=lambda f: f.seq_num)
    taken: Dict[bytes, int] = {}
    out = []
    for f in hashed:
        acct = f.source_account_id().value
        i = taken.get(acct, 0)
        taken[acct] = i + 1
        out.append(by_acct[acct][i])
    return out


def _build_parallel_stages(frames: Sequence, config) -> List[List[List]]:
    """Partition soroban frames into conflict clusters (union-find over
    footprint overlap: a WRITE by one tx against any touch by another
    conflicts) and pack clusters into stages bounded by the network's
    dependent-cluster cap. Deterministic: cluster members and clusters
    order by full tx hash (reference ``TxSetFrame.cpp:677-903``)."""
    if not frames:
        return []
    n = len(frames)
    parent = list(range(n))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i: int, j: int):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri

    fps = [_parallel_footprint(f) for f in frames]
    touchers: Dict[bytes, List[int]] = {}
    writers: Dict[bytes, List[int]] = {}
    for i, (rw, touched) in enumerate(fps):
        for kb in touched:
            touchers.setdefault(kb, []).append(i)
        for kb in rw:
            writers.setdefault(kb, []).append(i)
    for kb, ws in writers.items():
        anchor = ws[0]
        for i in touchers.get(kb, ()):
            union(anchor, i)

    by_root: Dict[int, List] = {}
    for i in range(n):
        by_root.setdefault(find(i), []).append(frames[i])
    clusters = [_cluster_order(members) for members in by_root.values()]
    clusters.sort(key=lambda cl: full_tx_hash(cl[0]))
    max_clusters = max(1, getattr(config,
                                  "ledger_max_dependent_tx_clusters", 8))
    return [clusters[i:i + max_clusters]
            for i in range(0, len(clusters), max_clusters)]


def _sorted_in_hash_order(frames) -> List:
    # canonical wire order is by FULL envelope hash (reference
    # ``TxSetUtils::sortTxsInHashOrder`` uses getFullHash)
    return sorted(frames, key=full_tx_hash)


def _phase_xdr(frames, base_fee: int):
    comp = TxSetComponent.make(
        TxSetComponentType.TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE,
        TxSetComponentTxsMaybeDiscountedFee(
            baseFee=base_fee,
            txs=[f.envelope for f in _sorted_in_hash_order(frames)]))
    return TransactionPhase.make(0, [comp] if frames else [])


def _to_generalized_xdr(classic, base_fee_c: int, soroban, base_fee_s: int,
                        lcl_hash: bytes, soroban_phase: bool,
                        parallel_stages=None):
    """Phase 0 = classic, phase 1 = soroban (reference generalized tx
    set layout from protocol 20; single phase before). With
    ``parallel_stages`` the soroban phase is the parallel
    representation (stages of independent clusters)."""
    phases = [_phase_xdr(classic, base_fee_c)]
    if soroban_phase:
        if parallel_stages is not None:
            from stellar_tpu_torch.xdr.ledger import ParallelTxsComponent
            phases.append(TransactionPhase.make(1, ParallelTxsComponent(
                baseFee=base_fee_s,
                executionStages=[
                    [[f.envelope for f in cluster] for cluster in stage]
                    for stage in parallel_stages])))
        else:
            phases.append(_phase_xdr(soroban, base_fee_s))
    return GeneralizedTransactionSet.make(
        1, TransactionSetV1(previousLedgerHash=lcl_hash, phases=phases))


class TxSetXDRFrame:
    """Wire-form tx set: XDR + content hash; parse-on-demand
    (reference ``TxSetXDRFrame``)."""

    def __init__(self, xdr_set):
        self.xdr = xdr_set
        self.hash = generalized_tx_set_hash(xdr_set)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TxSetXDRFrame":
        from stellar_tpu_torch.xdr.runtime import from_bytes
        return cls(from_bytes(GeneralizedTransactionSet, raw))

    def prepare_for_apply(self, network_id: bytes
                          ) -> Optional["ApplicableTxSetFrame"]:
        """Parse envelopes into frames (reference ``prepareForApply``);
        None on malformed contents."""
        from stellar_tpu_torch.tx.transaction_frame import (
            make_transaction_frame,
        )
        try:
            frames = []
            discounts = {}
            soroban_frames = []
            parallel_stages = None
            v1 = self.xdr.value
            for phase_i, phase in enumerate(v1.phases):
                if phase.arm == 1:
                    # parallel Soroban phase: sequential stages of
                    # independent clusters (reference TxSetFrame.h:192-
                    # 254); only valid as the soroban phase
                    if phase_i != 1:
                        return None
                    comp = phase.value
                    parallel_stages = []
                    for stage in comp.executionStages:
                        # structurally invalid: empty stages/clusters
                        # (reference validateParallelComponent) — also
                        # preserves hash-uniqueness of contents
                        if not stage or any(not c for c in stage):
                            return None
                        stage_frames = []
                        for cluster in stage:
                            cluster_frames = []
                            for env in cluster:
                                f = make_transaction_frame(network_id,
                                                           env)
                                frames.append(f)
                                soroban_frames.append(f)
                                discounts[id(f)] = comp.baseFee
                                cluster_frames.append(f)
                            stage_frames.append(cluster_frames)
                        parallel_stages.append(stage_frames)
                    continue
                for comp in phase.value:
                    for env in comp.value.txs:
                        f = make_transaction_frame(network_id, env)
                        frames.append(f)
                        discounts[id(f)] = comp.value.baseFee
                        if phase_i == 1:
                            soroban_frames.append(f)
            return ApplicableTxSetFrame(self.xdr, frames, discounts,
                                        precomputed_hash=self.hash,
                                        soroban_frames=soroban_frames,
                                        parallel_stages=parallel_stages)
        except Exception:
            return None


class ApplicableTxSetFrame:
    """A parsed tx set pinned to the ledger it applies to (reference
    ``ApplicableTxSetFrame``)."""

    def __init__(self, xdr_set, frames: Sequence, discounts: Dict,
                 precomputed_hash: Optional[bytes] = None,
                 soroban_frames: Sequence = (),
                 parallel_stages=None):
        self.xdr = xdr_set
        self.frames = list(frames)
        self._discounts = discounts  # id(frame) -> Optional[baseFee]
        self._soroban_ids = {id(f) for f in soroban_frames}
        # stages -> clusters -> frames when the soroban phase is the
        # parallel representation (protocol 23+ sets); apply is still
        # sequential in this snapshot (reference LedgerManagerImpl
        # .cpp:1619-1689) but stage/cluster order is preserved
        self.parallel_stages = parallel_stages
        self.hash = precomputed_hash if precomputed_hash is not None \
            else generalized_tx_set_hash(xdr_set)

    @property
    def previous_ledger_hash(self) -> bytes:
        return self.xdr.value.previousLedgerHash

    def base_fee_for(self, frame) -> Optional[int]:
        """The discounted base fee this tx applies under (None = bid)."""
        return self._discounts.get(id(frame))

    def size_op(self) -> int:
        """Classic-phase operation count (the maxTxSetSize axis)."""
        return sum(max(1, f.num_operations()) for f in self.frames
                   if id(f) not in self._soroban_ids)

    def size_tx(self) -> int:
        return len(self.frames)

    def soroban_tx_count(self) -> int:
        return len(self._soroban_ids)

    # ---------------- validation ----------------

    def check_valid(self, ltx, lcl_hash: bytes,
                    lower_offset: int = 0, upper_offset: int = 0) -> bool:
        """Full set validation against the current ledger (reference
        ``ApplicableTxSetFrame::checkValid``)."""
        if self.previous_ledger_hash != lcl_hash:
            return False
        header = ltx.header()
        if self.size_op() > header.maxTxSetSize:
            return False
        from stellar_tpu_torch.ledger.ledger_txn import soroban_config_of
        # per-ledger soroban aggregate access caps bind RECEIVED sets
        # too — a peer-built set over the caps must not validate
        # (order-independent sum check; the builder uses the greedy
        # priority walk)
        if _soroban_ledger_caps_exceeded(
                [f for f in self.frames if id(f) in self._soroban_ids],
                soroban_config_of(ltx)):
            return False
        if self.soroban_tx_count() > \
                soroban_config_of(ltx).ledger_max_tx_count:
            return False
        # soroban txs may only ride the soroban phase and vice versa
        for f in self.frames:
            if f.is_soroban() != (id(f) in self._soroban_ids):
                return False
        if self.parallel_stages is not None:
            # the parallel representation is a protocol-23 construct:
            # accepting it earlier would diverge from the network
            # (reference gates on PARALLEL_SOROBAN_PHASE_PROTOCOL_
            # VERSION), and each stage is bounded by the dependent-
            # cluster cap
            from stellar_tpu_torch.protocol import (
                PARALLEL_SOROBAN_PHASE_PROTOCOL_VERSION,
            )
            if header.ledgerVersion < \
                    PARALLEL_SOROBAN_PHASE_PROTOCOL_VERSION:
                return False
            max_clusters = soroban_config_of(
                ltx).ledger_max_dependent_tx_clusters
            if any(len(stage) > max_clusters
                   for stage in self.parallel_stages):
                return False
        # discounted base fee must not be below the protocol minimum
        by_env = {id(f.envelope): full_tx_hash(f) for f in self.frames
                  if not (self.parallel_stages is not None and
                          id(f) in self._soroban_ids)}
        for phase in self.xdr.value.phases:
            if phase.arm == 1:
                bf = phase.value.baseFee
                if bf is not None and bf < header.baseFee:
                    return False
                # clusters are dependency chains, not hash-ordered
                continue
            for comp in phase.value:
                bf = comp.value.baseFee
                if bf is not None and bf < header.baseFee:
                    return False
                # wire order must be canonical (hash-sorted) so the set
                # hash is unique for its contents; envelopes are the
                # frames' own objects, so reuse their memoized hashes
                hashes = [by_env.get(id(e)) or
                          sha256(to_bytes(TransactionEnvelope, e))
                          for e in comp.value.txs]
                if hashes != sorted(hashes):
                    return False
        # every tx must bid at least the component's discounted rate
        # (reference checkValid, TxSetFrame.cpp:1678-1686)
        for f in self.frames:
            bf = self.base_fee_for(f)
            if bf is not None and \
                    f.inclusion_fee() < bf * max(1, f.num_operations()):
                return False
        # keep the collected triples on the set: close_ledger re-seeds
        # from THEM (one cheap batch call that re-verifies anything the
        # bounded cache evicted since validation) instead of re-walking
        # frames and re-loading accounts
        self.sig_triples = prefetch_signature_batch(ltx, self.frames)
        from stellar_tpu_torch.xdr.results import TransactionResultCode as TC
        # per-account chains: each tx validates against its predecessor's
        # seq num (reference ``TxSetUtils::getInvalidTxList``); gaps
        # allowed only where a minSeqNum precondition admits them —
        # is_bad_seq decides, not a set-level rule. The chain must be
        # checked in APPLY order: sorted queues for sequential phases,
        # declared cluster order for a parallel soroban phase (clusters
        # are dependency chains — a descending-seq cluster must fail
        # here, not at apply).
        if self.parallel_stages is not None:
            classic = [f for f in self.frames
                       if id(f) not in self._soroban_ids]
            queues = _build_account_queues(classic)
            for stage in self.parallel_stages:
                for cluster in stage:
                    for f in cluster:
                        queues.setdefault(
                            f.source_account_id().value, []).append(f)
        else:
            queues = _build_account_queues(self.frames)
        for q in queues.values():
            current = 0
            for f in q:
                res = f.check_valid(ltx, current, lower_offset,
                                    upper_offset)
                if res.code not in (TC.txSUCCESS,
                                    TC.txFEE_BUMP_INNER_SUCCESS):
                    return False
                current = f.seq_num
        return True

    # ---------------- apply order ----------------

    def get_txs_in_apply_order(self) -> List:
        """Reference ``sortedForApplySequential`` applied per phase:
        classic applies first, then the soroban phase. A parallel
        soroban phase applies stage by stage, clusters in declared
        order (each cluster is a dependency chain)."""
        classic = [f for f in self.frames
                   if id(f) not in self._soroban_ids]
        out = self._phase_apply_order(classic)
        if self.parallel_stages is not None:
            for stage in self.parallel_stages:
                for cluster in stage:
                    out.extend(cluster)
            return out
        soroban = [f for f in self.frames if id(f) in self._soroban_ids]
        return out + self._phase_apply_order(soroban)

    def _phase_apply_order(self, frames) -> List:
        """Round-robin account batches, each shuffled by full-hash XOR
        set-hash."""
        queues = list(_build_account_queues(frames).values())
        batches: List[List] = []
        while queues:
            batch = []
            nxt = []
            for q in queues:
                batch.append(q.pop(0))
                if q:
                    nxt.append(q)
            queues = nxt
            batches.append(batch)
        out: List = []
        for batch in batches:
            batch.sort(key=lambda f: _xored(full_tx_hash(f), self.hash))
            out.extend(batch)
        return out

    def summary(self) -> str:
        return (f"txset(txs={self.size_tx()}, ops={self.size_op()}, "
                f"hash={self.hash.hex()[:8]})")


def _declared_access(f):
    res = (f.inner if hasattr(f, "inner") else f) \
        .tx.ext.value.resources
    return (len(res.footprint.readOnly) + len(res.footprint.readWrite),
            res.readBytes,
            len(res.footprint.readWrite),
            res.writeBytes)


def _soroban_ledger_caps_exceeded(frames, cfg) -> bool:
    """Do the set's declared aggregates exceed the per-ledger caps?"""
    caps = (cfg.ledger_max_read_ledger_entries,
            cfg.ledger_max_read_bytes,
            cfg.ledger_max_write_ledger_entries,
            cfg.ledger_max_write_bytes)
    totals = [0, 0, 0, 0]
    for f in frames:
        for i, d in enumerate(_declared_access(f)):
            totals[i] += d
    return any(t > c for t, c in zip(totals, caps))


def _enforce_soroban_ledger_caps(frames, cfg):
    """Greedy per-LEDGER aggregate access caps over the soroban phase
    (reference ledgerMaxRead*/ledgerMaxWrite* set-building limits):
    walk the already-priority-ordered selection and drop anything that
    would push a declared aggregate over its cap."""
    caps = (cfg.ledger_max_read_ledger_entries,
            cfg.ledger_max_read_bytes,
            cfg.ledger_max_write_ledger_entries,
            cfg.ledger_max_write_bytes)
    used = [0, 0, 0, 0]
    kept, dropped = [], []
    for f in frames:
        decl = _declared_access(f)
        if all(u + d <= c for u, d, c in zip(used, decl, caps)):
            for i, d in enumerate(decl):
                used[i] += d
            kept.append(f)
        else:
            dropped.append(f)
    return kept, dropped


def prefetch_signature_batch(ltx, frames) -> list:
    """Collect every plausible (pubkey, payload, signature) triple in the
    set and verify them in one device batch, seeding the verify cache.
    Returns the collected triples so callers can re-seed later without
    re-collecting."""
    items = collect_signature_triples(ltx, frames)
    batch_verify_into_cache(items)
    return items


def collect_signature_triples(ltx, frames) -> list:
    """Every plausible (pubkey, payload, signature) triple in the set.

    Candidates per tx: master key + account signers of the tx source,
    every op source, the fee source (fee bumps), and extraSigners —
    filtered by the 4-byte hint.
    """
    items = []
    # one account load per DISTINCT account for the whole set — the
    # collection must stay O(accounts) loads, not O(sigs x accounts)
    # (each load copies the entry)
    acct_cache: dict = {}

    def acct_for(account_id_v):
        k = account_id_v.value  # ed25519 bytes identify the account
        if k not in acct_cache:
            entry = ltx.load_without_record(account_key(account_id_v))
            acct_cache[k] = None if entry is None else entry.data.value
        return acct_cache[k]

    for f in frames:
        inner_frames = [f]
        if hasattr(f, "inner"):  # fee bump: outer + inner
            for sig in f.signatures:
                _collect_for_account(
                    acct_for(f.fee_source_id()), f.contents_hash(),
                    sig, items)
            inner_frames = [f.inner]
        for tf in inner_frames:
            h = tf.contents_hash()
            account_ids = [tf.source_account_id()]
            for op in tf.op_frames:
                aid = op.source_account_id()
                if aid not in account_ids:
                    account_ids.append(aid)
            accts = [acct_for(aid) for aid in account_ids]
            for sig in tf.signatures:
                for acc in accts:
                    _collect_for_account(acc, h, sig, items)
                for sk in tf.extra_signers():
                    _collect_for_signer_key(sk, h, sig, items)
    return items


def _collect_for_account(acc, h: bytes, sig, items):
    from stellar_tpu_torch.tx.signature_utils import does_hint_match
    if acc is None:
        return
    pk = acc.accountID.value
    if does_hint_match(pk, sig.hint):
        items.append((pk, h, sig.signature))
    for s in acc.signers:
        _collect_for_signer_key(s.key, h, sig, items)


def _collect_for_signer_key(key, h: bytes, sig, items):
    from stellar_tpu_torch.tx.signature_utils import (
        does_hint_match, signed_payload_hint,
    )
    if key.arm == SignerKeyType.SIGNER_KEY_TYPE_ED25519:
        if does_hint_match(key.value, sig.hint):
            items.append((key.value, h, sig.signature))
    elif key.arm == SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD:
        if sig.hint == signed_payload_hint(key.value):
            items.append((key.value.ed25519, key.value.payload,
                          sig.signature))
