"""LedgerManager: the ledger-close pipeline (reference
``src/ledger/LedgerManagerImpl.cpp`` — ``closeLedger`` is the 7-step
dance at ``:804-1122``).

``close_ledger`` takes externalized close data (tx set + close time +
upgrades), applies it to the last closed ledger, and advances the chain:

1. sanity: seq is LCL+1, tx set binds to the LCL hash;
2. header roll-forward (seq, scpValue, previousLedgerHash);
3. fee + seq-num phase for every tx in apply order
   (``processFeesSeqNums``);
4. per-tx apply (``applyTransactions``) collecting results + meta;
5. txSetResultHash = SHA-256 of the TransactionResultSet XDR;
6. upgrades (protocol version / base fee / max set size / base reserve);
7. state hash + skip list, commit, LCL advance.

The state hash is computed by the pluggable ``state_hasher`` — a direct
SHA-256 over the sorted committed store until the BucketList lands, then
the 11-level bucket list hash (same header field either way).

The port's copy of ``stellar_tpu/ledger/ledger_manager.py``, with the
port's imports."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.ledger.ledger_txn import (
    LedgerTxn, LedgerTxnRoot, copy_header,
)
from stellar_tpu_torch.xdr.ledger import (
    LedgerHeader, LedgerUpgrade, LedgerUpgradeType, StellarValue,
    basic_stellar_value, ledger_header_hash,
)
from stellar_tpu_torch.xdr.results import (
    TransactionResultPair, TransactionResultSet,
)
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import LedgerEntry as LedgerEntry_t

__all__ = ["LedgerCloseData", "CloseLedgerResult", "LedgerManager",
           "hash_store_state"]

# reference BucketManager.h skip cadence
SKIP_1, SKIP_2, SKIP_3, SKIP_4 = 50, 5000, 50000, 500000

# close-meta emission shape (reference EMIT_LEDGER_CLOSE_META_EXT_V1 /
# EMIT_SOROBAN_TRANSACTION_META_EXT_V1; pushed from Config): V1 exts
# add the soroban fee-write rate / per-tx fee breakdown for meta
# consumers
EMIT_LEDGER_CLOSE_META_EXT_V1 = False
EMIT_SOROBAN_TX_META_EXT_V1 = False


@dataclass
class LedgerCloseData:
    """What consensus externalizes for one slot (reference
    ``LedgerCloseData``)."""
    ledger_seq: int
    tx_set: "ApplicableTxSetFrame"
    close_time: int
    upgrades: Sequence = ()


@dataclass
class CloseLedgerResult:
    header: LedgerHeader
    header_hash: bytes
    tx_results: List = field(default_factory=list)
    tx_metas: List = field(default_factory=list)
    # canonical TransactionResultPair per applied tx (what history
    # publishes and txSetResultHash commits to)
    result_pairs: List = field(default_factory=list)
    applied_count: int = 0
    failed_count: int = 0


def hash_store_state(store) -> bytes:
    """Deterministic hash of the committed store: SHA-256 over sorted
    (key, entry) pairs. Stand-in with the same determinism contract as
    the bucket list hash (``bucket/readme.md:23-26``)."""
    import hashlib
    h = hashlib.sha256()
    for kb in sorted(store.entries):
        h.update(kb)
        h.update(store.entries[kb])
    return h.digest()


def prefetch_apply_keys(store, frames) -> int:
    """Collect every ledger key a tx set's fee+apply phases will read —
    tx/fee/op source accounts, soroban footprint entries and their TTL
    rows — and warm the store's prefetch cache with one batched sweep.
    No-op on stores without a prefetch path (dict-backed tests).
    Returns the number of keys handed to the store."""
    prefetch = getattr(store, "prefetch", None)
    if prefetch is None or not frames:
        return 0
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.soroban.host import ttl_key_for
    from stellar_tpu_torch.tx.op_frame import account_key
    from stellar_tpu_torch.xdr.types import LedgerKey
    kbs = set()
    for f in frames:
        kbs.add(key_bytes(account_key(f.source_account_id())))
        if hasattr(f, "fee_source_id"):
            kbs.add(key_bytes(account_key(f.fee_source_id())))
        inner = getattr(f, "inner", f)
        for op in inner.tx.operations:
            if op.sourceAccount is not None:
                from stellar_tpu_torch.xdr.tx import muxed_to_account_id
                kbs.add(key_bytes(account_key(
                    muxed_to_account_id(op.sourceAccount))))
        if f.is_soroban():
            fp = inner.tx.ext.value.resources.footprint
            for lk in list(fp.readOnly) + list(fp.readWrite):
                kbs.add(to_bytes(LedgerKey, lk))
                kbs.add(key_bytes(ttl_key_for(lk)))
    prefetch(kbs)
    return len(kbs)


class LedgerManager:
    """Owns the LCL and the close pipeline for one node."""

    def __init__(self, network_id: bytes,
                 root: Optional[LedgerTxnRoot] = None,
                 state_hasher: Optional[Callable] = None,
                 bucket_list=None, persistence=None):
        self.network_id = network_id
        self.root = root if root is not None else LedgerTxnRoot()
        self.state_hasher = state_hasher or hash_store_state
        # warm the accelerator probe off the close path: the first
        # close must never pay the jax-import/device-discovery cost
        # (reference: crypto stack is initialized at app start)
        from stellar_tpu_torch.crypto.batch_verifier import start_device_probe
        start_device_probe()
        # durability hook (stellar_tpu.database.NodePersistence): every
        # close is saved in crash order; None = in-memory node
        self.persistence = persistence
        # the bucket list is fed every close's entry delta and its
        # 11-level hash becomes header.bucketListHash; pass
        # bucket_list=False to fall back to a flat store hash
        if bucket_list is None:
            from stellar_tpu_torch.bucket.bucket_list import LiveBucketList
            bucket_list = LiveBucketList()
        self.bucket_list = bucket_list or None
        # a pre-seeded store becomes the genesis batch so the bucket
        # list covers ALL state, not just post-construction deltas
        # (bucket-backed stores ARE the list; nothing to seed)
        if self.bucket_list is not None and \
                not getattr(self.root.store, "is_bucket_backed", False) \
                and self.root.store.entries and \
                self.bucket_list.total_entry_count() == 0:
            from stellar_tpu_torch.xdr.runtime import from_bytes as _fb
            from stellar_tpu_torch.xdr.types import LedgerEntry as _LE
            seeded = [_fb(_LE, raw)
                      for raw in self.root.store.entries.values()]
            hdr = self.root.header()
            self.bucket_list.add_batch(
                max(1, hdr.ledgerSeq), hdr.ledgerVersion, seeded, [], [])
        self._lcl_hash = ledger_header_hash(self.root.header())
        self.close_meta_stream: List = []  # downstream consumers hook
        # reverse-delta ring for point-in-time reads (reference
        # QUERY_SNAPSHOT_LEDGERS: the query server answers at recent
        # snapshots): when window > 0, each close records
        # (seq, {kb: previous raw entry bytes | None}) so a reader
        # can walk state back up to `window` ledgers
        self.snapshot_window = 0
        self._reverse_deltas: List[Tuple[int, Dict]] = []
        from stellar_tpu_torch.bucket.eviction import EvictionScanner
        self.eviction_scanner = EvictionScanner()
        # hot archive for evicted PERSISTENT Soroban state (reference
        # HotArchiveBucketList; receives entries from the
        # state-archival protocol onward)
        from stellar_tpu_torch.bucket.hot_archive import HotArchiveBucketList
        self.hot_archive = HotArchiveBucketList()
        self.root.hot_archive = self.hot_archive
        # Soroban network settings: the in-memory view of the
        # CONFIG_SETTING ledger entries (restored from state, so
        # upgraded values survive restart — reference
        # LedgerManager::getSorobanNetworkConfig / updateNetworkConfig).
        # A state with no stored settings uses the shared process-wide
        # initial config (what a network looks like before its first
        # config upgrade).
        self._pending_soroban_config = None
        self._reload_network_config()

    def _reload_network_config(self) -> None:
        """(Re)build the in-memory network-config view from the stored
        CONFIG_SETTING entries — falling back to process defaults when
        the state holds none — and resume the eviction scan at the
        persisted iterator. Shared by construction, restart, and
        bucket-apply catchup so all three paths behave identically."""
        from stellar_tpu_torch.ledger.network_config import load_network_config
        cfg = load_network_config(self.root.store.get)
        if cfg is None:
            from stellar_tpu_torch.tx.ops.soroban_ops import (
                default_soroban_config,
            )
            cfg = default_soroban_config()
        self.soroban_config = cfg
        self.root.soroban_config = cfg
        self.eviction_scanner.seed_from_iterator(
            self.root.store, cfg.eviction_iterator[2])

    # ---------------- LCL accessors ----------------

    @property
    def last_closed_header(self) -> LedgerHeader:
        return self.root.header()

    @property
    def last_closed_hash(self) -> bytes:
        return self._lcl_hash

    @property
    def ledger_seq(self) -> int:
        return self.last_closed_header.ledgerSeq

    # ---------------- the close pipeline ----------------

    def close_ledger(self, lcd: LedgerCloseData) -> CloseLedgerResult:
        """One ledger close; traced + watchdogged like the reference
        (Tracy zone + LogSlowExecution, LedgerManagerImpl.cpp:817)."""
        from stellar_tpu_torch.utils.tracing import (
            LogSlowExecution, frame_mark, zone,
        )
        with zone("ledger.close"), \
                LogSlowExecution("ledger-close", threshold_ms=2000.0):
            try:
                result = self._close_ledger_inner(lcd)
            except BaseException:
                # a staged-but-uncommitted config view (size-window
                # sample, upgrade) must not leak into the next close
                self._pending_soroban_config = None
                raise
        frame_mark()
        return result

    def _close_ledger_inner(self, lcd: LedgerCloseData) -> CloseLedgerResult:
        delay_ms = getattr(self, "close_delay_ms", 0)
        if delay_ms:
            # injected close latency (reference
            # ARTIFICIALLY_DELAY_LEDGER_CLOSE_FOR_TESTING)
            import time as _time
            _time.sleep(delay_ms / 1000.0)
        lcl = self.last_closed_header
        if lcd.ledger_seq != lcl.ledgerSeq + 1:
            raise ValueError(
                f"close out of order: got {lcd.ledger_seq}, "
                f"LCL is {lcl.ledgerSeq}")
        if lcd.tx_set.previous_ledger_hash != self._lcl_hash:
            raise ValueError("tx set does not bind to LCL")

        ltx = LedgerTxn(self.root)
        with ltx.load_header() as hh:
            header = hh.header
            header.ledgerSeq = lcd.ledger_seq
            header.previousLedgerHash = self._lcl_hash
            header.scpValue = basic_stellar_value(
                lcd.tx_set.hash, lcd.close_time,
                upgrades=list(lcd.upgrades))

        result = CloseLedgerResult(header=None, header_hash=b"")
        apply_order = lcd.tx_set.get_txs_in_apply_order()

        # bulk prefetch: one batched newest-first bucket sweep for every
        # entry this set will touch — source accounts + soroban
        # footprints (+TTLs) — so fee/apply point reads hit a warm cache
        # instead of per-key file seeks (reference prefetchTxSourceIds,
        # LedgerManagerImpl.cpp:929-933, + prefetch through the parent,
        # LedgerTxn.h:815)
        prefetch_apply_keys(self.root.store, apply_order)

        # seed the signature-verify cache with ONE device batch before
        # any per-signature check runs in the fee/apply phases —
        # checkValid's seeding doesn't reach closes driven directly
        # (apply-load, catchup replay), and apply must never pay
        # sequential host verifies (reference processSignatures via
        # the SignatureChecker, TransactionFrame.cpp:1092; SIG HOT
        # PATH). Only when an accelerator is live: on the host-oracle
        # fallback the batch is the same sequential work plus
        # collection overhead, so apply verifies lazily instead.
        from stellar_tpu_torch.crypto import keys
        if keys.accelerated_verify_available():
            triples = getattr(lcd.tx_set, "sig_triples", None)
            if triples is not None:
                # checkValid collected these already: one cheap batch
                # call re-verifies only what the bounded cache evicted
                from stellar_tpu_torch.crypto.keys import (
                    batch_verify_into_cache,
                )
                batch_verify_into_cache(triples)
            else:
                from stellar_tpu_torch.herder.tx_set import (
                    prefetch_signature_batch,
                )
                prefetch_signature_batch(ltx, apply_order)
        # the herder remembers closed/losing sets for several slots —
        # don't pin megabytes of consumed triples there (checkValid
        # stores them unconditionally, so clear unconditionally too)
        if getattr(lcd.tx_set, "sig_triples", None) is not None:
            lcd.tx_set.sig_triples = None

        # fee phase first for ALL txs, then apply (reference
        # processFeesSeqNums before applyTransactions)
        fee_results = {}
        for f in apply_order:
            base_fee = lcd.tx_set.base_fee_for(f)
            fee_results[id(f)] = f.process_fee_seq_num(ltx, base_fee)

        result_pairs = []
        for f in apply_order:
            from stellar_tpu_torch.tx.transaction_frame import TxApplyMeta
            meta = TxApplyMeta()
            res = f.apply(ltx, meta)  # fee_charged carried from fee phase
            # (and already net of any Soroban refund)
            xdr_res = f.to_result_xdr(res) if hasattr(f, "to_result_xdr") \
                else res.to_xdr()
            result_pairs.append(TransactionResultPair(
                transactionHash=f.contents_hash(), result=xdr_res))
            result.tx_results.append(res)
            result.tx_metas.append(meta)
            if res.is_success or res.code == 1:  # txFEE_BUMP_INNER_SUCCESS
                result.applied_count += 1
            else:
                result.failed_count += 1

        rset = TransactionResultSet(results=result_pairs)
        tx_set_result_hash = sha256(to_bytes(TransactionResultSet, rset))

        with ltx.load_header() as hh:
            hh.header.txSetResultHash = tx_set_result_hash

        upgrade_metas = []
        for raw in lcd.upgrades:
            # bad/unsupported upgrades are logged and skipped, never
            # abort the close (reference LedgerManagerImpl.cpp:955-996)
            try:
                up_ltx = LedgerTxn(ltx)
                try:
                    self._apply_upgrade(up_ltx, raw)
                    upgrade_metas.append((raw, up_ltx.get_changes()))
                    up_ltx.commit()
                    self._promote_pending_soroban_config()
                except Exception:
                    up_ltx.rollback()
                    self._pending_soroban_config = None
                    raise
            except Exception as e:
                import logging
                logging.getLogger("stellar_tpu.ledger").warning(
                    "skipping malformed/unsupported upgrade at ledger "
                    "%d: %s", lcd.ledger_seq, e)

        self._maybe_sample_bucket_list_size(ltx, lcd.ledger_seq)

        # eviction scan: expired TEMPORARY Soroban entries leave the
        # live state this close (reference startBackgroundEvictionScan,
        # LedgerManagerImpl.cpp:1072-1077); from the state-archival
        # protocol, expired PERSISTENT entries move to the hot archive
        from stellar_tpu_torch.bucket.hot_archive import (
            STATE_ARCHIVAL_PROTOCOL_VERSION,
        )
        archive_persistent = (
            self.hot_archive is not None and
            ltx.header().ledgerVersion >=
            STATE_ARCHIVAL_PROTOCOL_VERSION)
        evicted_keys, archived_entries = self.eviction_scanner.scan(
            ltx, lcd.ledger_seq, archive_persistent=archive_persistent)
        if evicted_keys:
            from stellar_tpu_torch.utils.metrics import registry
            registry.counter("state.eviction.evicted").inc(
                len(evicted_keys))
        # from the soroban protocol, the scan position is consensus
        # state: persist it whenever it CHANGED (advance or reset) so
        # every node — including a restarted one seeded from the entry
        # — resumes from the same point. The reference persists its
        # EvictionIterator from protocol 20, not just the archival era.
        if ltx.header().ledgerVersion >= 20:
            import dataclasses
            from stellar_tpu_torch.xdr.contract import ConfigSettingID as _CS
            it = self.eviction_scanner.last_iterator_state
            base = self._pending_soroban_config or self.soroban_config
            if it != base.eviction_iterator:
                cfg = dataclasses.replace(base, eviction_iterator=it)
                self._write_config_settings(ltx, cfg, [
                    _CS.CONFIG_SETTING_EVICTION_ITERATOR])

        # classify the close's entry delta and stamp lastModified —
        # this is what the bucket list (and meta) see
        delta = ltx.get_delta()
        if self.snapshot_window > 0:
            rev = {kb: (None if prev is None
                        else to_bytes(LedgerEntry_t, prev))
                   for kb, (prev, _cur) in delta.items()}
            self._reverse_deltas.append((lcd.ledger_seq, rev))
            del self._reverse_deltas[:-self.snapshot_window]
        init_entries, live_entries, dead_keys = [], [], []
        for kb, (prev, cur) in delta.items():
            if cur is not None:
                cur.lastModifiedLedgerSeq = lcd.ledger_seq
                (live_entries if prev is not None
                 else init_entries).append(cur)
            elif prev is not None:
                from stellar_tpu_torch.xdr.types import LedgerKey
                dead_keys.append(from_bytes(LedgerKey, kb))

        ltx.commit()
        # a size-window sample staged on the main apply ltx becomes the
        # node's view only once that ltx durably committed
        self._promote_pending_soroban_config()
        if self.hot_archive is not None:
            # restored keys = CONTRACT_DATA entries recreated this
            # close whose key still sits ARCHIVED in the hot archive
            # (RestoreFootprint brought them back); they get LIVE
            # markers. Only contract data is ever archived, so other
            # entry types skip the probe entirely.
            from stellar_tpu_torch.ledger.ledger_txn import (
                entry_to_key, key_bytes,
            )
            from stellar_tpu_torch.xdr.types import LedgerEntryType
            restored = []
            for e in init_entries:
                if e.data.arm != LedgerEntryType.CONTRACT_DATA:
                    continue
                lk = entry_to_key(e)
                if self.hot_archive.get_archived(
                        key_bytes(lk)) is not None:
                    restored.append(lk)
            self.hot_archive.add_batch(
                lcd.ledger_seq, archived_entries, restored)
        header = copy_header(self.root.header())
        if self.bucket_list is not None:
            self.bucket_list.add_batch(
                lcd.ledger_seq, header.ledgerVersion,
                init_entries, live_entries, dead_keys)
            header.bucketListHash = self.bucket_list.hash()
            if hasattr(self.root.store, "rebase"):
                # BucketListDB store: the delta now lives in the list;
                # drop the overlay and refresh the read snapshot
                self.root.store.rebase()
        else:
            header.bucketListHash = self.state_hasher(self.root.store)
        # from the state-archival protocol the header commits to BOTH
        # lists (the hot archive decides RestoreFootprint outcomes, so
        # it must be consensus-proven); one shared implementation of
        # the protocol-gated combine
        if self.hot_archive is not None:
            from stellar_tpu_torch.bucket.hot_archive import (
                header_bucket_list_hash,
            )
            header.bucketListHash = header_bucket_list_hash(
                header.bucketListHash, self.hot_archive,
                header.ledgerVersion)
        # kick next close's eviction enumeration off-crank against the
        # now-committed state (reference startBackgroundEvictionScan)
        self.eviction_scanner.prepare_async(self.root.store)
        self._calculate_skip_values(header)
        self.root.set_header(header)
        self._lcl_hash = ledger_header_hash(header)

        if self.persistence is not None:
            # crash-ordered durable commit: bucket files first, then one
            # SQL transaction flipping the LCL pointer (reference
            # LedgerManagerImpl.cpp:1026-1077)
            from stellar_tpu_torch.xdr.results import TransactionResult
            from stellar_tpu_torch.xdr.tx import TransactionEnvelope
            tx_rows = [
                (f.contents_hash(),
                 to_bytes(TransactionEnvelope, f.envelope),
                 to_bytes(TransactionResult, pair.result))
                for f, pair in zip(apply_order, result_pairs)]
            from stellar_tpu_torch.xdr.ledger import GeneralizedTransactionSet
            self.persistence.save_ledger(
                header, self._lcl_hash, self.bucket_list, tx_rows,
                txset_xdr=to_bytes(GeneralizedTransactionSet,
                                   lcd.tx_set.xdr),
                hot_archive=self.hot_archive)

        result.result_pairs = result_pairs
        result.header = header
        result.header_hash = self._lcl_hash

        if self.close_meta_stream:
            meta = self._build_close_meta(
                lcd, header, result, result_pairs, apply_order,
                fee_results, upgrade_metas, evicted_keys)
            for consumer in self.close_meta_stream:
                consumer(meta)
        return result

    def check_snapshot_seq(self, seq: int):
        """Validate that point-in-time reads at ``seq`` are servable:
        inside the configured window AND actually covered by recorded
        reverse deltas (a freshly started ring covers fewer ledgers
        than the window until it fills)."""
        cur = self.ledger_seq
        if not (cur - self.snapshot_window <= seq <= cur):
            raise ValueError(
                f"ledger {seq} outside the {self.snapshot_window}-"
                "ledger snapshot window")
        if seq < cur and (not self._reverse_deltas or
                          self._reverse_deltas[0][0] > seq + 1):
            raise ValueError(
                f"snapshot ring does not yet cover ledger {seq}")

    def entry_at(self, kb: bytes, seq: int) -> Optional[bytes]:
        """Raw LedgerEntry bytes for key ``kb`` as of ledger ``seq``
        (point-in-time read within the snapshot window): start from
        the live value and walk the reverse deltas of every close
        NEWER than ``seq``, newest first — the last reversal applied
        is the oldest applicable one, i.e. the value as of ``seq``."""
        self.check_snapshot_seq(seq)
        e = self.root.store.get(kb)
        val = None if e is None else to_bytes(LedgerEntry_t, e)
        for dseq, rev in reversed(self._reverse_deltas):
            if dseq <= seq:
                break
            if kb in rev:
                val = rev[kb]
        return val

    @staticmethod
    def _wrap_diagnostics(diags, in_success: bool = True):
        """Host log/diagnostic SCVals -> DiagnosticEvent records (the
        reference wraps logs as DIAGNOSTIC-type events under a "log"
        topic; populated only when diagnostics are enabled, never
        consensus-visible). ``in_success=False`` marks diagnostics
        from a failed invocation — the main debugging case."""
        from stellar_tpu_torch.xdr.contract import (
            ContractEvent, ContractEventType, ContractEventV0, SCVal,
            SCValType,
        )
        from stellar_tpu_torch.xdr.ledger import DiagnosticEvent
        from stellar_tpu_torch.xdr.types import ExtensionPoint
        out = []
        for d in diags or ():
            ev = ContractEvent(
                ext=ExtensionPoint.make(0), contractID=None,
                type=ContractEventType.DIAGNOSTIC,
                body=ContractEvent._types[3].make(0, ContractEventV0(
                    topics=[SCVal.make(SCValType.SCV_SYMBOL, b"log")],
                    data=d)))
            out.append(DiagnosticEvent(
                inSuccessfulContractCall=in_success, event=ev))
        return out

    def _build_close_meta(self, lcd, header, result, result_pairs,
                          apply_order, fee_results, upgrade_metas,
                          evicted_keys):
        """One LedgerCloseMeta (V1) for downstream consumers (reference
        ``LedgerCloseMetaFrame`` + ``docs/integration.md:24-38``)."""
        from stellar_tpu_torch.xdr.ledger import (
            LedgerCloseMeta, LedgerCloseMetaExt, LedgerCloseMetaV1,
            LedgerHeaderHistoryEntry, LedgerUpgrade, OperationMeta,
            TransactionMeta, TransactionMetaV3, TransactionResultMeta,
            UpgradeEntryMeta,
        )
        from stellar_tpu_torch.xdr.ledger import (
            SorobanTransactionMeta, SorobanTransactionMetaExt,
            SorobanTransactionMetaExtV1,
        )
        from stellar_tpu_torch.xdr.types import ExtensionPoint
        tx_processing = []
        for f, pair, res, meta in zip(
                apply_order, result_pairs, result.tx_results,
                result.tx_metas):
            soroban_meta = None
            # the invoke op records on the frame it applied under —
            # the INNER frame for fee bumps
            info = getattr(getattr(f, "inner", f),
                           "_soroban_meta_info", None)
            if info is not None:
                (ok, rv, events, non_ref, refundable, rent,
                 diags) = info
                if EMIT_SOROBAN_TX_META_EXT_V1:
                    sext = SorobanTransactionMetaExt.make(
                        1, SorobanTransactionMetaExtV1(
                            ext=ExtensionPoint.make(0),
                            totalNonRefundableResourceFeeCharged=non_ref,
                            totalRefundableResourceFeeCharged=refundable,
                            rentFeeCharged=rent))
                else:
                    sext = SorobanTransactionMetaExt.make(0)
                from stellar_tpu_torch.xdr.contract import (
                    SCVal as _SCVal, SCValType as _SCVT,
                )
                soroban_meta = SorobanTransactionMeta(
                    ext=sext, events=list(events),
                    returnValue=(rv if rv is not None
                                 else _SCVal.make(_SCVT.SCV_VOID)),
                    diagnosticEvents=self._wrap_diagnostics(
                        diags, in_success=ok))
            v3 = TransactionMetaV3(
                ext=ExtensionPoint.make(0),
                txChangesBefore=list(meta.tx_changes_before),
                operations=[OperationMeta(changes=c)
                            for c in meta.operations],
                txChangesAfter=list(meta.tx_changes_after),
                sorobanMeta=soroban_meta)
            fee_changes = getattr(fee_results[id(f)], "fee_changes", [])
            tx_processing.append(TransactionResultMeta(
                result=pair, feeProcessing=list(fee_changes),
                txApplyProcessing=TransactionMeta.make(3, v3)))
        ups = [UpgradeEntryMeta(
            upgrade=raw if not isinstance(raw, (bytes, bytearray))
            else from_bytes(LedgerUpgrade, bytes(raw)),
            changes=changes) for raw, changes in upgrade_metas]
        bl_size = sum(b.size_bytes for b in self.bucket_list.all_buckets()) \
            if self.bucket_list is not None else 0
        if EMIT_LEDGER_CLOSE_META_EXT_V1:
            from stellar_tpu_torch.xdr.ledger import LedgerCloseMetaExtV1
            meta_ext = LedgerCloseMetaExt.make(1, LedgerCloseMetaExtV1(
                ext=ExtensionPoint.make(0),
                sorobanFeeWrite1KB=self.soroban_config.fee_write_1kb))
        else:
            meta_ext = LedgerCloseMetaExt.make(0)
        v1 = LedgerCloseMetaV1(
            ext=meta_ext,
            ledgerHeader=LedgerHeaderHistoryEntry(
                hash=self._lcl_hash, header=header,
                ext=LedgerHeaderHistoryEntry._types[2].make(0)),
            txSet=lcd.tx_set.xdr,
            txProcessing=tx_processing,
            upgradesProcessing=ups,
            scpInfo=[],
            totalByteSizeOfBucketList=bl_size,
            evictedTemporaryLedgerKeys=list(evicted_keys),
            evictedPersistentLedgerEntries=[])
        return LedgerCloseMeta.make(1, v1)

    # ---------------- restart ----------------

    @classmethod
    def from_persistence(cls, network_id: bytes, persistence
                         ) -> Optional["LedgerManager"]:
        """Resume from the durable LCL (reference
        ``loadLastKnownLedger``): header + bucket list from disk, the
        committed store rebuilt by replaying buckets oldest -> newest.
        Returns None when the database is fresh."""
        restored = persistence.load_last_ledger()
        if restored is None:
            return None
        header, header_hash, bucket_list, hot_archive = restored
        # live state is served straight from the (disk-backed) bucket
        # list — the BucketListDB role; no dict of entries is built
        from stellar_tpu_torch.bucket.bucket_list_db import BucketListStore
        store = BucketListStore(bucket_list, persistence.buckets)
        root = LedgerTxnRoot(store=store, header=header)
        lm = cls(network_id, root, bucket_list=bucket_list,
                 persistence=persistence)
        lm._lcl_hash = header_hash
        if hot_archive is not None:
            lm.hot_archive = hot_archive
            lm.root.hot_archive = hot_archive
        return lm

    # ---------------- upgrades ----------------

    def _apply_upgrade(self, ltx, raw_upgrade):
        """Apply one LedgerUpgrade (reference ``Upgrades::applyTo``)."""
        up = raw_upgrade if not isinstance(raw_upgrade, (bytes, bytearray)) \
            else from_bytes(LedgerUpgrade, bytes(raw_upgrade))
        with ltx.load_header() as hh:
            h = hh.header
            t = up.arm
            if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
                prev_version = h.ledgerVersion
                h.ledgerVersion = up.value
            elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
                h.baseFee = up.value
            elif t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
                h.maxTxSetSize = up.value
            elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
                h.baseReserve = up.value
            elif t == LedgerUpgradeType.LEDGER_UPGRADE_FLAGS:
                from stellar_tpu_torch.herder.upgrades import (
                    MASK_LEDGER_HEADER_FLAGS,
                )
                from stellar_tpu_torch.xdr.ledger import LedgerHeaderExtensionV1
                flags = up.value & MASK_LEDGER_HEADER_FLAGS
                if h.ext.arm == 1:
                    h.ext.value.flags = flags
                else:
                    h.ext = LedgerHeader._types[-1].make(
                        1, LedgerHeaderExtensionV1(
                            flags=flags,
                            ext=LedgerHeaderExtensionV1._types[1].make(0)))
            elif t == LedgerUpgradeType.LEDGER_UPGRADE_CONFIG:
                self._apply_config_upgrade(ltx, up.value)
            elif t == LedgerUpgradeType.\
                    LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
                # reference: writes ledgerMaxTxCount into the
                # CONFIG_SETTING_CONTRACT_EXECUTION_LANES entry
                from stellar_tpu_torch.xdr.contract import ConfigSettingID
                import dataclasses
                cfg = dataclasses.replace(self.soroban_config)
                cfg.ledger_max_tx_count = up.value
                self._write_config_settings(
                    ltx, cfg,
                    [ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES])
            else:
                # unknown arms are validate-rejected at nomination;
                # raising here makes close skip (log) them defensively
                raise NotImplementedError(
                    f"upgrade type {t} not supported")
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            # outside the header context: entry writes re-read it
            self._create_era_config_entries(ltx, prev_version, up.value)

    def _create_era_config_entries(self, ltx, prev: int, new: int):
        """Protocol-era crossings materialize soroban consensus state
        (reference Upgrades::applyVersionUpgrade ->
        createLedgerEntriesForV20 / createCostTypesForV21 / V22,
        src/ledger/NetworkConfig.cpp:1085+): crossing into p20 creates
        EVERY CONFIG_SETTING entry with the initial tables; later eras
        extend the cost vectors in place, preserving any values an
        operator upgrade already tuned."""
        if prev >= new or new < 20:
            return
        import dataclasses
        from stellar_tpu_torch.ledger.network_config import (
            ALL_SETTING_IDS, refresh_write_fee,
        )
        from stellar_tpu_torch.soroban.cost_model import (
            initial_cost_params, upgrade_cost_params,
        )
        from stellar_tpu_torch.xdr.contract import ConfigSettingID as _CS
        cfg = dataclasses.replace(self.soroban_config)
        if prev < 20:
            cfg.cpu_cost_params = initial_cost_params(20, "cpu")
            cfg.mem_cost_params = initial_cost_params(20, "mem")
            # the size window seeds with sample-size copies of the
            # CURRENT bucket list size (reference
            # createLedgerEntriesForV20), so the derived write fee
            # starts from the real state size, not an empty window
            bl_size = self._bucket_list_total_size()
            cfg.bucket_list_size_window = \
                (bl_size,) * cfg.bucket_list_size_window_sample_size
            refresh_write_fee(cfg)
            self._write_config_settings(ltx, cfg,
                                        list(ALL_SETTING_IDS()))
        if prev < 22 and new >= 21:  # some era in (21, 22) is crossed
            cfg.cpu_cost_params = upgrade_cost_params(
                cfg.cpu_cost_params
                or initial_cost_params(max(prev, 20), "cpu"),
                max(prev, 20), new, "cpu")
            cfg.mem_cost_params = upgrade_cost_params(
                cfg.mem_cost_params
                or initial_cost_params(max(prev, 20), "mem"),
                max(prev, 20), new, "mem")
            self._write_config_settings(ltx, cfg, [
                _CS.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS,
                _CS.CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES,
            ])

    def _maybe_sample_bucket_list_size(self, ltx, seq: int) -> None:
        """Every ``bucket_list_window_sample_period`` ledgers at p20+,
        push the current bucket-list size into the sliding window
        CONFIG_SETTING entry and re-derive the write fee (reference
        maybeSnapshotBucketListSize / updateBucketListSizeWindow). Part
        of this ledger's delta, so every node and every replay computes
        the identical entry (a node without a bucket list samples 0 —
        the entry must exist either way)."""
        if ltx.header().ledgerVersion < 20:
            return
        base = self._pending_soroban_config or self.soroban_config
        period = base.bucket_list_window_sample_period
        if period <= 0 or seq % period != 0:
            return
        from stellar_tpu_torch.ledger.network_config import refresh_write_fee
        from stellar_tpu_torch.xdr.contract import ConfigSettingID as _CS
        import dataclasses
        cfg = dataclasses.replace(base)
        window = list(cfg.bucket_list_size_window)
        window.append(self._bucket_list_total_size())
        n = cfg.bucket_list_size_window_sample_size
        cfg.bucket_list_size_window = tuple(window[-n:]) if n > 0 \
            else ()
        refresh_write_fee(cfg)
        self._write_config_settings(ltx, cfg, [
            _CS.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW])

    def _bucket_list_total_size(self) -> int:
        """Serialized byte size of the live bucket list (the quantity
        the reference's size window samples); 0 without a bucket list."""
        if self.bucket_list is None:
            return 0
        total = 0
        for lev in self.bucket_list.levels:
            for b in (lev.curr, lev.snap):
                if b is not None and not b.is_empty():
                    total += b.size_bytes
        return total

    def _apply_config_upgrade(self, ltx, key):
        """LEDGER_UPGRADE_CONFIG: load the published ConfigUpgradeSet
        and write the updated CONFIG_SETTING ledger entries (reference
        ``Upgrades::applyTo`` -> ConfigUpgradeSetFrame::applyTo). The
        new settings live in ledger state, so they persist across
        restart and replay deterministically."""
        from stellar_tpu_torch.herder.upgrades import load_config_upgrade_set
        from stellar_tpu_torch.ledger.network_config import apply_config_setting
        import dataclasses

        def getter(kb):
            from stellar_tpu_torch.xdr.types import LedgerKey
            return ltx.load_without_record(from_bytes(LedgerKey, kb))
        upgrade_set = load_config_upgrade_set(key, getter)
        if upgrade_set is None:
            raise ValueError("config upgrade set not published/invalid")
        cfg = dataclasses.replace(self.soroban_config)
        for entry in upgrade_set.updatedEntry:
            apply_config_setting(cfg, entry)
        arms = [e.arm for e in upgrade_set.updatedEntry]
        # a STATE_ARCHIVAL upgrade that shrinks the sample size resizes
        # the window entry ON THE UPGRADE LEDGER (reference
        # maybeUpdateBucketListWindowSize), not at the next sample
        n = cfg.bucket_list_size_window_sample_size
        if len(cfg.bucket_list_size_window) > n:
            from stellar_tpu_torch.ledger.network_config import (
                refresh_write_fee,
            )
            from stellar_tpu_torch.xdr.contract import ConfigSettingID as _CS
            cfg.bucket_list_size_window = \
                tuple(cfg.bucket_list_size_window[-n:]) if n > 0 else ()
            refresh_write_fee(cfg)
            arms.append(_CS.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW)
        self._write_config_settings(ltx, cfg, arms)

    def _write_config_settings(self, ltx, cfg, setting_ids):
        """Create/update the CONFIG_SETTING entries for ``setting_ids``
        to match ``cfg``; the refreshed view is staged and promoted once
        the upgrade's nested ltx commits."""
        from stellar_tpu_torch.ledger.network_config import (
            config_setting_ledger_entry, config_setting_ledger_key,
            setting_entry_from_config,
        )
        seq = ltx.header().ledgerSeq
        for sid in dict.fromkeys(setting_ids):
            se = setting_entry_from_config(cfg, sid)
            handle = ltx.load(config_setting_ledger_key(sid))
            if handle is not None:
                handle.entry.data = config_setting_ledger_entry(
                    se, seq).data
                handle.deactivate()
            else:
                ltx.create(
                    config_setting_ledger_entry(se, seq)).deactivate()
        self._pending_soroban_config = cfg

    def _promote_pending_soroban_config(self):
        if self._pending_soroban_config is not None:
            self.soroban_config = self._pending_soroban_config
            self.root.soroban_config = self.soroban_config
            self._pending_soroban_config = None

    @staticmethod
    def _calculate_skip_values(header: LedgerHeader):
        """Reference ``BucketManager::calculateSkipValues``."""
        if header.ledgerSeq % SKIP_1 != 0:
            return
        v = header.ledgerSeq - SKIP_1
        if v > 0 and v % SKIP_2 == 0:
            v = header.ledgerSeq - SKIP_2 - SKIP_1
            if v > 0 and v % SKIP_3 == 0:
                v = header.ledgerSeq - SKIP_3 - SKIP_2 - SKIP_1
                if v > 0 and v % SKIP_4 == 0:
                    header.skipList[3] = header.skipList[2]
                header.skipList[2] = header.skipList[1]
            header.skipList[1] = header.skipList[0]
        header.skipList[0] = header.bucketListHash
