"""Ledger XDR (``Stellar-ledger.x``): header, close values, tx sets,
upgrades, entry-change meta, history entries, close meta.

The port's copy of ``stellar_tpu/xdr/ledger.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.xdr.results import (
    TransactionResultPair, TransactionResultSet,
)
from stellar_tpu_torch.xdr.runtime import (
    Bool, Enum, FixedArray, Int32, Int64, Opaque, Option, Struct, Uint32,
    Uint64, Union, VarArray, VarOpaque, Void,
)
from stellar_tpu_torch.xdr.scp import SCPEnvelope, SCPQuorumSet
from stellar_tpu_torch.xdr.tx import TransactionEnvelope
from stellar_tpu_torch.xdr.types import (
    Hash, LedgerEntry, LedgerKey, NodeID, TimePoint,
)

UpgradeType = VarOpaque(128)
MAX_UPGRADES_PER_LEDGER = 6

StellarValueType = Enum("StellarValueType", {
    "STELLAR_VALUE_BASIC": 0,
    "STELLAR_VALUE_SIGNED": 1,
})


class LedgerCloseValueSignature(Struct):
    FIELDS = [("nodeID", NodeID), ("signature", VarOpaque(64))]


class StellarValue(Struct):
    FIELDS = [("txSetHash", Hash),
              ("closeTime", TimePoint),
              ("upgrades", VarArray(UpgradeType, MAX_UPGRADES_PER_LEDGER)),
              ("ext", Union("StellarValue.ext", StellarValueType, {
                  StellarValueType.STELLAR_VALUE_BASIC: Void,
                  StellarValueType.STELLAR_VALUE_SIGNED:
                      LedgerCloseValueSignature}))]


def basic_stellar_value(tx_set_hash: bytes, close_time: int,
                        upgrades=()) -> StellarValue:
    return StellarValue(
        txSetHash=tx_set_hash, closeTime=close_time,
        upgrades=list(upgrades),
        ext=StellarValue._types[3].make(
            StellarValueType.STELLAR_VALUE_BASIC))


LedgerHeaderFlags = Enum("LedgerHeaderFlags", {
    "DISABLE_LIQUIDITY_POOL_TRADING_FLAG": 1,
    "DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG": 2,
    "DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG": 4,
})


class LedgerHeaderExtensionV1(Struct):
    FIELDS = [("flags", Uint32),
              ("ext", Union("LedgerHeaderExtensionV1.ext", Int32,
                            {0: Void}))]


class LedgerHeader(Struct):
    FIELDS = [
        ("ledgerVersion", Uint32),
        ("previousLedgerHash", Hash),
        ("scpValue", StellarValue),
        ("txSetResultHash", Hash),
        ("bucketListHash", Hash),
        ("ledgerSeq", Uint32),
        ("totalCoins", Int64),
        ("feePool", Int64),
        ("inflationSeq", Uint32),
        ("idPool", Uint64),
        ("baseFee", Uint32),
        ("baseReserve", Uint32),
        ("maxTxSetSize", Uint32),
        ("skipList", FixedArray(Hash, 4)),
        ("ext", Union("LedgerHeader.ext", Int32, {
            0: Void, 1: LedgerHeaderExtensionV1})),
    ]


def ledger_header_hash(h: LedgerHeader) -> bytes:
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.runtime import to_bytes
    return sha256(to_bytes(LedgerHeader, h))


# ---------------- upgrades ----------------

LedgerUpgradeType = Enum("LedgerUpgradeType", {
    "LEDGER_UPGRADE_VERSION": 1,
    "LEDGER_UPGRADE_BASE_FEE": 2,
    "LEDGER_UPGRADE_MAX_TX_SET_SIZE": 3,
    "LEDGER_UPGRADE_BASE_RESERVE": 4,
    "LEDGER_UPGRADE_FLAGS": 5,
    "LEDGER_UPGRADE_CONFIG": 6,
    "LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE": 7,
})


class ConfigUpgradeSetKey(Struct):
    FIELDS = [("contractID", Hash), ("contentHash", Hash)]


LedgerUpgrade = Union("LedgerUpgrade", LedgerUpgradeType, {
    LedgerUpgradeType.LEDGER_UPGRADE_VERSION: Uint32,
    LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: Uint32,
    LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE: Uint32,
    LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE: Uint32,
    LedgerUpgradeType.LEDGER_UPGRADE_FLAGS: Uint32,
    LedgerUpgradeType.LEDGER_UPGRADE_CONFIG: ConfigUpgradeSetKey,
    LedgerUpgradeType.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE: Uint32,
})


# ---------------- tx sets ----------------


class TransactionSet(Struct):
    """Legacy (pre-generalized) tx set."""
    FIELDS = [("previousLedgerHash", Hash),
              ("txs", VarArray(TransactionEnvelope))]


TxSetComponentType = Enum("TxSetComponentType", {
    "TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE": 0,
})


class TxSetComponentTxsMaybeDiscountedFee(Struct):
    FIELDS = [("baseFee", Option(Int64)),
              ("txs", VarArray(TransactionEnvelope))]


TxSetComponent = Union("TxSetComponent", TxSetComponentType, {
    TxSetComponentType.TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE:
        TxSetComponentTxsMaybeDiscountedFee,
})

# Parallel Soroban phase: sequential stages of independent clusters
# (reference ``TxSetFrame.h:192-254``).
DependentTxCluster = VarArray(TransactionEnvelope)
ParallelTxExecutionStage = VarArray(DependentTxCluster)


class ParallelTxsComponent(Struct):
    FIELDS = [("baseFee", Option(Int64)),
              ("executionStages", VarArray(ParallelTxExecutionStage))]


TransactionPhase = Union("TransactionPhase", Int32, {
    0: VarArray(TxSetComponent),
    1: ParallelTxsComponent,
})


class TransactionSetV1(Struct):
    FIELDS = [("previousLedgerHash", Hash),
              ("phases", VarArray(TransactionPhase))]


GeneralizedTransactionSet = Union("GeneralizedTransactionSet", Int32, {
    1: TransactionSetV1,
})


def generalized_tx_set_hash(gset) -> bytes:
    """Tx set id under the generalized scheme: SHA-256 of the XDR."""
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.runtime import to_bytes
    return sha256(to_bytes(GeneralizedTransactionSet, gset))


def legacy_tx_set_hash(ts: TransactionSet) -> bytes:
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.runtime import to_bytes
    return sha256(to_bytes(TransactionSet, ts))


# ---------------- entry changes / tx meta ----------------

LedgerEntryChangeType = Enum("LedgerEntryChangeType", {
    "LEDGER_ENTRY_CREATED": 0,
    "LEDGER_ENTRY_UPDATED": 1,
    "LEDGER_ENTRY_REMOVED": 2,
    "LEDGER_ENTRY_STATE": 3,
    "LEDGER_ENTRY_RESTORED": 4,
})

LedgerEntryChange = Union("LedgerEntryChange", LedgerEntryChangeType, {
    LedgerEntryChangeType.LEDGER_ENTRY_CREATED: LedgerEntry,
    LedgerEntryChangeType.LEDGER_ENTRY_UPDATED: LedgerEntry,
    LedgerEntryChangeType.LEDGER_ENTRY_REMOVED: LedgerKey,
    LedgerEntryChangeType.LEDGER_ENTRY_STATE: LedgerEntry,
    LedgerEntryChangeType.LEDGER_ENTRY_RESTORED: LedgerEntry,
})

LedgerEntryChanges = VarArray(LedgerEntryChange)


class OperationMeta(Struct):
    FIELDS = [("changes", LedgerEntryChanges)]


class TransactionMetaV1(Struct):
    FIELDS = [("txChanges", LedgerEntryChanges),
              ("operations", VarArray(OperationMeta))]


class TransactionMetaV2(Struct):
    FIELDS = [("txChangesBefore", LedgerEntryChanges),
              ("operations", VarArray(OperationMeta)),
              ("txChangesAfter", LedgerEntryChanges)]


from stellar_tpu_torch.xdr.contract import SCVal  # noqa: E402
from stellar_tpu_torch.xdr.types import ExtensionPoint  # noqa: E402


class ContractEventV0(Struct):
    FIELDS = [("topics", VarArray(SCVal)), ("data", SCVal)]


ContractEventType = Enum("ContractEventType", {
    "SYSTEM": 0, "CONTRACT": 1, "DIAGNOSTIC": 2})


class ContractEvent(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("contractID", Option(Hash)),
              ("type", ContractEventType),
              ("body", Union("ContractEvent.body", Int32, {
                  0: ContractEventV0}))]


class DiagnosticEvent(Struct):
    FIELDS = [("inSuccessfulContractCall", Bool),
              ("event", ContractEvent)]


class SorobanTransactionMetaExtV1(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("totalNonRefundableResourceFeeCharged", Int64),
              ("totalRefundableResourceFeeCharged", Int64),
              ("rentFeeCharged", Int64)]


SorobanTransactionMetaExt = Union("SorobanTransactionMetaExt", Int32, {
    0: Void, 1: SorobanTransactionMetaExtV1})


class SorobanTransactionMeta(Struct):
    FIELDS = [("ext", SorobanTransactionMetaExt),
              ("events", VarArray(ContractEvent)),
              ("returnValue", SCVal),
              ("diagnosticEvents", VarArray(DiagnosticEvent))]


class TransactionMetaV3(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("txChangesBefore", LedgerEntryChanges),
              ("operations", VarArray(OperationMeta)),
              ("txChangesAfter", LedgerEntryChanges),
              ("sorobanMeta", Option(SorobanTransactionMeta))]


TransactionMeta = Union("TransactionMeta", Int32, {
    0: VarArray(OperationMeta),
    1: TransactionMetaV1,
    2: TransactionMetaV2,
    3: TransactionMetaV3,
})


class TransactionResultMeta(Struct):
    FIELDS = [("result", TransactionResultPair),
              ("feeProcessing", LedgerEntryChanges),
              ("txApplyProcessing", TransactionMeta)]


class UpgradeEntryMeta(Struct):
    FIELDS = [("upgrade", LedgerUpgrade),
              ("changes", LedgerEntryChanges)]


# ---------------- history entries ----------------


class LedgerHeaderHistoryEntry(Struct):
    FIELDS = [("hash", Hash),
              ("header", LedgerHeader),
              ("ext", Union("LHHE.ext", Int32, {0: Void}))]


class TransactionHistoryEntry(Struct):
    FIELDS = [("ledgerSeq", Uint32),
              ("txSet", TransactionSet),
              ("ext", Union("THE.ext", Int32, {
                  0: Void, 1: GeneralizedTransactionSet}))]


class TransactionHistoryResultEntry(Struct):
    FIELDS = [("ledgerSeq", Uint32),
              ("txResultSet", TransactionResultSet),
              ("ext", Union("THRE.ext", Int32, {0: Void}))]


class LedgerSCPMessages(Struct):
    FIELDS = [("ledgerSeq", Uint32),
              ("messages", VarArray(SCPEnvelope))]


class SCPHistoryEntryV0(Struct):
    FIELDS = [("quorumSets", VarArray(SCPQuorumSet)),
              ("ledgerMessages", LedgerSCPMessages)]


SCPHistoryEntry = Union("SCPHistoryEntry", Int32, {0: SCPHistoryEntryV0})


# ---------------- ledger close meta (downstream consumers) ----------------


class LedgerCloseMetaV0(Struct):
    FIELDS = [("ledgerHeader", LedgerHeaderHistoryEntry),
              ("txSet", TransactionSet),
              ("txProcessing", VarArray(TransactionResultMeta)),
              ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
              ("scpInfo", VarArray(SCPHistoryEntry))]


class LedgerCloseMetaExtV1(Struct):
    FIELDS = [("ext", ExtensionPoint),
              ("sorobanFeeWrite1KB", Int64)]


LedgerCloseMetaExt = Union("LedgerCloseMetaExt", Int32, {
    0: Void, 1: LedgerCloseMetaExtV1})


class LedgerCloseMetaV1(Struct):
    FIELDS = [("ext", LedgerCloseMetaExt),
              ("ledgerHeader", LedgerHeaderHistoryEntry),
              ("txSet", GeneralizedTransactionSet),
              ("txProcessing", VarArray(TransactionResultMeta)),
              ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
              ("scpInfo", VarArray(SCPHistoryEntry)),
              ("totalByteSizeOfBucketList", Uint64),
              ("evictedTemporaryLedgerKeys", VarArray(LedgerKey)),
              ("evictedPersistentLedgerEntries", VarArray(LedgerEntry))]


LedgerCloseMeta = Union("LedgerCloseMeta", Int32, {
    0: LedgerCloseMetaV0,
    1: LedgerCloseMetaV1,
})


# ---------------- bucket entries (state store) ----------------

BucketEntryType = Enum("BucketEntryType", {
    "METAENTRY": -1,
    "LIVEENTRY": 0,
    "DEADENTRY": 1,
    "INITENTRY": 2,
})

BucketListType = Enum("BucketListType", {
    "LIVE": 0,
    "HOT_ARCHIVE": 1,
})


class BucketMetadata(Struct):
    FIELDS = [("ledgerVersion", Uint32),
              ("ext", Union("BucketMetadata.ext", Int32, {
                  0: Void, 1: BucketListType}))]


BucketEntry = Union("BucketEntry", BucketEntryType, {
    BucketEntryType.LIVEENTRY: LedgerEntry,
    BucketEntryType.INITENTRY: LedgerEntry,
    BucketEntryType.DEADENTRY: LedgerKey,
    BucketEntryType.METAENTRY: BucketMetadata,
})

HotArchiveBucketEntryType = Enum("HotArchiveBucketEntryType", {
    "HOT_ARCHIVE_METAENTRY": -1,
    "HOT_ARCHIVE_ARCHIVED": 0,
    "HOT_ARCHIVE_LIVE": 1,
})

HotArchiveBucketEntry = Union(
    "HotArchiveBucketEntry", HotArchiveBucketEntryType, {
        HotArchiveBucketEntryType.HOT_ARCHIVE_ARCHIVED: LedgerEntry,
        HotArchiveBucketEntryType.HOT_ARCHIVE_LIVE: LedgerKey,
        HotArchiveBucketEntryType.HOT_ARCHIVE_METAENTRY: BucketMetadata,
    })
