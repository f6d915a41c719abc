"""Soroban network configuration (reference ``src/ledger/NetworkConfig.h``
``InitialSorobanNetworkConfig`` values + the resource-fee formulas from
``src/rust/src/lib.rs`` ``compute_transaction_resource_fee``).

As in the reference, upgraded settings live in CONFIG_SETTING ledger
entries (mutated by LEDGER_UPGRADE_CONFIG, persisted in the bucket
list, restored on restart); ``SorobanNetworkConfig`` is the in-memory
view the fee/limit consumers read (reference
``LedgerManager::getSorobanNetworkConfig``). Settings without a stored
entry take the initial values below.

The port's copy of ``stellar_tpu/ledger/network_config.py``, with the
port's imports, but for ``effective_cost_params``: the Soroban host reads
it, and it comes with the Soroban slice."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SorobanNetworkConfig", "compute_resource_fee",
           "compute_rent_fee", "config_setting_ledger_key",
           "load_network_config", "apply_config_setting",
           "config_setting_ledger_entry", "setting_entry_from_config",
           "UPGRADEABLE_SETTING_IDS", "ALL_SETTING_IDS",
           "NON_UPGRADEABLE_SETTING_IDS"]

DATA_SIZE_1KB_INCREMENT = 1024
INSTRUCTIONS_INCREMENT = 10_000


@dataclass
class SorobanNetworkConfig:
    """Initial settings (reference NetworkConfig.h:60-141)."""
    # contract size / data limits
    max_contract_size: int = 65_536
    max_contract_data_key_size: int = 300
    max_contract_data_entry_size: int = 65_536
    # compute
    tx_max_instructions: int = 2_500_000
    ledger_max_instructions: int = 2_500_000
    fee_rate_per_instructions_increment: int = 100
    tx_memory_limit: int = 40 * 1024 * 1024
    # ledger access
    tx_max_read_ledger_entries: int = 3
    tx_max_read_bytes: int = 3_200
    tx_max_write_ledger_entries: int = 2
    tx_max_write_bytes: int = 3_200
    # per-LEDGER aggregate access caps enforced at tx-set building
    # (reference ledgerMaxRead*/ledgerMaxWrite*); generous defaults so
    # only explicit tuning (apply-load overrides, upgrades) bites
    ledger_max_read_ledger_entries: int = 100_000
    ledger_max_read_bytes: int = 100 * 1024 * 1024
    ledger_max_write_ledger_entries: int = 50_000
    ledger_max_write_bytes: int = 50 * 1024 * 1024
    fee_read_ledger_entry: int = 5_000
    fee_write_ledger_entry: int = 20_000
    fee_read_1kb: int = 1_000
    fee_write_1kb: int = 4_000
    # historical + bandwidth
    fee_historical_1kb: int = 100
    ledger_max_txs_size_bytes: int = 100_000
    tx_max_size_bytes: int = 10_000
    fee_tx_size_1kb: int = 2_000
    # events
    tx_max_contract_events_size_bytes: int = 200
    fee_contract_events_1kb: int = 200
    # state archival
    max_entry_ttl: int = 1_054_080
    min_persistent_ttl: int = 4_096
    min_temporary_ttl: int = 16
    persistent_rent_rate_denominator: int = 252_480
    temp_rent_rate_denominator: int = 2_524_800
    # per-ledger caps
    ledger_max_tx_count: int = 1
    # parallel soroban phase (protocol 23+): max independent clusters
    # per execution stage (reference ledgerMaxDependentTxClusters)
    ledger_max_dependent_tx_clusters: int = 8
    # bucket-list-fed write fee curve (CONFIG_SETTING_CONTRACT_LEDGER_COST_V0
    # tail, reference NetworkConfig.h)
    bucket_list_target_size_bytes: int = 13_000_000_000
    write_fee_1kb_bucket_list_low: int = 0
    write_fee_1kb_bucket_list_high: int = 115_390
    bucket_list_write_fee_growth_factor: int = 1_000
    # state-archival operational knobs (StateArchivalSettings tail)
    max_entries_to_archive: int = 100
    bucket_list_size_window_sample_size: int = 30
    bucket_list_window_sample_period: int = 64
    eviction_scan_size: int = 100_000
    starting_eviction_scan_level: int = 7
    # CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW / _EVICTION_ITERATOR state
    bucket_list_size_window: tuple = ()
    eviction_iterator: tuple = (0, True, 0)  # (level, is_curr, offset)
    # metered cost model vectors [(const, linear)] — None means "the
    # reference's initial table for the running protocol" (see
    # soroban/cost_model.py); a config upgrade pins explicit vectors
    cpu_cost_params: object = None
    mem_cost_params: object = None


# ---------------- CONFIG_SETTING ledger-entry binding ----------------
# the upgradeable arms our ConfigSettingEntry union supports (reference
# stores every arm; these are the ones SettingsUpgradeUtils upgrades)

def _csid():
    from stellar_tpu_torch.xdr.contract import ConfigSettingID
    return ConfigSettingID


def ALL_SETTING_IDS():
    """Every CONFIG_SETTING arm this node stores/loads — including the
    two core-owned ones an operator upgrade may NOT touch."""
    c = _csid()
    return (c.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES,
            c.CONFIG_SETTING_CONTRACT_COMPUTE_V0,
            c.CONFIG_SETTING_CONTRACT_LEDGER_COST_V0,
            c.CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0,
            c.CONFIG_SETTING_CONTRACT_EVENTS_V0,
            c.CONFIG_SETTING_CONTRACT_BANDWIDTH_V0,
            c.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS,
            c.CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES,
            c.CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES,
            c.CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES,
            c.CONFIG_SETTING_STATE_ARCHIVAL,
            c.CONFIG_SETTING_CONTRACT_EXECUTION_LANES,
            c.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW,
            c.CONFIG_SETTING_EVICTION_ITERATOR)


def UPGRADEABLE_SETTING_IDS():
    """The arms a LEDGER_UPGRADE_CONFIG may legitimately change."""
    banned = NON_UPGRADEABLE_SETTING_IDS()
    return tuple(sid for sid in ALL_SETTING_IDS() if sid not in banned)


def NON_UPGRADEABLE_SETTING_IDS():
    """Arms stored in CONFIG_SETTING entries but owned by core, never
    by operator upgrades (reference
    isNonUpgradeableConfigSettingEntry)."""
    c = _csid()
    return (c.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW,
            c.CONFIG_SETTING_EVICTION_ITERATOR)


def compute_write_fee_1kb(cfg: "SorobanNetworkConfig",
                          bucket_list_size: int) -> int:
    """The bucket-list-fed write-fee curve (reference
    ``compute_write_fee_per_1kb`` via the rust bridge,
    NetworkConfig.cpp:2128): linear from ``low`` to ``high`` while the
    bucket list is under target, then growing ``growth_factor`` times
    faster past it."""
    low = cfg.write_fee_1kb_bucket_list_low
    high = cfg.write_fee_1kb_bucket_list_high
    target = max(1, cfg.bucket_list_target_size_bytes)
    mult = high - low
    if bucket_list_size < target:
        return low + (-(-mult * bucket_list_size // target))
    excess = bucket_list_size - target
    growth = cfg.bucket_list_write_fee_growth_factor
    return high + (-(-mult * excess * growth // target))


def average_bucket_list_size(cfg: "SorobanNetworkConfig") -> int:
    win = cfg.bucket_list_size_window
    return sum(win) // len(win) if win else 0


def refresh_write_fee(cfg: "SorobanNetworkConfig") -> None:
    """Re-derive ``fee_write_1kb`` from the curve + the sampled
    bucket-list size window — the reference does this whenever the
    ledger-cost entry or the size window changes."""
    cfg.fee_write_1kb = compute_write_fee_1kb(
        cfg, average_bucket_list_size(cfg))


def config_setting_ledger_key(setting_id):
    from stellar_tpu_torch.xdr.types import (
        LedgerEntryType, LedgerKey, LedgerKeyConfigSetting,
    )
    return LedgerKey.make(LedgerEntryType.CONFIG_SETTING,
                          LedgerKeyConfigSetting(
                              configSettingID=setting_id))


def config_setting_ledger_entry(setting_entry, ledger_seq: int):
    """Wrap a ConfigSettingEntry union value as a LedgerEntry."""
    from stellar_tpu_torch.xdr.types import LedgerEntry, LedgerEntryType
    return LedgerEntry(
        lastModifiedLedgerSeq=ledger_seq,
        data=LedgerEntry._types[1].make(
            LedgerEntryType.CONFIG_SETTING, setting_entry),
        ext=LedgerEntry._types[2].make(0))


def apply_config_setting(cfg: "SorobanNetworkConfig", entry) -> None:
    """Mutate ``cfg`` from one ConfigSettingEntry (the shared setter
    for restore-from-state and LEDGER_UPGRADE_CONFIG apply)."""
    c = _csid()
    if entry.arm == c.CONFIG_SETTING_CONTRACT_COMPUTE_V0:
        v = entry.value
        cfg.ledger_max_instructions = v.ledgerMaxInstructions
        cfg.tx_max_instructions = v.txMaxInstructions
        cfg.fee_rate_per_instructions_increment = \
            v.feeRatePerInstructionsIncrement
        cfg.tx_memory_limit = v.txMemoryLimit
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_EXECUTION_LANES:
        cfg.ledger_max_tx_count = entry.value.ledgerMaxTxCount
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_BANDWIDTH_V0:
        v = entry.value
        cfg.ledger_max_txs_size_bytes = v.ledgerMaxTxsSizeBytes
        cfg.tx_max_size_bytes = v.txMaxSizeBytes
        cfg.fee_tx_size_1kb = v.feeTxSize1KB
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES:
        cfg.max_contract_size = entry.value
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_LEDGER_COST_V0:
        v = entry.value
        cfg.ledger_max_read_ledger_entries = v.ledgerMaxReadLedgerEntries
        cfg.ledger_max_read_bytes = v.ledgerMaxReadBytes
        cfg.ledger_max_write_ledger_entries = \
            v.ledgerMaxWriteLedgerEntries
        cfg.ledger_max_write_bytes = v.ledgerMaxWriteBytes
        cfg.tx_max_read_ledger_entries = v.txMaxReadLedgerEntries
        cfg.tx_max_read_bytes = v.txMaxReadBytes
        cfg.tx_max_write_ledger_entries = v.txMaxWriteLedgerEntries
        cfg.tx_max_write_bytes = v.txMaxWriteBytes
        cfg.fee_read_ledger_entry = v.feeReadLedgerEntry
        cfg.fee_write_ledger_entry = v.feeWriteLedgerEntry
        cfg.fee_read_1kb = v.feeRead1KB
        cfg.bucket_list_target_size_bytes = v.bucketListTargetSizeBytes
        cfg.write_fee_1kb_bucket_list_low = v.writeFee1KBBucketListLow
        cfg.write_fee_1kb_bucket_list_high = v.writeFee1KBBucketListHigh
        cfg.bucket_list_write_fee_growth_factor = \
            v.bucketListWriteFeeGrowthFactor
        refresh_write_fee(cfg)
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0:
        cfg.fee_historical_1kb = entry.value.feeHistorical1KB
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_EVENTS_V0:
        v = entry.value
        cfg.tx_max_contract_events_size_bytes = \
            v.txMaxContractEventsSizeBytes
        cfg.fee_contract_events_1kb = v.feeContractEvents1KB
    elif entry.arm == \
            c.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS:
        cfg.cpu_cost_params = [(p.constTerm, p.linearTerm)
                               for p in entry.value]
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES:
        cfg.mem_cost_params = [(p.constTerm, p.linearTerm)
                               for p in entry.value]
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES:
        cfg.max_contract_data_key_size = entry.value
    elif entry.arm == c.CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES:
        cfg.max_contract_data_entry_size = entry.value
    elif entry.arm == c.CONFIG_SETTING_STATE_ARCHIVAL:
        v = entry.value
        cfg.max_entry_ttl = v.maxEntryTTL
        cfg.min_temporary_ttl = v.minTemporaryTTL
        cfg.min_persistent_ttl = v.minPersistentTTL
        cfg.persistent_rent_rate_denominator = \
            v.persistentRentRateDenominator
        cfg.temp_rent_rate_denominator = v.tempRentRateDenominator
        cfg.max_entries_to_archive = v.maxEntriesToArchive
        cfg.bucket_list_size_window_sample_size = \
            v.bucketListSizeWindowSampleSize
        cfg.bucket_list_window_sample_period = \
            v.bucketListWindowSamplePeriod
        cfg.eviction_scan_size = v.evictionScanSize
        cfg.starting_eviction_scan_level = v.startingEvictionScanLevel
    elif entry.arm == c.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW:
        cfg.bucket_list_size_window = tuple(entry.value)
        refresh_write_fee(cfg)
    elif entry.arm == c.CONFIG_SETTING_EVICTION_ITERATOR:
        v = entry.value
        cfg.eviction_iterator = (v.bucketListLevel, v.isCurrBucket,
                                 v.bucketFileOffset)
    else:
        raise ValueError(f"unsupported config setting arm {entry.arm}")


def setting_entry_from_config(cfg: "SorobanNetworkConfig", setting_id):
    """The ConfigSettingEntry union value representing ``cfg``'s current
    state of one setting (written back to the ledger at upgrade)."""
    from stellar_tpu_torch.xdr.contract import (
        ConfigSettingContractBandwidthV0, ConfigSettingContractComputeV0,
        ConfigSettingContractExecutionLanesV0, ConfigSettingEntry,
    )
    c = _csid()
    if setting_id == c.CONFIG_SETTING_CONTRACT_COMPUTE_V0:
        val = ConfigSettingContractComputeV0(
            ledgerMaxInstructions=cfg.ledger_max_instructions,
            txMaxInstructions=cfg.tx_max_instructions,
            feeRatePerInstructionsIncrement=(
                cfg.fee_rate_per_instructions_increment),
            txMemoryLimit=cfg.tx_memory_limit)
    elif setting_id == c.CONFIG_SETTING_CONTRACT_EXECUTION_LANES:
        val = ConfigSettingContractExecutionLanesV0(
            ledgerMaxTxCount=cfg.ledger_max_tx_count)
    elif setting_id == c.CONFIG_SETTING_CONTRACT_BANDWIDTH_V0:
        val = ConfigSettingContractBandwidthV0(
            ledgerMaxTxsSizeBytes=cfg.ledger_max_txs_size_bytes,
            txMaxSizeBytes=cfg.tx_max_size_bytes,
            feeTxSize1KB=cfg.fee_tx_size_1kb)
    elif setting_id == c.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES:
        val = cfg.max_contract_size
    elif setting_id == c.CONFIG_SETTING_CONTRACT_LEDGER_COST_V0:
        from stellar_tpu_torch.xdr.contract import (
            ConfigSettingContractLedgerCostV0,
        )
        val = ConfigSettingContractLedgerCostV0(
            ledgerMaxReadLedgerEntries=cfg.ledger_max_read_ledger_entries,
            ledgerMaxReadBytes=cfg.ledger_max_read_bytes,
            ledgerMaxWriteLedgerEntries=(
                cfg.ledger_max_write_ledger_entries),
            ledgerMaxWriteBytes=cfg.ledger_max_write_bytes,
            txMaxReadLedgerEntries=cfg.tx_max_read_ledger_entries,
            txMaxReadBytes=cfg.tx_max_read_bytes,
            txMaxWriteLedgerEntries=cfg.tx_max_write_ledger_entries,
            txMaxWriteBytes=cfg.tx_max_write_bytes,
            feeReadLedgerEntry=cfg.fee_read_ledger_entry,
            feeWriteLedgerEntry=cfg.fee_write_ledger_entry,
            feeRead1KB=cfg.fee_read_1kb,
            bucketListTargetSizeBytes=cfg.bucket_list_target_size_bytes,
            writeFee1KBBucketListLow=cfg.write_fee_1kb_bucket_list_low,
            writeFee1KBBucketListHigh=(
                cfg.write_fee_1kb_bucket_list_high),
            bucketListWriteFeeGrowthFactor=(
                cfg.bucket_list_write_fee_growth_factor))
    elif setting_id == c.CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0:
        from stellar_tpu_torch.xdr.contract import (
            ConfigSettingContractHistoricalDataV0,
        )
        val = ConfigSettingContractHistoricalDataV0(
            feeHistorical1KB=cfg.fee_historical_1kb)
    elif setting_id == c.CONFIG_SETTING_CONTRACT_EVENTS_V0:
        from stellar_tpu_torch.xdr.contract import (
            ConfigSettingContractEventsV0,
        )
        val = ConfigSettingContractEventsV0(
            txMaxContractEventsSizeBytes=(
                cfg.tx_max_contract_events_size_bytes),
            feeContractEvents1KB=cfg.fee_contract_events_1kb)
    elif setting_id in (
            c.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS,
            c.CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES):
        from stellar_tpu_torch.xdr.contract import ContractCostParamEntry
        from stellar_tpu_torch.xdr.types import ExtensionPoint
        cpu = setting_id == \
            c.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS
        params = cfg.cpu_cost_params if cpu else cfg.mem_cost_params
        if params is None:
            from stellar_tpu_torch.soroban.cost_model import (
                initial_cost_params,
            )
            from stellar_tpu_torch.protocol import (
                CURRENT_LEDGER_PROTOCOL_VERSION,
            )
            params = initial_cost_params(
                CURRENT_LEDGER_PROTOCOL_VERSION,
                "cpu" if cpu else "mem")
        val = [ContractCostParamEntry(ext=ExtensionPoint.make(0),
                                      constTerm=ct, linearTerm=lt)
               for ct, lt in params]
    elif setting_id == c.CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES:
        val = cfg.max_contract_data_key_size
    elif setting_id == c.CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES:
        val = cfg.max_contract_data_entry_size
    elif setting_id == c.CONFIG_SETTING_STATE_ARCHIVAL:
        from stellar_tpu_torch.xdr.contract import StateArchivalSettings
        val = StateArchivalSettings(
            maxEntryTTL=cfg.max_entry_ttl,
            minTemporaryTTL=cfg.min_temporary_ttl,
            minPersistentTTL=cfg.min_persistent_ttl,
            persistentRentRateDenominator=(
                cfg.persistent_rent_rate_denominator),
            tempRentRateDenominator=cfg.temp_rent_rate_denominator,
            maxEntriesToArchive=cfg.max_entries_to_archive,
            bucketListSizeWindowSampleSize=(
                cfg.bucket_list_size_window_sample_size),
            bucketListWindowSamplePeriod=(
                cfg.bucket_list_window_sample_period),
            evictionScanSize=cfg.eviction_scan_size,
            startingEvictionScanLevel=cfg.starting_eviction_scan_level)
    elif setting_id == c.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW:
        val = list(cfg.bucket_list_size_window)
    elif setting_id == c.CONFIG_SETTING_EVICTION_ITERATOR:
        from stellar_tpu_torch.xdr.contract import EvictionIterator
        lvl, is_curr, off = cfg.eviction_iterator
        val = EvictionIterator(bucketListLevel=lvl, isCurrBucket=is_curr,
                               bucketFileOffset=off)
    else:
        raise ValueError(f"unsupported config setting id {setting_id}")
    return ConfigSettingEntry.make(setting_id, val)


_JSON_ARM_BY_KEY = {
    "contract_max_size_bytes": "CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES",
    "contract_compute_v0": "CONFIG_SETTING_CONTRACT_COMPUTE_V0",
    "contract_ledger_cost_v0": "CONFIG_SETTING_CONTRACT_LEDGER_COST_V0",
    "contract_historical_data_v0":
        "CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0",
    "contract_events_v0": "CONFIG_SETTING_CONTRACT_EVENTS_V0",
    "contract_bandwidth_v0": "CONFIG_SETTING_CONTRACT_BANDWIDTH_V0",
    "contract_cost_params_cpu_instructions":
        "CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS",
    "contract_cost_params_memory_bytes":
        "CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES",
    "contract_data_key_size_bytes":
        "CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES",
    "contract_data_entry_size_bytes":
        "CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES",
    "state_archival": "CONFIG_SETTING_STATE_ARCHIVAL",
    "contract_execution_lanes":
        "CONFIG_SETTING_CONTRACT_EXECUTION_LANES",
}


def _snake_to_camel(s: str) -> str:
    parts = s.split("_")
    out = parts[0] + "".join(p.capitalize() for p in parts[1:])
    # the XDR names spell unit suffixes in caps (feeRead1KB, maxEntryTTL)
    for a, b in (("1Kb", "1KB"), ("Ttl", "TTL")):
        out = out.replace(a, b)
    return out


def load_settings_upgrade_json(data) -> list:
    """Parse a reference-format settings-upgrade JSON (the committed
    ``soroban-settings/pubnet_phase*.json`` files — serde snake_case of
    ConfigUpgradeSet) into ConfigSettingEntry union values. This is the
    input format the reference's ``get-settings-upgrade-txs`` consumes,
    so operators can reuse their existing upgrade files verbatim."""
    import json as _json
    from stellar_tpu_torch.xdr.contract import (
        ConfigSettingEntry, ContractCostParamEntry,
    )
    from stellar_tpu_torch.xdr.types import ExtensionPoint
    if isinstance(data, (str, bytes)):
        data = _json.loads(data)
    c = _csid()
    out = []
    for item in data["updated_entry"]:
        (key, body), = item.items()
        arm_name = _JSON_ARM_BY_KEY.get(key)
        if arm_name is None:
            raise ValueError(f"unknown settings-upgrade key {key!r}")
        sid = getattr(c, arm_name)
        ty = ConfigSettingEntry.arms[sid]
        if key in ("contract_cost_params_cpu_instructions",
                   "contract_cost_params_memory_bytes"):
            val = [ContractCostParamEntry(
                ext=ExtensionPoint.make(0),
                constTerm=p["const_term"], linearTerm=p["linear_term"])
                for p in body]
        elif isinstance(body, dict):
            val = ty(**{_snake_to_camel(k): v for k, v in body.items()})
        else:
            val = body  # scalar arms (uint32)
        out.append(ConfigSettingEntry.make(sid, val))
    return out


def load_network_config(getter):
    """SorobanNetworkConfig from stored CONFIG_SETTING entries, or
    None when the state holds none (a network that never applied a
    config upgrade); ``getter(key_bytes) -> LedgerEntry|None``.
    Settings without an entry keep the initial values (reference loads
    all arms; a fresh network seeds them at the protocol-20 upgrade)."""
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    cfg = SorobanNetworkConfig()
    found = False
    for sid in ALL_SETTING_IDS():
        entry = getter(key_bytes(config_setting_ledger_key(sid)))
        if entry is not None:
            apply_config_setting(cfg, entry.data.value)
            found = True
    return cfg if found else None


def _kb_ceil_mul(fee_per_kb: int, size_bytes: int) -> int:
    """ceil(size/1KB) * fee, computed as the reference's
    ``compute_fee_per_increment`` (round up to the increment)."""
    return -(-size_bytes * fee_per_kb // DATA_SIZE_1KB_INCREMENT)


def compute_resource_fee(cfg: SorobanNetworkConfig, instructions: int,
                         read_entries: int, write_entries: int,
                         read_bytes: int, write_bytes: int,
                         tx_size_bytes: int,
                         events_size_bytes: int = 0) -> tuple:
    """(non_refundable, refundable_events) fee split (reference
    lib.rs:232-246 -> soroban host ``compute_transaction_resource_fee``:
    compute + ledger access + historical + bandwidth are non-refundable;
    events (and rent, computed separately) are refundable)."""
    compute = -(-instructions * cfg.fee_rate_per_instructions_increment
                // INSTRUCTIONS_INCREMENT)
    ledger_access = (
        (read_entries + write_entries) * cfg.fee_read_ledger_entry +
        write_entries * cfg.fee_write_ledger_entry +
        _kb_ceil_mul(cfg.fee_read_1kb, read_bytes) +
        # the curve-derived write fee can be negative while the bucket
        # list is far below target (pubnet's low intercept is negative)
        _kb_ceil_mul(max(0, cfg.fee_write_1kb), write_bytes))
    historical = _kb_ceil_mul(cfg.fee_historical_1kb, tx_size_bytes)
    bandwidth = _kb_ceil_mul(cfg.fee_tx_size_1kb, tx_size_bytes)
    events = _kb_ceil_mul(cfg.fee_contract_events_1kb, events_size_bytes)
    return compute + ledger_access + historical + bandwidth, events


def compute_rent_fee(cfg: SorobanNetworkConfig, entry_size: int,
                     ttl_extension: int, persistent: bool) -> int:
    """Rent for extending one entry's lifetime (reference
    ``compute_rent_fee``'s per-entry term: size * write_fee * extension /
    rate_denominator)."""
    denom = cfg.persistent_rent_rate_denominator if persistent \
        else cfg.temp_rent_rate_denominator
    wfee = _kb_ceil_mul(max(0, cfg.fee_write_1kb), entry_size)
    return max(0, -(-wfee * ttl_extension // denom))
