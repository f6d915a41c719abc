"""Soroban settings-upgrade helpers (reference
``src/main/SettingsUpgradeUtils.cpp``): build the ConfigUpgradeSet
publication entry and its ConfigUpgradeSetKey for scheduling
LEDGER_UPGRADE_CONFIG."""

from __future__ import annotations

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.xdr.runtime import to_bytes

__all__ = ["build_config_upgrade_publication", "make_upgrade_set_key"]


def make_upgrade_set_key(contract_id: bytes, upgrade_set):
    from stellar_tpu_torch.xdr.contract import ConfigUpgradeSet
    from stellar_tpu_torch.xdr.ledger import ConfigUpgradeSetKey
    raw = to_bytes(ConfigUpgradeSet, upgrade_set)
    return ConfigUpgradeSetKey(contractID=contract_id,
                               contentHash=sha256(raw))


def build_config_upgrade_publication(contract_id: bytes, upgrade_set,
                                     ledger_seq: int, live_until: int):
    """(LedgerEntry for the published set, TTL LedgerEntry, key):
    a TEMPORARY contract-data entry holding the serialized set under
    SCV_BYTES(contentHash) (where validators look it up at validation
    and apply time)."""
    from stellar_tpu_torch.soroban.host import (
        contract_data_key, scaddress_contract, scbytes, ttl_key_for,
    )
    from stellar_tpu_torch.xdr.contract import (
        ConfigUpgradeSet, ContractDataDurability, ContractDataEntry,
    )
    from stellar_tpu_torch.xdr.types import (
        ExtensionPoint, LedgerEntry, LedgerEntryType, TTLEntry,
    )
    raw = to_bytes(ConfigUpgradeSet, upgrade_set)
    key = make_upgrade_set_key(contract_id, upgrade_set)
    addr = scaddress_contract(contract_id)
    cd = ContractDataEntry(
        ext=ExtensionPoint.make(0), contract=addr,
        key=scbytes(key.contentHash),
        durability=ContractDataDurability.TEMPORARY,
        val=scbytes(raw))
    entry = LedgerEntry(
        lastModifiedLedgerSeq=ledger_seq,
        data=LedgerEntry._types[1].make(
            LedgerEntryType.CONTRACT_DATA, cd),
        ext=LedgerEntry._types[2].make(0))
    lk = contract_data_key(addr, scbytes(key.contentHash),
                           ContractDataDurability.TEMPORARY)
    ttl = LedgerEntry(
        lastModifiedLedgerSeq=ledger_seq,
        data=LedgerEntry._types[1].make(
            LedgerEntryType.TTL,
            TTLEntry(keyHash=ttl_key_for(lk).value.keyHash,
                     liveUntilLedgerSeq=live_until)),
        ext=LedgerEntry._types[2].make(0))
    return entry, ttl, key
