"""Network upgrades (reference ``src/herder/Upgrades.h`` / ``.cpp``).

A validator *schedules* upgrades (operator-set parameters + activation
time); at nomination it attaches the scheduled upgrades to its proposed
StellarValue, and every validator checks proposed upgrades twice:

* apply-validity (``isValidForApply``) — would this upgrade be legal on
  the current ledger at all (monotonic version, non-zero fee/reserve,
  protocol-gated arms, masked flags);
* nomination-validity (``isValidForNomination``) — does it exactly match
  what this node is scheduled to vote for, and is it time.

Ballot-phase validation uses only apply-validity, so a value carrying an
upgrade the node didn't schedule can still externalize — upgrades are
opt-in to *propose* but consensus to *apply*. Unknown/invalid upgrades
are validate-rejected here so ledger close never has to throw.

The port's copy of ``stellar_tpu/herder/upgrades.py``, with the port's
imports."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from stellar_tpu_torch.protocol import (
    CURRENT_LEDGER_PROTOCOL_VERSION, SOROBAN_PROTOCOL_VERSION,
)
from stellar_tpu_torch.xdr.ledger import LedgerUpgrade, LedgerUpgradeType
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes

__all__ = ["UpgradeParameters", "Upgrades", "MASK_LEDGER_HEADER_FLAGS",
           "UpgradeValidity"]

MASK_LEDGER_HEADER_FLAGS = 0x7  # the three DISABLE_LIQUIDITY_POOL_* bits

LUT = LedgerUpgradeType


class UpgradeValidity:
    VALID = 0
    XDR_INVALID = 1
    INVALID = 2


@dataclass
class UpgradeParameters:
    """Operator-scheduled upgrade vote (reference
    ``Upgrades::UpgradeParameters``)."""
    upgrade_time: int = 0  # unix time the vote activates
    protocol_version: Optional[int] = None
    base_fee: Optional[int] = None
    max_tx_set_size: Optional[int] = None
    base_reserve: Optional[int] = None
    flags: Optional[int] = None
    max_soroban_tx_set_size: Optional[int] = None
    config_upgrade_set_key: Optional[object] = None  # ConfigUpgradeSetKey


def config_upgrade_entry_key(key) -> bytes:
    """The contract-data location of a published ConfigUpgradeSet
    (reference SettingsUpgradeUtils: a TEMPORARY entry under
    key.contractID keyed by SCV_BYTES(contentHash))."""
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.soroban.host import (
        contract_data_key, scaddress_contract, scbytes,
    )
    from stellar_tpu_torch.xdr.contract import ContractDataDurability
    return key_bytes(contract_data_key(
        scaddress_contract(key.contractID), scbytes(key.contentHash),
        ContractDataDurability.TEMPORARY))


def load_config_upgrade_set(key, state_getter):
    """Load + hash-verify + parse the published ConfigUpgradeSet, or
    None (reference ``ConfigUpgradeSetFrame::makeFromKey``)."""
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.xdr.contract import ConfigUpgradeSet, SCValType
    entry = state_getter(config_upgrade_entry_key(key))
    if entry is None:
        return None
    val = entry.data.value.val
    if val.arm != SCValType.SCV_BYTES:
        return None
    raw = val.value
    if sha256(raw) != key.contentHash:
        return None
    try:
        upgrade_set = from_bytes(ConfigUpgradeSet, raw)
    except Exception:
        return None
    if not upgrade_set.updatedEntry:
        return None
    # the bucket-list size window and eviction iterator are
    # core-maintained state that merely LIVES in CONFIG_SETTING
    # entries — an upgrade must never overwrite them (reference
    # SorobanNetworkConfig::isNonUpgradeableConfigSettingEntry,
    # src/ledger/NetworkConfig.cpp:1067-1082)
    from stellar_tpu_torch.ledger.network_config import (
        NON_UPGRADEABLE_SETTING_IDS,
    )
    banned = NON_UPGRADEABLE_SETTING_IDS()
    if any(e.arm in banned for e in upgrade_set.updatedEntry):
        return None
    return upgrade_set


class Upgrades:
    def __init__(self, params: Optional[UpgradeParameters] = None,
                 max_protocol: int = CURRENT_LEDGER_PROTOCOL_VERSION):
        self.params = params or UpgradeParameters()
        # upgrades may carry any version up to what this build speaks;
        # the state-archival protocol became reachable once the hot
        # archive was header-committed and catchup-reconstructible
        # (p23 commitment + MINIMAL/replay reconstruction, r4)
        self.max_protocol = max_protocol

    # ---------------- validation ----------------

    def is_valid_for_apply(self, raw: bytes, header,
                           state_getter=None) -> int:
        """UpgradeValidity for one opaque upgrade against the current
        header (reference ``Upgrades::isValidForApply``).
        ``state_getter(kb) -> LedgerEntry|None`` gives CONFIG upgrades
        access to the published ConfigUpgradeSet entry."""
        try:
            up = from_bytes(LedgerUpgrade, bytes(raw))
        except Exception:
            return UpgradeValidity.XDR_INVALID
        version = header.ledgerVersion
        t = up.arm
        if t == LUT.LEDGER_UPGRADE_VERSION:
            ok = version < up.value <= self.max_protocol
        elif t == LUT.LEDGER_UPGRADE_BASE_FEE:
            ok = up.value != 0
        elif t == LUT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            ok = True
        elif t == LUT.LEDGER_UPGRADE_BASE_RESERVE:
            ok = up.value != 0
        elif t == LUT.LEDGER_UPGRADE_FLAGS:
            ok = version >= 18 and \
                (up.value & ~MASK_LEDGER_HEADER_FLAGS) == 0
        elif t == LUT.LEDGER_UPGRADE_CONFIG:
            if version < SOROBAN_PROTOCOL_VERSION or state_getter is None:
                return UpgradeValidity.INVALID
            ok = load_config_upgrade_set(up.value, state_getter) \
                is not None
        elif t == LUT.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
            ok = version >= SOROBAN_PROTOCOL_VERSION
        else:
            ok = False
        return UpgradeValidity.VALID if ok else UpgradeValidity.INVALID

    def _is_valid_for_nomination(self, up, close_time: int) -> bool:
        if self.params.upgrade_time > close_time:
            return False
        p = self.params
        t = up.arm
        if t == LUT.LEDGER_UPGRADE_VERSION:
            return p.protocol_version is not None and \
                up.value == p.protocol_version
        if t == LUT.LEDGER_UPGRADE_BASE_FEE:
            return p.base_fee is not None and up.value == p.base_fee
        if t == LUT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return p.max_tx_set_size is not None and \
                up.value == p.max_tx_set_size
        if t == LUT.LEDGER_UPGRADE_BASE_RESERVE:
            return p.base_reserve is not None and \
                up.value == p.base_reserve
        if t == LUT.LEDGER_UPGRADE_FLAGS:
            return p.flags is not None and up.value == p.flags
        if t == LUT.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
            return p.max_soroban_tx_set_size is not None and \
                up.value == p.max_soroban_tx_set_size
        if t == LUT.LEDGER_UPGRADE_CONFIG:
            k = p.config_upgrade_set_key
            return k is not None and \
                up.value.contractID == k.contractID and \
                up.value.contentHash == k.contentHash
        return False

    def is_valid(self, raw: bytes, header, nomination: bool,
                 close_time: Optional[int] = None,
                 state_getter=None) -> bool:
        if self.is_valid_for_apply(raw, header, state_getter) != \
                UpgradeValidity.VALID:
            return False
        if nomination:
            up = from_bytes(LedgerUpgrade, bytes(raw))
            return self._is_valid_for_nomination(
                up, close_time if close_time is not None
                else header.scpValue.closeTime)
        return True

    # ---------------- proposal ----------------

    def create_upgrades_for(self, header, close_time: int,
                            soroban_config=None,
                            state_getter=None) -> List[bytes]:
        """The opaque upgrades this node votes for at nomination
        (reference ``Upgrades::createUpgradesFor``)."""
        if self.params.upgrade_time > close_time:
            return []
        p = self.params
        out = []
        if p.protocol_version is not None and \
                header.ledgerVersion != p.protocol_version:
            out.append(LedgerUpgrade.make(
                LUT.LEDGER_UPGRADE_VERSION, p.protocol_version))
        if p.base_fee is not None and header.baseFee != p.base_fee:
            out.append(LedgerUpgrade.make(
                LUT.LEDGER_UPGRADE_BASE_FEE, p.base_fee))
        if p.max_tx_set_size is not None and \
                header.maxTxSetSize != p.max_tx_set_size:
            out.append(LedgerUpgrade.make(
                LUT.LEDGER_UPGRADE_MAX_TX_SET_SIZE, p.max_tx_set_size))
        if p.base_reserve is not None and \
                header.baseReserve != p.base_reserve:
            out.append(LedgerUpgrade.make(
                LUT.LEDGER_UPGRADE_BASE_RESERVE, p.base_reserve))
        if p.flags is not None:
            cur = header.ext.value.flags if header.ext.arm == 1 else 0
            if cur != p.flags:
                out.append(LedgerUpgrade.make(
                    LUT.LEDGER_UPGRADE_FLAGS, p.flags))
        if p.max_soroban_tx_set_size is not None and (
                soroban_config is None or
                soroban_config.ledger_max_tx_count !=
                p.max_soroban_tx_set_size):
            out.append(LedgerUpgrade.make(
                LUT.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE,
                p.max_soroban_tx_set_size))
        if p.config_upgrade_set_key is not None:
            # only nominate once the published ConfigUpgradeSet is
            # actually loadable — a vote armed before the publication
            # tx lands stays scheduled but silent (peers would reject
            # a value carrying an unloadable set)
            if state_getter is None or load_config_upgrade_set(
                    p.config_upgrade_set_key, state_getter) is not None:
                out.append(LedgerUpgrade.make(
                    LUT.LEDGER_UPGRADE_CONFIG, p.config_upgrade_set_key))
        return [to_bytes(LedgerUpgrade, u) for u in out]

    def _config_vote_done(self, soroban_config, state_getter) -> bool:
        """True when the scheduled CONFIG vote can be retired: the
        current network config already reflects the upgrade set (it
        applied). An unloadable set does NOT retire the vote — the
        publication may simply not have landed yet (create_upgrades_for
        stays silent until it does)."""
        import dataclasses
        from stellar_tpu_torch.ledger.network_config import (
            apply_config_setting,
        )
        if state_getter is None or soroban_config is None:
            return False
        upgrade_set = load_config_upgrade_set(
            self.params.config_upgrade_set_key, state_getter)
        if upgrade_set is None:
            return False
        cfg = dataclasses.replace(soroban_config)
        try:
            for entry in upgrade_set.updatedEntry:
                apply_config_setting(cfg, entry)
        except ValueError:
            return True  # can never apply: malformed for this node
        return cfg == soroban_config

    def remove_upgrades_once_done(self, header, soroban_config=None,
                                  state_getter=None):
        """Clear votes that took effect (reference
        ``Upgrades::removeUpgrades`` after application)."""
        p = self.params
        if p.protocol_version is not None and \
                header.ledgerVersion >= p.protocol_version:
            p.protocol_version = None
        if p.base_fee is not None and header.baseFee == p.base_fee:
            p.base_fee = None
        if p.max_tx_set_size is not None and \
                header.maxTxSetSize == p.max_tx_set_size:
            p.max_tx_set_size = None
        if p.base_reserve is not None and \
                header.baseReserve == p.base_reserve:
            p.base_reserve = None
        if p.flags is not None:
            cur = header.ext.value.flags if header.ext.arm == 1 else 0
            if cur == p.flags:
                p.flags = None
        if p.max_soroban_tx_set_size is not None and \
                soroban_config is not None and \
                soroban_config.ledger_max_tx_count == \
                p.max_soroban_tx_set_size:
            p.max_soroban_tx_set_size = None
        if p.config_upgrade_set_key is not None and \
                self._config_vote_done(soroban_config, state_getter):
            p.config_upgrade_set_key = None
