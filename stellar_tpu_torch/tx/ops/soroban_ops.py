"""Soroban operations: InvokeHostFunction, ExtendFootprintTTL,
RestoreFootprint (reference ``src/transactions/InvokeHostFunctionOpFrame
.cpp``, ``ExtendFootprintTTLOpFrame.cpp``, ``RestoreFootprintOpFrame.cpp``).

The op frames are the C++ side of the host boundary: they marshal the
declared footprint's entries (+TTLs) in, call
``stellar_tpu_torch.soroban.host.invoke_host_function``, enforce declared
resources against actual consumption, fold modified entries + TTL
bumps back into the LedgerTxn, and account refundable fees (rent +
events) on the transaction result.
"""

from __future__ import annotations

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, key_bytes
from stellar_tpu_torch.ledger.network_config import (
    compute_rent_fee, compute_resource_fee,
)
from stellar_tpu_torch.soroban.host import (
    HostError, invoke_host_function, ttl_key_for,
)
from stellar_tpu_torch.tx.op_frame import OperationFrame, register_op
from stellar_tpu_torch.xdr.contract import InvokeHostFunctionSuccessPreImage
from stellar_tpu_torch.xdr.results import (
    ExtendFootprintTTLResultCode as ExtCode,
    InvokeHostFunctionResultCode as InvCode,
    RestoreFootprintResultCode as ResCode,
)
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.tx import OperationType
from stellar_tpu_torch.xdr.types import (
    LedgerEntry, LedgerEntryType, LedgerKey, TTLEntry,
)

__all__ = ["InvokeHostFunctionOpFrame", "ExtendFootprintTTLOpFrame",
           "RestoreFootprintOpFrame", "default_soroban_config"]

_DEFAULT_CONFIG = None


def default_soroban_config():
    """Process-wide SorobanNetworkConfig (stand-in for CONFIG_SETTING
    entries; the LedgerManager will own this once config upgrades
    land)."""
    global _DEFAULT_CONFIG
    if _DEFAULT_CONFIG is None:
        from stellar_tpu_torch.ledger.network_config import SorobanNetworkConfig
        _DEFAULT_CONFIG = SorobanNetworkConfig()
    return _DEFAULT_CONFIG


def _load_with_ttl(ltx, lk):
    """(entry|None, live_until|None) through the TTL companion entry."""
    entry = ltx.load_without_record(lk)
    if entry is None:
        return None, None
    if lk.arm in (LedgerEntryType.CONTRACT_DATA,
                  LedgerEntryType.CONTRACT_CODE):
        ttl = ltx.load_without_record(ttl_key_for(lk))
        return entry, (ttl.data.value.liveUntilLedgerSeq
                       if ttl is not None else None)
    return entry, None


def _extend_entry_ttl(cfg, ltx, lk, entry, old_live, live_until: int,
                      seq: int, always_write: bool = False) -> int:
    """Write the TTL row for an entry whose live_until rose and return
    the rent fee for the extension (shared by written-entry and
    TTL-only host-extension paths — one formula, one durability test).
    ``always_write`` keeps the written-entry path's behavior of
    refreshing the TTL row even without an extension."""
    extension = live_until - (old_live if old_live else seq - 1)
    fee = 0
    if extension > 0:
        from stellar_tpu_torch.xdr.contract import ContractDataDurability
        persistent = not (
            lk.arm == LedgerEntryType.CONTRACT_DATA and
            lk.value.durability == ContractDataDurability.TEMPORARY)
        fee = compute_rent_fee(cfg, len(to_bytes(LedgerEntry, entry)),
                               extension, persistent)
    if extension > 0 or always_write:
        _write_ttl(ltx, lk, live_until, seq)
    return fee


def _write_ttl(ltx, lk, live_until: int, ledger_seq: int):
    tk = ttl_key_for(lk)
    h = ltx.load(tk)
    if h is not None:
        h.data.liveUntilLedgerSeq = live_until
        h.deactivate()
    else:
        from stellar_tpu_torch.xdr.types import LedgerKeyTtl
        ltx.create(LedgerEntry(
            lastModifiedLedgerSeq=ledger_seq,
            data=LedgerEntry._types[1].make(
                LedgerEntryType.TTL,
                TTLEntry(keyHash=tk.value.keyHash,
                         liveUntilLedgerSeq=live_until)),
            ext=LedgerEntry._types[2].make(0))).deactivate()


class _SorobanBase(OperationFrame):
    def soroban_data(self):
        return self.parent_tx.tx.ext.value

    def resources(self):
        return self.soroban_data().resources

    def config(self):
        ltx = getattr(self, "_active_ltx", None)
        if ltx is not None:
            from stellar_tpu_torch.ledger.ledger_txn import soroban_config_of
            return soroban_config_of(ltx)
        return default_soroban_config()


@register_op(OperationType.INVOKE_HOST_FUNCTION)
class InvokeHostFunctionOpFrame(_SorobanBase):
    """Reference ``InvokeHostFunctionOpFrame.cpp`` — the marshalling
    side of the host FFI."""

    def do_check_valid(self, ledger_version: int):
        res = self.resources()
        cfg = self.config()
        fp = res.footprint
        bad = (res.instructions > cfg.tx_max_instructions or
               res.readBytes > cfg.tx_max_read_bytes or
               res.writeBytes > cfg.tx_max_write_bytes or
               len(fp.readOnly) + len(fp.readWrite) >
               cfg.tx_max_read_ledger_entries or
               len(fp.readWrite) > cfg.tx_max_write_ledger_entries)
        if bad:
            return False, self.make_result(
                InvCode.INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED)
        # declared fee must cover the non-refundable portion
        non_ref, _ = compute_resource_fee(
            cfg, res.instructions, len(fp.readOnly), len(fp.readWrite),
            res.readBytes, res.writeBytes, self.parent_tx.size_bytes())
        if self.parent_tx.declared_soroban_resource_fee() < non_ref:
            return False, self.make_result(
                InvCode.INVOKE_HOST_FUNCTION_INSUFFICIENT_REFUNDABLE_FEE)
        return True, None

    def do_apply(self, outer):
        cfg = self.config()
        res = self.resources()
        fp = res.footprint
        header = outer.header()
        seq = header.ledgerSeq

        with LedgerTxn(outer) as ltx:
            read_only, read_write = set(), set()
            footprint_entries = {}
            for keys, bucket in ((fp.readOnly, read_only),
                                 (fp.readWrite, read_write)):
                for lk in keys:
                    kb = key_bytes(lk)
                    bucket.add(kb)
                    entry, live_until = _load_with_ttl(ltx, lk)
                    if entry is not None:
                        footprint_entries[kb] = (entry, live_until)
                        # archived persistent entries must be restored
                        # before use (reference ENTRY_ARCHIVED)
                        if live_until is not None and live_until < seq:
                            return False, self.make_result(
                                InvCode.INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED)

            from stellar_tpu_torch.utils.metrics import registry
            registry.meter("soroban.host.invoke").mark()
            out = invoke_host_function(
                self.body.hostFunction, footprint_entries, read_only,
                read_write, self.body.auth, self.source_account_id(),
                self.parent_tx.network_id, seq, cfg,
                cpu_limit=res.instructions, ledger_header=header)

            if not out.success:
                # failed invokes emit no contract events but their
                # diagnostics still surface in meta (the debugging
                # case diagnostics exist for)
                self.parent_tx._soroban_meta_info = (
                    False, None, [], 0, 0, 0, out.diagnostics)
                code = {
                    HostError.BUDGET:
                        InvCode.INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED,
                    HostError.ARCHIVED:
                        InvCode.INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED,
                }.get(out.error, InvCode.INVOKE_HOST_FUNCTION_TRAPPED)
                return False, self.make_result(code)

            # actual consumption must fit the declaration (reference
            # host budget + readBytes/writeBytes checks)
            if out.read_bytes > res.readBytes or \
                    out.write_bytes > res.writeBytes:
                return False, self.make_result(
                    InvCode.INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED)

            # fold modified entries + TTLs back into the ledger
            rent_fee = 0
            for kb, (entry, live_until) in out.modified.items():
                lk = from_bytes(LedgerKey, kb)
                if entry is None:
                    if ltx.exists(lk):
                        ltx.erase(lk)
                        tk = ttl_key_for(lk)
                        if ltx.exists(tk):
                            ltx.erase(tk)
                    continue
                h = ltx.load(lk)
                if h is not None:
                    h.entry.data = entry.data
                    h.entry.lastModifiedLedgerSeq = seq
                    h.deactivate()
                else:
                    ltx.create(entry).deactivate()
                if live_until is not None:
                    prev = footprint_entries.get(kb)
                    rent_fee += _extend_entry_ttl(
                        cfg, ltx, lk, entry,
                        prev[1] if prev else None, live_until, seq,
                        always_write=True)

            # TTL-only extensions from inside the contract (reference
            # extend_contract_data_ttl host fn): rent + TTL row, the
            # data entry itself untouched
            for kb, live_until in out.ttl_extensions.items():
                lk = from_bytes(LedgerKey, kb)
                prev = footprint_entries.get(kb)
                if prev is None or prev[0] is None:
                    continue
                rent_fee += _extend_entry_ttl(
                    cfg, ltx, lk, prev[0], prev[1], live_until, seq)

            events_size = sum(len(to_bytes(
                __import__("stellar_tpu_torch.xdr.contract",
                           fromlist=["ContractEvent"]).ContractEvent, e))
                for e in out.events)
            _, events_fee = compute_resource_fee(
                cfg, 0, 0, 0, 0, 0, 0, events_size)
            refundable_consumed = rent_fee + events_fee
            declared = self.parent_tx.declared_soroban_resource_fee()
            non_ref, _ = compute_resource_fee(
                cfg, res.instructions, len(fp.readOnly),
                len(fp.readWrite), res.readBytes, res.writeBytes,
                self.parent_tx.size_bytes())
            if non_ref + refundable_consumed > declared:
                return False, self.make_result(
                    InvCode.INVOKE_HOST_FUNCTION_INSUFFICIENT_REFUNDABLE_FEE)
            self.parent_tx.note_soroban_consumption(refundable_consumed,
                                                    out.events)
            # retained for the close meta's sorobanMeta block
            self.parent_tx._soroban_meta_info = (
                True, out.return_value, out.events, non_ref,
                refundable_consumed, rent_fee, out.diagnostics)

            preimage = InvokeHostFunctionSuccessPreImage(
                returnValue=out.return_value, events=out.events)
            ltx.commit()
        return True, self.make_result(
            InvCode.INVOKE_HOST_FUNCTION_SUCCESS,
            sha256(to_bytes(InvokeHostFunctionSuccessPreImage, preimage)))


@register_op(OperationType.EXTEND_FOOTPRINT_TTL)
class ExtendFootprintTTLOpFrame(_SorobanBase):
    """Reference ``ExtendFootprintTTLOpFrame.cpp``: raise liveUntil of
    every readOnly footprint entry to now + extendTo."""

    def do_check_valid(self, ledger_version: int):
        cfg = self.config()
        fp = self.resources().footprint
        if fp.readWrite or not fp.readOnly or \
                self.body.extendTo > cfg.max_entry_ttl - 1:
            return False, self.make_result(
                ExtCode.EXTEND_FOOTPRINT_TTL_MALFORMED)
        for lk in fp.readOnly:
            if lk.arm not in (LedgerEntryType.CONTRACT_DATA,
                              LedgerEntryType.CONTRACT_CODE):
                return False, self.make_result(
                    ExtCode.EXTEND_FOOTPRINT_TTL_MALFORMED)
        return True, None

    def do_apply(self, outer):
        cfg = self.config()
        seq = outer.header().ledgerSeq
        extend_to = self.body.extendTo
        rent = 0
        with LedgerTxn(outer) as ltx:
            for lk in self.resources().footprint.readOnly:
                entry, live_until = _load_with_ttl(ltx, lk)
                if entry is None or live_until is None or live_until < seq:
                    continue  # absent/archived entries are skipped
                new_live = min(seq + extend_to, seq + cfg.max_entry_ttl - 1)
                if new_live <= live_until:
                    continue
                from stellar_tpu_torch.xdr.contract import ContractDataDurability
                persistent = not (
                    lk.arm == LedgerEntryType.CONTRACT_DATA and
                    lk.value.durability ==
                    ContractDataDurability.TEMPORARY)
                rent += compute_rent_fee(
                    cfg, len(to_bytes(LedgerEntry, entry)),
                    new_live - live_until, persistent)
                _write_ttl(ltx, lk, new_live, seq)
            declared = self.parent_tx.declared_soroban_resource_fee()
            if rent > declared:
                return False, self.make_result(
                    ExtCode.
                    EXTEND_FOOTPRINT_TTL_INSUFFICIENT_REFUNDABLE_FEE)
            self.parent_tx.note_soroban_consumption(rent, [])
            ltx.commit()
        return True, self.make_result(ExtCode.EXTEND_FOOTPRINT_TTL_SUCCESS)


@register_op(OperationType.RESTORE_FOOTPRINT)
class RestoreFootprintOpFrame(_SorobanBase):
    """Reference ``RestoreFootprintOpFrame.cpp``: bring archived
    persistent readWrite entries back to the minimum lifetime."""

    def _restore_from_hot_archive(self, ltx, lk):
        """Recreate an evicted entry from the node's hot archive, or
        None when it was never archived (or already restored). Gated on
        the state-archival protocol like eviction itself."""
        from stellar_tpu_torch.bucket.hot_archive import (
            STATE_ARCHIVAL_PROTOCOL_VERSION,
        )
        from stellar_tpu_torch.ledger.ledger_txn import (
            copy_entry, key_bytes, root_of,
        )
        if ltx.header().ledgerVersion < STATE_ARCHIVAL_PROTOCOL_VERSION:
            return None
        hot = getattr(root_of(ltx), "hot_archive", None)
        if hot is None:
            return None
        archived = hot.get_archived(key_bytes(lk))
        if archived is None:
            return None
        entry = copy_entry(archived)
        ltx.create(entry).deactivate()
        return entry

    def do_check_valid(self, ledger_version: int):
        fp = self.resources().footprint
        if fp.readOnly or not fp.readWrite:
            return False, self.make_result(
                ResCode.RESTORE_FOOTPRINT_MALFORMED)
        from stellar_tpu_torch.xdr.contract import ContractDataDurability
        for lk in fp.readWrite:
            if lk.arm == LedgerEntryType.CONTRACT_CODE:
                continue
            if lk.arm == LedgerEntryType.CONTRACT_DATA and \
                    lk.value.durability == \
                    ContractDataDurability.PERSISTENT:
                continue
            return False, self.make_result(
                ResCode.RESTORE_FOOTPRINT_MALFORMED)
        return True, None

    def do_apply(self, outer):
        cfg = self.config()
        seq = outer.header().ledgerSeq
        rent = 0
        with LedgerTxn(outer) as ltx:
            for lk in self.resources().footprint.readWrite:
                entry, live_until = _load_with_ttl(ltx, lk)
                if entry is None:
                    # evicted to the hot archive? pull it back into
                    # the live state (reference restores from
                    # HotArchiveBucket after persistent eviction)
                    entry = self._restore_from_hot_archive(ltx, lk)
                    if entry is None:
                        continue  # genuinely absent
                    live_until = None
                elif live_until is not None and live_until >= seq:
                    continue  # still live
                new_live = seq + cfg.min_persistent_ttl - 1
                rent += compute_rent_fee(
                    cfg, len(to_bytes(LedgerEntry, entry)),
                    new_live - (live_until or seq - 1), True)
                _write_ttl(ltx, lk, new_live, seq)
            declared = self.parent_tx.declared_soroban_resource_fee()
            if rent > declared:
                return False, self.make_result(
                    ResCode.RESTORE_FOOTPRINT_INSUFFICIENT_REFUNDABLE_FEE)
            self.parent_tx.note_soroban_consumption(rent, [])
            ltx.commit()
        return True, self.make_result(ResCode.RESTORE_FOOTPRINT_SUCCESS)
