"""Stellar Asset Contract: the built-in contract bridging classic
assets into Soroban (reference: the SAC inside soroban-env-host, reached
through ``CONTRACT_EXECUTABLE_STELLAR_ASSET``; deployed with
``CONTRACT_ID_PREIMAGE_FROM_ASSET``).

Supported SEP-41 subset: ``balance``, ``transfer``, ``mint``, ``name``
— over ACCOUNT addresses (classic accounts / trustlines mutated through
the footprint-gated host storage, reusing the classic balance rules) —
plus CONTRACT addresses held as contract-data balance entries. Amounts
are i128 SCVals like the reference.
"""

from __future__ import annotations

from typing import Optional

from stellar_tpu_torch.xdr.contract import (
    ContractDataDurability, Int128Parts, SCAddressType, SCVal, SCValType,
)
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import Asset, AssetType, LedgerEntryType

__all__ = ["asset_contract_call", "asset_instance_storage"]

T = SCValType
I128_MAX = 2**127 - 1


def _i128(v: int):
    if not (-2**127 <= v <= I128_MAX):
        raise ValueError("i128 overflow")
    u = v & (2**128 - 1)
    return SCVal.make(T.SCV_I128, Int128Parts(hi=(u >> 64) - (1 << 64)
                                              if (u >> 64) >= (1 << 63)
                                              else (u >> 64),
                                              lo=u & (2**64 - 1)))


def _from_i128(val) -> int:
    if val.arm != T.SCV_I128:
        from stellar_tpu_torch.soroban.host import HostError
        raise HostError(HostError.TRAPPED, "amount must be i128")
    return (val.value.hi << 64) + val.value.lo


def asset_instance_storage(asset) -> list:
    """The instance-storage map entry recording which asset this SAC
    instance wraps."""
    from stellar_tpu_torch.xdr.contract import SCMapEntry
    return [SCMapEntry(
        key=SCVal.make(T.SCV_SYMBOL, b"asset"),
        val=SCVal.make(T.SCV_BYTES, to_bytes(Asset, asset)))]


def _asset_of_instance(inst) -> "Asset.Value":
    for e in (inst.storage or ()):
        if e.key.arm == T.SCV_SYMBOL and e.key.value == b"asset":
            return from_bytes(Asset, e.val.value)
    from stellar_tpu_torch.soroban.host import HostError
    raise HostError(HostError.TRAPPED, "SAC instance missing asset")


def _issuer_raw(asset) -> Optional[bytes]:
    if asset.arm == AssetType.ASSET_TYPE_NATIVE:
        return None
    return asset.value.issuer.value


class _ClassicBridge:
    """Classic balance access through the host's footprint-gated
    storage."""

    def __init__(self, host, asset):
        self.host = host
        self.asset = asset

    def _account_kb(self, raw: bytes) -> bytes:
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.tx.op_frame import account_key
        from stellar_tpu_torch.xdr.types import account_id
        return key_bytes(account_key(account_id(raw)))

    def _trustline_kb(self, raw: bytes) -> bytes:
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.tx.asset_utils import trustline_key
        from stellar_tpu_torch.xdr.types import account_id
        return key_bytes(trustline_key(account_id(raw), self.asset))

    def _entry_for(self, raw: bytes):
        from stellar_tpu_torch.soroban.host import HostError
        native = self.asset.arm == AssetType.ASSET_TYPE_NATIVE
        if not native and _issuer_raw(self.asset) == raw:
            return None  # the issuer has no line in its own asset
        kb = self._account_kb(raw) if native else self._trustline_kb(raw)
        e = self.host.storage.get(kb)
        if e is None:
            raise HostError(HostError.TRAPPED,
                            "missing account/trustline in footprint")
        return (kb, e)

    def balance(self, raw: bytes) -> int:
        got = self._entry_for(raw)
        if got is None:
            return I128_MAX  # issuer: unbounded
        _, e = got
        return e.data.value.balance

    def add(self, raw: bytes, delta: int) -> bool:
        from stellar_tpu_torch.tx.account_utils import add_balance
        got = self._entry_for(raw)
        if got is None:
            return True  # issuer mints/burns
        kb, e = got
        # a fake minimal header for reserve math: the host knows the
        # real one via config? classic reserve rules need the ledger
        # header — carried on the host
        if not add_balance(self.host.ledger_header, e, delta):
            return False
        self.host.storage.put(kb, e, None)
        return True


def _addr_raw(addr_val):
    from stellar_tpu_torch.soroban.host import HostError
    if addr_val.arm != T.SCV_ADDRESS:
        raise HostError(HostError.TRAPPED, "expected address")
    return addr_val.value


def asset_contract_call(host, contract_addr, inst, fn_name: bytes,
                        args, invocation, depth: int = 0):
    """Dispatch one SAC function (reference SAC entry points)."""
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.soroban.host import (
        HostError, _address_bytes, contract_data_key, sym,
    )
    asset = _asset_of_instance(inst)
    bridge = _ClassicBridge(host, asset)

    def holder_balance(addr) -> int:
        if addr.arm == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            return bridge.balance(addr.value.value)
        # contract holders: a contract-data balance entry under the SAC
        lk = contract_data_key(
            contract_addr,
            SCVal.make(T.SCV_VEC, [sym("Balance"),
                                   SCVal.make(T.SCV_ADDRESS, addr)]),
            ContractDataDurability.PERSISTENT)
        e = host.storage.get(key_bytes(lk))
        return _from_i128(e.data.value.val) if e is not None else 0

    def holder_add(addr, delta: int):
        if addr.arm == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            if not bridge.add(addr.value.value, delta):
                raise HostError(HostError.TRAPPED,
                                "classic balance update failed")
            return
        lk = contract_data_key(
            contract_addr,
            SCVal.make(T.SCV_VEC, [sym("Balance"),
                                   SCVal.make(T.SCV_ADDRESS, addr)]),
            ContractDataDurability.PERSISTENT)
        kb = key_bytes(lk)
        cur = holder_balance(addr)
        new = cur + delta
        if new < 0 or new > I128_MAX:
            raise HostError(HostError.TRAPPED, "balance out of range")
        from stellar_tpu_torch.soroban.host import _wrap_entry
        from stellar_tpu_torch.xdr.contract import ContractDataEntry
        from stellar_tpu_torch.xdr.types import ExtensionPoint
        entry = ContractDataEntry(
            ext=ExtensionPoint.make(0), contract=contract_addr,
            key=SCVal.make(T.SCV_VEC, [sym("Balance"),
                                       SCVal.make(T.SCV_ADDRESS, addr)]),
            durability=ContractDataDurability.PERSISTENT,
            val=_i128(new))
        host.storage.put(kb, _wrap_entry(
            LedgerEntryType.CONTRACT_DATA, entry, host.ledger_seq),
            host.ledger_seq + host.config.min_persistent_ttl - 1)

    if fn_name == b"balance":
        return _i128(holder_balance(_addr_raw(args[0])))
    if fn_name == b"name":
        if asset.arm == AssetType.ASSET_TYPE_NATIVE:
            return SCVal.make(T.SCV_STRING, b"native")
        code = asset.value.assetCode.rstrip(b"\x00")
        return SCVal.make(T.SCV_STRING, code)
    if fn_name == b"transfer":
        frm = _addr_raw(args[0])
        to = _addr_raw(args[1])
        amount = _from_i128(args[2])
        if amount < 0:
            raise HostError(HostError.TRAPPED, "negative amount")
        host.auth.require(_address_bytes(frm), invocation, depth)
        holder_add(frm, -amount)
        holder_add(to, amount)
        host.emit_event(contract_addr,
                        [sym("transfer")], _i128(amount))
        return SCVal.make(T.SCV_VOID)
    if fn_name == b"mint":
        to = _addr_raw(args[0])
        amount = _from_i128(args[1])
        if amount < 0:
            raise HostError(HostError.TRAPPED, "negative amount")
        issuer = _issuer_raw(asset)
        if issuer is None:
            raise HostError(HostError.TRAPPED, "native cannot mint")
        from stellar_tpu_torch.soroban.host import scaddress_account
        from stellar_tpu_torch.xdr.types import account_id
        host.auth.require(
            _address_bytes(scaddress_account(account_id(issuer))),
            invocation, depth)
        holder_add(to, amount)
        host.emit_event(contract_addr, [sym("mint")], _i128(amount))
        return SCVal.make(T.SCV_VOID)
    raise HostError(HostError.TRAPPED,
                    f"unknown SAC function {fn_name!r}")
