"""Legacy (pre-1.0) soroban env ABI: the 2022-era ``RawVal`` encoding
and host import surface spoken by the reference's own compiled test
fixtures (the reference's ``src/testdata/example_add_i32.wasm``,
``example_contract_data.wasm`` — env interface version 2, read from
their ``contractenvmetav0`` sections).

Derived by disassembling those fixtures with this repo's own decoder,
NOT from any external source:

- ``add`` checks ``(val & 15) == 3`` on both args, computes the
  overflow-checked i32 sum of ``val >> 4``, and returns
  ``(sum << 4) | 3``  → bit0 = 1 means "tagged", tag = ``(val>>1)&7``
  with payload in bits 4..63; tag 1 is I32 (``(1<<1)|1 = 3``).
- ``put``/``del`` check ``(val & 15) == 9`` → tag 4 = Symbol (6-bit
  chars, same ``_0-9A-Za-z`` alphabet as the modern SymbolSmall, up to
  10 chars in the 60-bit payload), call imports ``("l","_")`` =
  ``put_contract_data(k, v)`` / ``("l","2")`` = ``del_contract_data(k)``
  and return ``5`` = Static/Void (tag 2, payload 0).
- bit0 = 0 is a positive "u63" immediate: value = ``val >> 1``.

Contracts whose env-meta interface version predates the
``protocol << 32`` scheme (i.e. ``< 1 << 32``) are linked against this
table; everything else gets the modern env (``soroban/env.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from stellar_tpu_torch.soroban.env import EnvError
from stellar_tpu_torch.xdr.contract import SCVal, SCValType

__all__ = ["is_legacy_module", "to_rawval", "from_rawval",
           "make_legacy_imports", "LEGACY_VOID"]

T = SCValType

_M64 = (1 << 64) - 1

# tag values from the 2022 RawVal scheme (bit0=1, tag in bits 1..3,
# payload in bits 4..63)
_TAG_U32 = 0
_TAG_I32 = 1
_TAG_STATIC = 2
_TAG_OBJECT = 3
_TAG_SYMBOL = 4
_TAG_BITSET = 5
_TAG_STATUS = 6

_STATIC_VOID = 0
_STATIC_TRUE = 1
_STATIC_FALSE = 2

LEGACY_VOID = (_STATIC_VOID << 4) | (_TAG_STATIC << 1) | 1  # == 5


def is_legacy_module(module) -> bool:
    """True when the module was compiled against a pre-1.0 env
    interface (version below the ``protocol << 32`` scheme)."""
    v = module.env_meta_version
    return v is not None and v < (1 << 32)


def _tagged(tag: int, payload: int) -> int:
    return ((payload & ((1 << 60) - 1)) << 4) | ((tag & 7) << 1) | 1


def to_rawval(sc) -> int:
    """SCVal -> legacy RawVal (immediates only: the fixtures never
    exchange object handles across the boundary)."""
    arm = sc.arm
    if arm == T.SCV_VOID:
        return LEGACY_VOID
    if arm == T.SCV_BOOL:
        return _tagged(_TAG_STATIC,
                       _STATIC_TRUE if sc.value else _STATIC_FALSE)
    if arm == T.SCV_U32:
        return _tagged(_TAG_U32, sc.value & 0xFFFFFFFF)
    if arm == T.SCV_I32:
        return _tagged(_TAG_I32, sc.value & 0xFFFFFFFF)
    if arm == T.SCV_U64:
        # the only arm that round-trips through the u63 immediate;
        # I64/Timepoint/Duration would come back re-typed as U64, so
        # they are refused rather than silently rewritten
        if sc.value < 1 << 63:
            return (sc.value << 1) & _M64
        raise EnvError("u64 too large for legacy u63 immediate")
    if arm == T.SCV_SYMBOL:
        if len(sc.value) > 10:
            raise EnvError("symbol too long for legacy encoding")
        # same 6-bit alphabet as the modern SymbolSmall but 10 chars
        # fit the 60-bit legacy payload
        from stellar_tpu_torch.soroban.env import _SYM_CODE
        body = 0
        for ch in sc.value.decode("ascii"):
            code = _SYM_CODE.get(ch)
            if code is None:
                raise EnvError(f"bad symbol char {ch!r}")
            body = (body << 6) | code
        return _tagged(_TAG_SYMBOL, body)
    raise EnvError(f"SCVal arm {arm} has no legacy RawVal form")


def from_rawval(val: int):
    """Legacy RawVal -> SCVal (immediates only)."""
    val &= _M64
    if not val & 1:
        return SCVal.make(T.SCV_U64, val >> 1)
    tag = (val >> 1) & 7
    payload = val >> 4
    if tag == _TAG_STATIC:
        if payload == _STATIC_VOID:
            return SCVal.make(T.SCV_VOID)
        if payload == _STATIC_TRUE:
            return SCVal.make(T.SCV_BOOL, True)
        if payload == _STATIC_FALSE:
            return SCVal.make(T.SCV_BOOL, False)
        raise EnvError(f"unknown legacy static value {payload}")
    if tag == _TAG_U32:
        return SCVal.make(T.SCV_U32, payload & 0xFFFFFFFF)
    if tag == _TAG_I32:
        p = payload & 0xFFFFFFFF
        return SCVal.make(T.SCV_I32, p - (1 << 32) if p >> 31 else p)
    if tag == _TAG_SYMBOL:
        # re-tag into the modern SymbolSmall layout for the shared
        # 6-bit decoder (identical alphabet; legacy payload may carry
        # 10 chars = 60 bits, decode manually above 56 bits)
        chars = []
        body = payload
        from stellar_tpu_torch.soroban.env import _SYM_CHAR
        while body:
            ch = _SYM_CHAR.get(body & 0x3F)
            if ch is None:
                raise EnvError("malformed legacy symbol")
            chars.append(ch)
            body >>= 6
        return SCVal.make(T.SCV_SYMBOL,
                          "".join(reversed(chars)).encode())
    raise EnvError(f"legacy RawVal tag {tag} not supported")


def make_legacy_imports(env) -> Dict[Tuple[str, str], Callable]:
    """Import table for a legacy-ABI contract frame. ``env`` is the
    same ``WasmContractEnv`` the modern table binds; storage goes
    through the same footprint-enforced host services. Pre-durability
    contract data is linked to PERSISTENT storage (the only kind that
    existed)."""
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.soroban.host import contract_data_key
    from stellar_tpu_torch.xdr.contract import ContractDataDurability

    dur = ContractDataDurability.PERSISTENT

    def _kb(k_raw: int):
        key_sc = from_rawval(k_raw)
        return key_sc, key_bytes(
            contract_data_key(env.contract_addr, key_sc, dur))

    def put_contract_data(inst, k_raw, v_raw):
        env.data_put(from_rawval(k_raw), from_rawval(v_raw), dur)
        return LEGACY_VOID

    def has_contract_data(inst, k_raw):
        _, kb = _kb(k_raw)
        present = env.data_get(kb) is not None
        return _tagged(_TAG_STATIC,
                       _STATIC_TRUE if present else _STATIC_FALSE)

    def get_contract_data(inst, k_raw):
        _, kb = _kb(k_raw)
        sc = env.data_get(kb)
        if sc is None:
            raise EnvError("missing contract data")
        return to_rawval(sc)

    def del_contract_data(inst, k_raw):
        _, kb = _kb(k_raw)
        env.data_del(kb)
        return LEGACY_VOID

    return {
        ("l", "_"): put_contract_data,
        ("l", "0"): has_contract_data,
        ("l", "1"): get_contract_data,
        ("l", "2"): del_contract_data,
    }
