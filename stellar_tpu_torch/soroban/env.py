"""Host environment for wasm contracts: the 64-bit tagged-``Val`` ABI
and the host-function import table — the layer soroban-env-host puts
between wasmi and the ledger (reference boundary:
``src/rust/src/lib.rs:61-83`` links soroban-env-host, which defines the
Val encoding and the env interface; the crate itself is external to the
reference tree, so the import names here are this framework's own —
the TAG layout and semantics mirror the published soroban-env-common
value scheme so the conversion logic is protocol-shaped).

A ``Val`` is a u64: low 8 bits tag, high 56 bits body. Small immediates
(u32/i32, small u64/i64, short symbols, bool/void) travel inline;
larger values live in a per-invocation object table addressed by
handle. Handles never cross contract frames: cross-contract calls
convert through SCVal at the boundary, so a callee cannot forge a
caller's handles (same isolation the reference host enforces).

Host imports use single-letter module names grouped by area (context
"x", ledger "l", vec "v", map "m", buf "b", int "i", address "a",
call "c", crypto "d") — the grouping soroban-env uses for its export
names.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.soroban.wasm import Trap
from stellar_tpu_torch.xdr.contract import (
    SCAddress, SCMapEntry, SCVal, SCValType,
)
from stellar_tpu_torch.xdr.runtime import to_bytes

__all__ = ["ValConverter", "make_imports", "EnvError",
           "TAG_FALSE", "TAG_TRUE", "TAG_VOID", "TAG_U32", "TAG_I32",
           "TAG_U64_SMALL", "TAG_I64_SMALL", "TAG_SYMBOL_SMALL",
           "TAG_U64_OBJ", "TAG_I64_OBJ", "TAG_U128_OBJ", "TAG_I128_OBJ",
           "TAG_BYTES_OBJ", "TAG_STRING_OBJ", "TAG_SYMBOL_OBJ",
           "TAG_VEC_OBJ", "TAG_MAP_OBJ", "TAG_ADDRESS_OBJ",
           "sym_to_small", "small_to_sym"]

T = SCValType

# Tag values mirror soroban-env-common's Tag enum
TAG_FALSE = 0
TAG_TRUE = 1
TAG_VOID = 2
TAG_ERROR = 3
TAG_U32 = 4
TAG_I32 = 5
TAG_U64_SMALL = 6
TAG_I64_SMALL = 7
TAG_TIMEPOINT_SMALL = 8
TAG_DURATION_SMALL = 9
TAG_U128_SMALL = 10
TAG_I128_SMALL = 11
TAG_U256_SMALL = 12
TAG_I256_SMALL = 13
TAG_SYMBOL_SMALL = 14
TAG_U64_OBJ = 64
TAG_I64_OBJ = 65
TAG_TIMEPOINT_OBJ = 66
TAG_DURATION_OBJ = 67
TAG_U128_OBJ = 68
TAG_I128_OBJ = 69
TAG_U256_OBJ = 70
TAG_I256_OBJ = 71
TAG_BYTES_OBJ = 72
TAG_STRING_OBJ = 73
TAG_SYMBOL_OBJ = 74
TAG_VEC_OBJ = 75
TAG_MAP_OBJ = 76
TAG_ADDRESS_OBJ = 77

_M56 = (1 << 56) - 1
_M64 = (1 << 64) - 1
_SMALL_MAX_U = _M56                      # unsigned small body range
_SMALL_MIN_I = -(1 << 55)
_SMALL_MAX_I = (1 << 55) - 1

_SYM_CHARS = "_0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ" \
    "abcdefghijklmnopqrstuvwxyz"
_SYM_CODE = {c: i + 1 for i, c in enumerate(_SYM_CHARS)}
_SYM_CHAR = {i + 1: c for i, c in enumerate(_SYM_CHARS)}


_SHORTS_CACHE = None


def _SHORTS():
    """Memoized long->(module, export-char) registry map; rebuilt
    per-frame it costs more than every handler the frame calls."""
    global _SHORTS_CACHE
    if _SHORTS_CACHE is None:
        from stellar_tpu_torch.soroban.env_interface import long_to_short
        _SHORTS_CACHE = long_to_short()
    return _SHORTS_CACHE


class EnvError(Trap):
    """Host-env failure surfaced to wasm as a trap."""


class ContractError(EnvError):
    """fail_with_error trap carrying the contract's Error val so
    try_call can hand the CALLEE'S error back to the caller (the
    reference returns the failing frame's error value)."""

    def __init__(self, msg: str, error_sc):
        super().__init__(msg)
        self.error_sc = error_sc  # SCVal of arm SCV_ERROR


def _tag(val: int) -> int:
    return val & 0xFF


def _body(val: int) -> int:
    return (val >> 8) & _M56


def _make(tag: int, body: int = 0) -> int:
    return ((body & _M56) << 8) | tag


def cmp_scval(a, b, charge=None) -> int:
    """Deep total order over SCVals — the order obj_cmp exposes, map
    entries sort by, and from_scval validates on map ingestion (the
    genuine host rejects out-of-order maps at conversion).
    ``charge(cpu, mem)`` meters size-proportional comparison work so
    the instruction budget bounds real CPU (a flat per-call fee would
    let large-object compares run unmetered)."""
    if charge is not None:
        charge(50, 0)
    if a.arm != b.arm:
        return -1 if a.arm < b.arm else 1
    arm = a.arm
    if arm in (T.SCV_BOOL, T.SCV_U32, T.SCV_I32, T.SCV_U64,
               T.SCV_I64, T.SCV_TIMEPOINT, T.SCV_DURATION):
        return (a.value > b.value) - (a.value < b.value)
    if arm in (T.SCV_U128, T.SCV_I128):
        av = (a.value.hi << 64) | a.value.lo
        bv = (b.value.hi << 64) | b.value.lo
        return (av > bv) - (av < bv)
    if arm in (T.SCV_U256, T.SCV_I256):
        def n256(p):
            hh = p.hi_hi & _M64
            return (hh << 192) | (p.hi_lo << 128) | \
                (p.lo_hi << 64) | p.lo_lo
        if arm == T.SCV_I256 and \
                (a.value.hi_hi < 0) != (b.value.hi_hi < 0):
            return -1 if a.value.hi_hi < 0 else 1
        av, bv = n256(a.value), n256(b.value)
        return (av > bv) - (av < bv)
    if arm in (T.SCV_BYTES, T.SCV_STRING, T.SCV_SYMBOL):
        av, bv = bytes(a.value), bytes(b.value)
        if charge is not None:
            charge(len(av) + len(bv), 0)
        return (av > bv) - (av < bv)
    if arm == T.SCV_VEC:
        ai, bi = list(a.value or ()), list(b.value or ())
        for x, y in zip(ai, bi):
            r = cmp_scval(x, y, charge)
            if r:
                return r
        return (len(ai) > len(bi)) - (len(ai) < len(bi))
    if arm == T.SCV_MAP:
        ai, bi = list(a.value or ()), list(b.value or ())
        for x, y in zip(ai, bi):
            r = cmp_scval(x.key, y.key, charge)
            if r:
                return r
            r = cmp_scval(x.val, y.val, charge)
            if r:
                return r
        return (len(ai) > len(bi)) - (len(ai) < len(bi))
    ab_, bb_ = to_bytes(SCVal, a), to_bytes(SCVal, b)
    if charge is not None:
        charge(len(ab_) + len(bb_), 0)
    return (ab_ > bb_) - (ab_ < bb_)


def sym_to_small(s: bytes) -> int:
    """Pack a <=9-char symbol into a SymbolSmall body (6 bits/char)."""
    if len(s) > 9:
        raise ValueError("symbol too long for small form")
    body = 0
    for ch in s.decode("ascii"):
        code = _SYM_CODE.get(ch)
        if code is None:
            raise ValueError(f"bad symbol char {ch!r}")
        body = (body << 6) | code
    return _make(TAG_SYMBOL_SMALL, body)


from stellar_tpu_torch.utils.cache import RandomEvictionCache
from stellar_tpu_torch.soroban.cost_model import CostType as _COST

_SYM_DECODE_CACHE: RandomEvictionCache = RandomEvictionCache(16384)


def small_to_sym(val: int) -> bytes:
    # memoized: small symbols are frame-independent (the value IS the
    # encoding) and repeat heavily (storage keys, function names)
    cached = _SYM_DECODE_CACHE.maybe_get(val)
    if cached is not None:
        return cached
    body = _body(val)
    chars = []
    while body:
        ch = _SYM_CHAR.get(body & 0x3F)
        if ch is None:
            # a forged Val with an embedded zero 6-bit group must trap
            # the contract, not raise through the host
            raise EnvError("malformed SymbolSmall encoding")
        chars.append(ch)
        body >>= 6
    out = "".join(reversed(chars)).encode()
    _SYM_DECODE_CACHE.put(val, out)
    return out


class ValConverter:
    """SCVal <-> Val conversion plus the per-invocation object table."""

    def __init__(self, charge: Callable[[int, int], None]):
        # charge(cpu, mem) — wired to the host budget
        self.objs: List[Tuple[int, object]] = []  # (tag, payload)
        self.charge = charge

    # ---------------- object table ----------------

    def new_obj(self, tag: int, payload) -> int:
        self.charge(50, 16)
        self.objs.append((tag, payload))
        return _make(tag, len(self.objs) - 1)

    def obj(self, val: int, want_tag: int):
        tag = _tag(val)
        if tag != want_tag:
            raise EnvError(f"expected tag {want_tag}, got {tag}")
        idx = _body(val)
        if idx >= len(self.objs):
            raise EnvError("bad object handle")
        otag, payload = self.objs[idx]
        if otag != want_tag:
            raise EnvError("object tag mismatch")
        return payload

    # ---------------- SCVal -> Val ----------------

    def from_scval(self, v: "SCVal.Value") -> int:
        arm = v.arm
        if arm == T.SCV_BOOL:
            return _make(TAG_TRUE if v.value else TAG_FALSE)
        if arm == T.SCV_VOID:
            return _make(TAG_VOID)
        if arm == T.SCV_U32:
            return _make(TAG_U32, v.value & 0xFFFFFFFF)
        if arm == T.SCV_I32:
            return _make(TAG_I32, v.value & 0xFFFFFFFF)
        if arm == T.SCV_U64:
            if v.value <= _SMALL_MAX_U:
                return _make(TAG_U64_SMALL, v.value)
            return self.new_obj(TAG_U64_OBJ, v.value)
        if arm == T.SCV_I64:
            if _SMALL_MIN_I <= v.value <= _SMALL_MAX_I:
                return _make(TAG_I64_SMALL, v.value)
            return self.new_obj(TAG_I64_OBJ, v.value)
        if arm == T.SCV_TIMEPOINT:
            if v.value <= _SMALL_MAX_U:
                return _make(TAG_TIMEPOINT_SMALL, v.value)
            return self.new_obj(TAG_TIMEPOINT_OBJ, v.value)
        if arm == T.SCV_DURATION:
            if v.value <= _SMALL_MAX_U:
                return _make(TAG_DURATION_SMALL, v.value)
            return self.new_obj(TAG_DURATION_OBJ, v.value)
        if arm == T.SCV_U128:
            n = (v.value.hi << 64) | v.value.lo
            if n <= _SMALL_MAX_U:
                return _make(TAG_U128_SMALL, n)
            return self.new_obj(TAG_U128_OBJ, n)
        if arm == T.SCV_I128:
            n = (v.value.hi << 64) | v.value.lo
            if n >= 1 << 127:
                n -= 1 << 128
            if _SMALL_MIN_I <= n <= _SMALL_MAX_I:
                return _make(TAG_I128_SMALL, n)
            return self.new_obj(TAG_I128_OBJ, n)
        if arm == T.SCV_U256:
            p = v.value
            n = ((p.hi_hi << 192) | (p.hi_lo << 128) |
                 (p.lo_hi << 64) | p.lo_lo)
            if n <= _SMALL_MAX_U:
                return _make(TAG_U256_SMALL, n)
            return self.new_obj(TAG_U256_OBJ, n)
        if arm == T.SCV_I256:
            p = v.value
            n = ((p.hi_hi << 192) | (p.hi_lo << 128) |
                 (p.lo_hi << 64) | p.lo_lo)
            # hi_hi is signed in Int256Parts; normalize to signed 256
            if p.hi_hi < 0:
                n = ((p.hi_hi & _M64) << 192 | (p.hi_lo << 128) |
                     (p.lo_hi << 64) | p.lo_lo) - (1 << 256)
            if _SMALL_MIN_I <= n <= _SMALL_MAX_I:
                return _make(TAG_I256_SMALL, n)
            return self.new_obj(TAG_I256_OBJ, n)
        if arm == T.SCV_ERROR:
            err = v.value
            return _make(TAG_ERROR,
                         ((int(err.arm) & 0xFFFFFF) << 32) |
                         (int(err.value) & 0xFFFFFFFF))
        if arm == T.SCV_SYMBOL:
            if len(v.value) <= 9:
                try:
                    return sym_to_small(v.value)
                except ValueError:
                    pass
            return self.new_obj(TAG_SYMBOL_OBJ, bytes(v.value))
        if arm == T.SCV_BYTES:
            return self.new_obj(TAG_BYTES_OBJ, bytes(v.value))
        if arm == T.SCV_STRING:
            return self.new_obj(TAG_STRING_OBJ, bytes(v.value))
        if arm == T.SCV_VEC:
            items = [self.from_scval(e) for e in (v.value or ())]
            return self.new_obj(TAG_VEC_OBJ, items)
        if arm == T.SCV_MAP:
            # the host invariant every map op relies on (bisect in
            # map_put, positional unpack) is sorted-unique keys; maps
            # arriving from XDR/args are validated here exactly like
            # the genuine host, which rejects out-of-order maps at
            # conversion
            entries = list(v.value or ())
            for i in range(1, len(entries)):
                if cmp_scval(entries[i - 1].key, entries[i].key,
                             self.charge) >= 0:
                    raise EnvError("map keys not sorted-unique")
            pairs = [(self.from_scval(e.key), self.from_scval(e.val))
                     for e in entries]
            return self.new_obj(TAG_MAP_OBJ, pairs)
        if arm == T.SCV_ADDRESS:
            return self.new_obj(TAG_ADDRESS_OBJ, v.value)
        raise EnvError(f"SCVal arm {arm} has no Val form")

    # ---------------- Val -> SCVal ----------------

    def to_scval(self, val: int) -> "SCVal.Value":
        val &= _M64
        tag = _tag(val)
        if tag < 64 and tag != TAG_ERROR:
            # small tags ARE their value (no object table, no charges):
            # the conversion is pure, so memoize it process-wide. The
            # same counter values, symbols, and u32 codes recur every
            # invoke, and the SCVal churn was the single biggest
            # wasm-engine-only cost at scenario level. SCVals are
            # treated as immutable throughout (storage shares them the
            # same way, see _storage_args).
            hit = _SMALL_SCVAL_CACHE.maybe_get(val)
            if hit is not None:
                return hit
            sc = self._to_scval_uncached(val)
            _SMALL_SCVAL_CACHE.put(val, sc)
            return sc
        return self._to_scval_uncached(val)

    def _to_scval_uncached(self, val: int) -> "SCVal.Value":
        tag = _tag(val)
        body = _body(val)
        if tag == TAG_FALSE:
            return SCVal.make(T.SCV_BOOL, False)
        if tag == TAG_TRUE:
            return SCVal.make(T.SCV_BOOL, True)
        if tag == TAG_VOID:
            return SCVal.make(T.SCV_VOID)
        if tag == TAG_U32:
            return SCVal.make(T.SCV_U32, body & 0xFFFFFFFF)
        if tag == TAG_I32:
            b = body & 0xFFFFFFFF
            return SCVal.make(T.SCV_I32,
                              b - (1 << 32) if b >> 31 else b)
        if tag == TAG_U64_SMALL:
            return SCVal.make(T.SCV_U64, body)
        if tag == TAG_I64_SMALL:
            return SCVal.make(
                T.SCV_I64, body - (1 << 56) if body >> 55 else body)
        if tag == TAG_TIMEPOINT_SMALL:
            return SCVal.make(T.SCV_TIMEPOINT, body)
        if tag == TAG_DURATION_SMALL:
            return SCVal.make(T.SCV_DURATION, body)
        if tag == TAG_U128_SMALL:
            return self._u128(body)
        if tag == TAG_I128_SMALL:
            return self._i128(body - (1 << 56) if body >> 55 else body)
        if tag == TAG_U256_SMALL:
            return self._u256(body)
        if tag == TAG_I256_SMALL:
            return self._i256(body - (1 << 56) if body >> 55 else body)
        if tag == TAG_ERROR:
            return self._error(body)
        if tag == TAG_SYMBOL_SMALL:
            return SCVal.make(T.SCV_SYMBOL, small_to_sym(val))
        if tag == TAG_U64_OBJ:
            return SCVal.make(T.SCV_U64, self.obj(val, tag))
        if tag == TAG_I64_OBJ:
            return SCVal.make(T.SCV_I64, self.obj(val, tag))
        if tag == TAG_TIMEPOINT_OBJ:
            return SCVal.make(T.SCV_TIMEPOINT, self.obj(val, tag))
        if tag == TAG_DURATION_OBJ:
            return SCVal.make(T.SCV_DURATION, self.obj(val, tag))
        if tag == TAG_U128_OBJ:
            return self._u128(self.obj(val, tag))
        if tag == TAG_I128_OBJ:
            return self._i128(self.obj(val, tag))
        if tag == TAG_U256_OBJ:
            return self._u256(self.obj(val, tag))
        if tag == TAG_I256_OBJ:
            return self._i256(self.obj(val, tag))
        if tag == TAG_BYTES_OBJ:
            return SCVal.make(T.SCV_BYTES, self.obj(val, tag))
        if tag == TAG_STRING_OBJ:
            return SCVal.make(T.SCV_STRING, self.obj(val, tag))
        if tag == TAG_SYMBOL_OBJ:
            return SCVal.make(T.SCV_SYMBOL, self.obj(val, tag))
        if tag == TAG_VEC_OBJ:
            return SCVal.make(T.SCV_VEC, [
                self.to_scval(e) for e in self.obj(val, tag)])
        if tag == TAG_MAP_OBJ:
            return SCVal.make(T.SCV_MAP, [
                SCMapEntry(key=self.to_scval(k), val=self.to_scval(w))
                for k, w in self.obj(val, tag)])
        if tag == TAG_ADDRESS_OBJ:
            return SCVal.make(T.SCV_ADDRESS, self.obj(val, tag))
        raise EnvError(f"bad Val tag {tag}")

    @staticmethod
    def _u128(n: int):
        from stellar_tpu_torch.xdr.contract import UInt128Parts
        return SCVal.make(T.SCV_U128, UInt128Parts(
            hi=(n >> 64) & _M64, lo=n & _M64))

    @staticmethod
    def _i128(n: int):
        from stellar_tpu_torch.xdr.contract import Int128Parts
        u = n & ((1 << 128) - 1)
        hi = (u >> 64) & _M64
        if hi >= 1 << 63:
            hi -= 1 << 64  # Int128Parts.hi is a signed int64
        return SCVal.make(T.SCV_I128, Int128Parts(hi=hi, lo=u & _M64))

    @staticmethod
    def _u256(n: int):
        from stellar_tpu_torch.xdr.contract import UInt256Parts
        return SCVal.make(T.SCV_U256, UInt256Parts(
            hi_hi=(n >> 192) & _M64, hi_lo=(n >> 128) & _M64,
            lo_hi=(n >> 64) & _M64, lo_lo=n & _M64))

    @staticmethod
    def _i256(n: int):
        from stellar_tpu_torch.xdr.contract import Int256Parts
        u = n & ((1 << 256) - 1)
        hi_hi = (u >> 192) & _M64
        if hi_hi >= 1 << 63:
            hi_hi -= 1 << 64  # Int256Parts.hi_hi is a signed int64
        return SCVal.make(T.SCV_I256, Int256Parts(
            hi_hi=hi_hi, hi_lo=(u >> 128) & _M64,
            lo_hi=(u >> 64) & _M64, lo_lo=u & _M64))

    @staticmethod
    def _error(body: int):
        from stellar_tpu_torch.xdr.contract import (
            SCError, SCErrorCode, SCErrorType,
        )
        etype = (body >> 32) & 0xFFFFFF
        code = body & 0xFFFFFFFF
        if etype not in SCErrorType.by_value:
            raise EnvError(f"bad error type {etype}")
        if etype != SCErrorType.SCE_CONTRACT and \
                code not in SCErrorCode.by_value:
            raise EnvError(f"bad error code {code}")
        return SCVal.make(T.SCV_ERROR, SCError.make(etype, code))


# ---------------------------------------------------------------------------
# Host-function imports
# ---------------------------------------------------------------------------

# small-tag Val -> SCVal memo (pure, chargeless conversions only)
_SMALL_SCVAL_CACHE: "RandomEvictionCache" = RandomEvictionCache(4096)

_DUR_BY_CODE = {0: "temporary", 1: "persistent", 2: "instance"}
# (contract id, small key val, storage code) -> (SCVal, dur, kb);
# see _storage_args for the safety argument
_STORAGE_ARGS_CACHE: RandomEvictionCache = RandomEvictionCache(8192)


def make_imports(env) -> Dict[Tuple[str, str], Callable]:
    """The import table for one contract frame. ``env`` is a
    ``WasmContractEnv`` (defined in host.py) carrying the host, the
    running contract's address, and the ValConverter."""
    cv: ValConverter = env.cv

    def _frame_version() -> int:
        """THE protocol version this frame runs under — shared by
        get_ledger_version, the era gates, and the link-time check, so
        a contract can never observe one version and be served
        another's function set. Headerless hosts (unit tests, direct
        simulation) run as the current protocol."""
        from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
        hdr = getattr(env.host, "ledger_header", None)
        return hdr.ledgerVersion if hdr is not None \
            else CURRENT_LEDGER_PROTOCOL_VERSION

    def _u32_arg(val: int, what: str) -> int:
        if _tag(val) != TAG_U32:
            raise EnvError(f"{what}: expected U32 val")
        return _body(val) & 0xFFFFFFFF

    # ---- context ----

    def log(inst, val):
        env.host.budget.charge(100, 0)
        from stellar_tpu_torch.soroban import host as host_mod
        if host_mod.DIAGNOSTIC_EVENTS_ENABLED:
            env.host.diagnostics.append(cv.to_scval(val))
        return _make(TAG_VOID)

    def ledger_sequence(inst):
        return _make(TAG_U32, env.host.ledger_seq)

    def ledger_timestamp(inst):
        ts = 0
        hdr = getattr(env.host, "ledger_header", None)
        if hdr is not None:
            ts = hdr.scpValue.closeTime
        return _make(TAG_U64_SMALL, ts) if ts <= _SMALL_MAX_U \
            else cv.new_obj(TAG_U64_OBJ, ts)

    def current_contract_address(inst):
        return cv.new_obj(TAG_ADDRESS_OBJ, env.contract_addr)

    def contract_event(inst, topics_val, data_val):
        topics_sc = cv.to_scval(topics_val)
        if topics_sc.arm != T.SCV_VEC:
            raise EnvError("event topics must be a vec")
        env.host.emit_event(env.contract_addr,
                            list(topics_sc.value or ()),
                            cv.to_scval(data_val))
        return _make(TAG_VOID)

    def fail(inst):
        raise EnvError("contract called fail")

    # ---- ledger ----

    # hot-path bindings hoisted out of the per-call handlers (a
    # function-level import costs ~1-2us and storage ops run several
    # times per invoke)
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes as _key_bytes
    from stellar_tpu_torch.soroban.host import (
        contract_data_key as _contract_data_key,
    )
    from stellar_tpu_torch.xdr.contract import (
        ContractDataDurability as _Durability,
    )

    def _storage_args(k_val, t_val):
        """(key_scval, durability|None, kb|None) — durability None
        means instance storage; key is converted exactly once.

        Small-tag keys (tag < 64: the value IS the encoding, no
        object-table indirection) are memoized per contract id:
        storage keys like a counter's symbol repeat every tx, and for
        small tags the conversion path is charge-free, so a cache hit
        is metering-identical to a rebuild. The cached SCVal/LedgerKey
        are shared — storage treats keys as immutable."""
        code = _u32_arg(t_val, "storage type")
        kind = _DUR_BY_CODE.get(code)
        if kind is None:
            raise EnvError("bad storage type")
        cacheable = (_tag(k_val) < 64 and kind != "instance" and
                     isinstance(env.contract_addr.value, bytes))
        if cacheable:
            ckey = (env.contract_addr.value, k_val, code)
            hit = _STORAGE_ARGS_CACHE.maybe_get(ckey)
            if hit is not None:
                return hit
        # single derivation path — first call and cache hit MUST stay
        # behavior-identical (metering parity)
        key_sc = cv.to_scval(k_val)
        if kind == "instance":
            return key_sc, None, None
        dur = _Durability.PERSISTENT if kind == "persistent" \
            else _Durability.TEMPORARY
        kb = _key_bytes(_contract_data_key(env.contract_addr, key_sc,
                                           dur))
        out = (key_sc, dur, kb)
        if cacheable:
            _STORAGE_ARGS_CACHE.put(ckey, out)
        return out

    def put_contract_data(inst, k_val, v_val, t_val):
        key_sc, dur, _kb = _storage_args(k_val, t_val)
        if dur is None:
            env.instance_put(key_sc, cv.to_scval(v_val))
        else:
            env.data_put(key_sc, cv.to_scval(v_val), dur)
        return _make(TAG_VOID)

    def get_contract_data(inst, k_val, t_val):
        key_sc, dur, kb = _storage_args(k_val, t_val)
        sc = env.instance_get(key_sc) if dur is None \
            else env.data_get(kb)
        if sc is None:
            raise EnvError("missing contract data")
        return cv.from_scval(sc)

    def has_contract_data(inst, k_val, t_val):
        key_sc, dur, kb = _storage_args(k_val, t_val)
        sc = env.instance_get(key_sc) if dur is None \
            else env.data_get(kb)
        return _make(TAG_TRUE if sc is not None else TAG_FALSE)

    def del_contract_data(inst, k_val, t_val):
        key_sc, dur, kb = _storage_args(k_val, t_val)
        if dur is None:
            env.instance_del(key_sc)
        else:
            env.data_del(kb)
        return _make(TAG_VOID)

    def extend_contract_data_ttl(inst, k_val, t_val, thresh_val,
                                 ext_val):
        key_sc, dur, kb = _storage_args(k_val, t_val)
        if dur is None:
            raise EnvError("use the instance TTL host fn for "
                           "instance storage")
        env.host.extend_ttl(kb, _u32_arg(thresh_val, "threshold"),
                            _u32_arg(ext_val, "extend_to"))
        return _make(TAG_VOID)

    def extend_instance_and_code_ttl(inst, thresh_val, ext_val):
        """Extend the current contract's instance entry AND its code
        entry (reference extend_current_contract_instance_and_code_ttl)."""
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.soroban.host import (
            contract_code_key, contract_data_key,
        )
        from stellar_tpu_torch.xdr.contract import (
            ContractDataDurability, ContractExecutableType,
        )
        thresh = _u32_arg(thresh_val, "threshold")
        ext = _u32_arg(ext_val, "extend_to")
        inst_kb = key_bytes(contract_data_key(
            env.contract_addr,
            SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE),
            ContractDataDurability.PERSISTENT))
        env.host.extend_ttl(inst_kb, thresh, ext)
        slot = env.host.storage.entries.get(inst_kb)
        if slot is not None and slot[0] is not None:
            instance = slot[0].data.value.val.value
            if instance.executable.arm == \
                    ContractExecutableType.CONTRACT_EXECUTABLE_WASM:
                code_kb = key_bytes(contract_code_key(
                    instance.executable.value))
                env.host.extend_ttl(code_kb, thresh, ext)
        return _make(TAG_VOID)

    # ---- vec ----
    # Structural ops charge proportionally to the work they do (copy
    # size, entries compared) — a flat per-call fee would let real CPU
    # and memory run unbounded relative to the instruction budget
    # (reference: soroban's per-cost-type calibrated charges).

    def vec_new(inst):
        return cv.new_obj(TAG_VEC_OBJ, [])

    def vec_push_back(inst, vec_val, item):
        items = list(cv.obj(vec_val, TAG_VEC_OBJ))
        env.host.budget.charge(10 + len(items), 8 * (len(items) + 1))
        items.append(item & _M64)
        return cv.new_obj(TAG_VEC_OBJ, items)

    def vec_get(inst, vec_val, i_val):
        items = cv.obj(vec_val, TAG_VEC_OBJ)
        i = _u32_arg(i_val, "vec index")
        if i >= len(items):
            raise EnvError("vec index out of bounds")
        return items[i]

    def vec_len(inst, vec_val):
        return _make(TAG_U32, len(cv.obj(vec_val, TAG_VEC_OBJ)))

    # ---- map (entries kept sorted by canonical SCVal key bytes) ----

    def _map_key_bytes(v: int) -> bytes:
        kb = to_bytes(SCVal, cv.to_scval(v))
        # the encode itself is the dominant cost of every compare
        env.host.budget.charge(30 + 2 * len(kb), 0)
        return kb

    def map_new(inst):
        return cv.new_obj(TAG_MAP_OBJ, [])

    def map_put(inst, map_val, k, v):
        # the pair list is kept sorted in the deep Val order (the SAME
        # total order obj_cmp exposes, so map_key_by_pos /
        # vec_binary_search over map_keys stay mutually consistent);
        # bisect to the slot in O(log n) compares
        pairs = list(cv.obj(map_val, TAG_MAP_OBJ))
        env.host.budget.charge(10 + len(pairs), 16 * (len(pairs) + 1))
        lo, hi = 0, len(pairs)
        while lo < hi:
            mid = (lo + hi) // 2
            if _cmp_vals(pairs[mid][0], k) < 0:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(pairs) and _cmp_vals(pairs[lo][0], k) == 0:
            pairs[lo] = (k & _M64, v & _M64)
        else:
            pairs.insert(lo, (k & _M64, v & _M64))
        return cv.new_obj(TAG_MAP_OBJ, pairs)

    def map_get(inst, map_val, k):
        kb = _map_key_bytes(k)
        for pk, pv in cv.obj(map_val, TAG_MAP_OBJ):
            if _map_key_bytes(pk) == kb:
                return pv
        raise EnvError("map key not found")

    def map_has(inst, map_val, k):
        kb = _map_key_bytes(k)
        for pk, _pv in cv.obj(map_val, TAG_MAP_OBJ):
            if _map_key_bytes(pk) == kb:
                return _make(TAG_TRUE)
        return _make(TAG_FALSE)

    def map_len(inst, map_val):
        return _make(TAG_U32, len(cv.obj(map_val, TAG_MAP_OBJ)))

    # ---- bytes / string / symbol <-> linear memory ----

    def bytes_new_from_linear_memory(inst, ptr_val, len_val):
        ptr = _u32_arg(ptr_val, "ptr")
        n = _u32_arg(len_val, "len")
        env.host.budget.charge(50 + 2 * n, n)
        return cv.new_obj(TAG_BYTES_OBJ, inst.mem_read(ptr, n))

    def bytes_copy_to_linear_memory(inst, b_val, off_val, ptr_val,
                                    len_val):
        data = cv.obj(b_val, TAG_BYTES_OBJ)
        off = _u32_arg(off_val, "offset")
        ptr = _u32_arg(ptr_val, "ptr")
        n = _u32_arg(len_val, "len")
        if off + n > len(data):
            raise EnvError("bytes copy out of range")
        env.host.budget.charge(50 + 2 * n, 0)
        inst.mem_write(ptr, data[off:off + n])
        return _make(TAG_VOID)

    def bytes_len(inst, b_val):
        return _make(TAG_U32, len(cv.obj(b_val, TAG_BYTES_OBJ)))

    def bytes_get(inst, b_val, i_val):
        data = cv.obj(b_val, TAG_BYTES_OBJ)
        i = _u32_arg(i_val, "index")
        if i >= len(data):
            raise EnvError("bytes index out of bounds")
        return _make(TAG_U32, data[i])

    def symbol_new_from_linear_memory(inst, ptr_val, len_val):
        ptr = _u32_arg(ptr_val, "ptr")
        n = _u32_arg(len_val, "len")
        raw = inst.mem_read(ptr, n)
        env.host.budget.charge(50 + 2 * n, n)
        if n <= 9:
            try:
                return sym_to_small(raw)
            except ValueError:
                pass
        return cv.new_obj(TAG_SYMBOL_OBJ, raw)

    def string_new_from_linear_memory(inst, ptr_val, len_val):
        ptr = _u32_arg(ptr_val, "ptr")
        n = _u32_arg(len_val, "len")
        env.host.budget.charge(50 + 2 * n, n)
        return cv.new_obj(TAG_STRING_OBJ, inst.mem_read(ptr, n))

    # ---- int object conversions (raw wasm i64 <-> Val) ----

    def obj_from_u64(inst, raw):
        raw &= _M64
        if raw <= _SMALL_MAX_U:
            return _make(TAG_U64_SMALL, raw)
        return cv.new_obj(TAG_U64_OBJ, raw)

    def obj_to_u64(inst, val):
        sc = cv.to_scval(val)
        if sc.arm != T.SCV_U64:
            raise EnvError("not a u64")
        return sc.value

    def obj_from_i64(inst, raw):
        raw &= _M64
        signed = raw - (1 << 64) if raw >> 63 else raw
        if _SMALL_MIN_I <= signed <= _SMALL_MAX_I:
            return _make(TAG_I64_SMALL, signed)
        return cv.new_obj(TAG_I64_OBJ, signed)

    def obj_to_i64(inst, val):
        sc = cv.to_scval(val)
        if sc.arm != T.SCV_I64:
            raise EnvError("not an i64")
        return sc.value & _M64

    # ---- address / auth ----

    def require_auth(inst, addr_val):
        addr = cv.obj(addr_val, TAG_ADDRESS_OBJ)
        env.host.require_auth(
            SCVal.make(T.SCV_ADDRESS, addr), env.invocation,
            env.depth)
        return _make(TAG_VOID)

    # ---- cross-contract call ----

    def call(inst, addr_val, fn_val, args_val):
        addr_sc = cv.to_scval(addr_val)
        fn_sc = cv.to_scval(fn_val)
        args_sc = cv.to_scval(args_val)
        if addr_sc.arm != T.SCV_ADDRESS or fn_sc.arm != T.SCV_SYMBOL \
                or args_sc.arm != T.SCV_VEC:
            raise EnvError("call needs (address, symbol, vec)")
        rv = env.host.call_contract(addr_sc.value, fn_sc.value,
                                    list(args_sc.value or ()),
                                    env.depth + 1)
        return cv.from_scval(rv)

    # ---- crypto ----

    def compute_sha256(inst, b_val):
        data = cv.obj(b_val, TAG_BYTES_OBJ)
        env.charge_type(_COST.ComputeSha256Hash, len(data))
        return cv.new_obj(TAG_BYTES_OBJ, sha256(data))

    # ---- prng (deterministic per-frame stream; reference "p") ----

    def _frame_prng():
        if env.prng is None:
            env.prng = env.host.fork_prng()
        return env.prng

    def prng_u64_in_inclusive_range(inst, lo_raw, hi_raw):
        env.host.budget.charge(100, 0)
        return _frame_prng().u64_in_range(lo_raw & _M64,
                                          hi_raw & _M64) & _M64

    def prng_bytes_new(inst, len_val):
        n = _u32_arg(len_val, "prng length")
        env.host.budget.charge(100 + 2 * n, n)
        return cv.new_obj(TAG_BYTES_OBJ, _frame_prng().take(n))

    def prng_reseed(inst, b_val):
        data = cv.obj(b_val, TAG_BYTES_OBJ)
        env.host.budget.charge(100 + len(data), 0)
        _frame_prng().reseed(data)
        return _make(TAG_VOID)

    def prng_vec_shuffle(inst, vec_val):
        items = list(cv.obj(vec_val, TAG_VEC_OBJ))
        env.host.budget.charge(100 + 10 * len(items),
                               8 * (len(items) + 1))
        prng = _frame_prng()
        # Fisher-Yates with the deterministic frame stream
        for i in range(len(items) - 1, 0, -1):
            j = prng.u64_in_range(0, i)
            items[i], items[j] = items[j], items[i]
        return cv.new_obj(TAG_VEC_OBJ, items)

    # =====================================================================
    # modern-env surface (the genuine soroban interface; every handler
    # below also registers under its single-char export name)
    # =====================================================================

    # identity-stable across env.reset() (frame pooling): forwards to
    # the CURRENT frame's budget
    charge = env.charge
    # metered cost-model charge: ContractCostType + the calibrated
    # (const, linear) tables (soroban/cost_model.py; reference
    # NetworkConfig.cpp initial params, upgradable consensus state)
    charge_ct = env.charge_type
    CT = _COST

    def _bytes_of(val):
        return cv.obj(val, TAG_BYTES_OBJ)

    def _sym_bytes(val) -> bytes:
        if _tag(val) == TAG_SYMBOL_SMALL:
            return small_to_sym(val)
        return cv.obj(val, TAG_SYMBOL_OBJ)

    def _str_bytes(val) -> bytes:
        return cv.obj(val, TAG_STRING_OBJ)

    def _raw64(v: int) -> int:
        return v & _M64

    # ---- deep total order (obj_cmp and the vec search family) ----

    def _cmp_sc(a, b) -> int:
        return cmp_scval(a, b, charge)

    def _cmp_vals(a_val: int, b_val: int) -> int:
        return _cmp_sc(cv.to_scval(a_val), cv.to_scval(b_val))

    # ---- context ----

    def obj_cmp(inst, a_val, b_val):
        return _raw64(_cmp_vals(a_val, b_val))

    def log_from_linear_memory(inst, msg_pos, msg_len, vals_pos,
                               vals_len):
        mp = _u32_arg(msg_pos, "msg pos")
        ml = _u32_arg(msg_len, "msg len")
        vp = _u32_arg(vals_pos, "vals pos")
        vl = _u32_arg(vals_len, "vals len")
        charge(100 + 2 * ml + 10 * vl, 0)
        from stellar_tpu_torch.soroban import host as host_mod
        if host_mod.DIAGNOSTIC_EVENTS_ENABLED:
            msg = inst.mem_read(mp, ml)
            vals = [cv.to_scval(int.from_bytes(
                inst.mem_read(vp + 8 * i, 8), "little"))
                for i in range(vl)]
            env.host.diagnostics.append(SCVal.make(T.SCV_VEC, [
                SCVal.make(T.SCV_STRING, msg)] + vals))
        return _make(TAG_VOID)

    def get_ledger_version(inst):
        return _make(TAG_U32, _frame_version())

    def fail_with_error(inst, err_val):
        from stellar_tpu_torch.xdr.contract import (
            SCError, SCErrorCode, SCErrorType,
        )
        if _tag(err_val) != TAG_ERROR:
            raise EnvError("fail_with_error needs an Error val")
        sc = cv.to_scval(err_val)
        if sc.value.arm != SCErrorType.SCE_CONTRACT:
            # only contract-typed errors may be raised by contracts;
            # anything else is replaced (reference host behavior)
            sc = SCVal.make(T.SCV_ERROR, SCError.make(
                SCErrorType.SCE_CONTEXT,
                SCErrorCode.SCEC_UNEXPECTED_TYPE))
        raise ContractError(
            f"contract failure: error type {sc.value.arm} "
            f"code {sc.value.value}", sc)

    def get_ledger_network_id(inst):
        charge(100, 32)
        return cv.new_obj(TAG_BYTES_OBJ, env.host.network_id)

    def get_max_live_until_ledger(inst):
        return _make(TAG_U32, env.host.ledger_seq +
                     env.host.config.max_entry_ttl - 1)

    # ---- int: 128/256-bit objects + arithmetic ----

    def obj_from_u128_pieces(inst, hi, lo):
        n = (_raw64(hi) << 64) | _raw64(lo)
        if n <= _SMALL_MAX_U:
            return _make(TAG_U128_SMALL, n)
        return cv.new_obj(TAG_U128_OBJ, n)

    def _u128_of(val) -> int:
        tag = _tag(val)
        if tag == TAG_U128_SMALL:
            return _body(val)
        return cv.obj(val, TAG_U128_OBJ)

    def obj_to_u128_lo64(inst, val):
        return _u128_of(val) & _M64

    def obj_to_u128_hi64(inst, val):
        return (_u128_of(val) >> 64) & _M64

    def obj_from_i128_pieces(inst, hi, lo):
        hi_s = _raw64(hi)
        if hi_s >> 63:
            hi_s -= 1 << 64
        n = (hi_s << 64) | _raw64(lo)
        if _SMALL_MIN_I <= n <= _SMALL_MAX_I:
            return _make(TAG_I128_SMALL, n)
        return cv.new_obj(TAG_I128_OBJ, n)

    def _i128_of(val) -> int:
        tag = _tag(val)
        if tag == TAG_I128_SMALL:
            b = _body(val)
            return b - (1 << 56) if b >> 55 else b
        return cv.obj(val, TAG_I128_OBJ)

    def obj_to_i128_lo64(inst, val):
        return _i128_of(val) & _M64

    def obj_to_i128_hi64(inst, val):
        return (_i128_of(val) >> 64) & _M64

    _U256_MAX = (1 << 256) - 1
    _I256_MIN = -(1 << 255)
    _I256_MAX = (1 << 255) - 1

    def _mk_u256(n: int):
        if n <= _SMALL_MAX_U:
            return _make(TAG_U256_SMALL, n)
        return cv.new_obj(TAG_U256_OBJ, n)

    def _mk_i256(n: int):
        if _SMALL_MIN_I <= n <= _SMALL_MAX_I:
            return _make(TAG_I256_SMALL, n)
        return cv.new_obj(TAG_I256_OBJ, n)

    def _u256_of(val) -> int:
        tag = _tag(val)
        if tag == TAG_U256_SMALL:
            return _body(val)
        return cv.obj(val, TAG_U256_OBJ)

    def _i256_of(val) -> int:
        tag = _tag(val)
        if tag == TAG_I256_SMALL:
            b = _body(val)
            return b - (1 << 56) if b >> 55 else b
        return cv.obj(val, TAG_I256_OBJ)

    def obj_from_u256_pieces(inst, hi_hi, hi_lo, lo_hi, lo_lo):
        n = ((_raw64(hi_hi) << 192) | (_raw64(hi_lo) << 128) |
             (_raw64(lo_hi) << 64) | _raw64(lo_lo))
        return _mk_u256(n)

    def obj_to_u256_hi_hi(inst, val):
        return (_u256_of(val) >> 192) & _M64

    def obj_to_u256_hi_lo(inst, val):
        return (_u256_of(val) >> 128) & _M64

    def obj_to_u256_lo_hi(inst, val):
        return (_u256_of(val) >> 64) & _M64

    def obj_to_u256_lo_lo(inst, val):
        return _u256_of(val) & _M64

    def obj_from_i256_pieces(inst, hi_hi, hi_lo, lo_hi, lo_lo):
        hh = _raw64(hi_hi)
        if hh >> 63:
            hh -= 1 << 64
        n = ((hh << 192) | (_raw64(hi_lo) << 128) |
             (_raw64(lo_hi) << 64) | _raw64(lo_lo))
        return _mk_i256(n)

    def obj_to_i256_hi_hi(inst, val):
        return (_i256_of(val) >> 192) & _M64

    def obj_to_i256_hi_lo(inst, val):
        return (_i256_of(val) >> 128) & _M64

    def obj_to_i256_lo_hi(inst, val):
        return (_i256_of(val) >> 64) & _M64

    def obj_to_i256_lo_lo(inst, val):
        return _i256_of(val) & _M64

    def u256_val_from_be_bytes(inst, b_val):
        data = _bytes_of(b_val)
        if len(data) != 32:
            raise EnvError("u256 bytes must be exactly 32")
        charge(100, 32)
        return _mk_u256(int.from_bytes(data, "big"))

    def u256_val_to_be_bytes(inst, val):
        charge(100, 32)
        return cv.new_obj(TAG_BYTES_OBJ,
                          _u256_of(val).to_bytes(32, "big"))

    def i256_val_from_be_bytes(inst, b_val):
        data = _bytes_of(b_val)
        if len(data) != 32:
            raise EnvError("i256 bytes must be exactly 32")
        charge(100, 32)
        n = int.from_bytes(data, "big")
        if n > _I256_MAX:
            n -= 1 << 256
        return _mk_i256(n)

    def i256_val_to_be_bytes(inst, val):
        charge(100, 32)
        return cv.new_obj(
            TAG_BYTES_OBJ,
            (_i256_of(val) & _U256_MAX).to_bytes(32, "big"))

    def _u256_binop(op, ct=None):
        def fn(inst, a_val, b_val):
            charge_ct(CT.Int256AddSub if ct is None else ct)
            a, b = _u256_of(a_val), _u256_of(b_val)
            r = op(a, b)
            if r is None or not (0 <= r <= _U256_MAX):
                raise EnvError("u256 arithmetic out of range")
            return _mk_u256(r)
        return fn

    def _i256_binop(op, ct=None):
        def fn(inst, a_val, b_val):
            charge_ct(CT.Int256AddSub if ct is None else ct)
            a, b = _i256_of(a_val), _i256_of(b_val)
            r = op(a, b)
            if r is None or not (_I256_MIN <= r <= _I256_MAX):
                raise EnvError("i256 arithmetic out of range")
            return _mk_i256(r)
        return fn

    def _div(a, b):
        if b == 0:
            return None
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q  # truncating

    def _rem_euclid(a, b):
        if b == 0:
            return None
        return a % abs(b)  # Python % with positive modulus is Euclidean

    def _pow_checked(a, b, limit):
        # bases 0/±1 succeed at ANY u32 exponent; for |a| >= 2 an
        # exponent above 256 always overflows 256 bits
        if a == 0:
            return 1 if b == 0 else 0
        if a == 1:
            return 1
        if a == -1:
            return 1 if b % 2 == 0 else -1
        if b > 256:
            return None
        r = 1
        for _ in range(b):
            r *= a
            if abs(r) > limit:
                return None
        return r

    u256_add = _u256_binop(lambda a, b: a + b)
    u256_sub = _u256_binop(lambda a, b: a - b)
    u256_mul = _u256_binop(lambda a, b: a * b, _COST.Int256Mul)
    u256_div = _u256_binop(_div, _COST.Int256Div)
    u256_rem_euclid = _u256_binop(_rem_euclid, _COST.Int256Div)
    i256_add = _i256_binop(lambda a, b: a + b)
    i256_sub = _i256_binop(lambda a, b: a - b)
    i256_mul = _i256_binop(lambda a, b: a * b, _COST.Int256Mul)
    i256_div = _i256_binop(_div, _COST.Int256Div)
    i256_rem_euclid = _i256_binop(_rem_euclid, _COST.Int256Div)

    def u256_pow(inst, a_val, p_val):
        charge_ct(CT.Int256Pow)
        p = _u32_arg(p_val, "pow exponent")
        r = _pow_checked(_u256_of(a_val), p, _U256_MAX)
        if r is None or r > _U256_MAX:
            raise EnvError("u256 pow out of range")
        return _mk_u256(r)

    def i256_pow(inst, a_val, p_val):
        charge_ct(CT.Int256Pow)
        p = _u32_arg(p_val, "pow exponent")
        r = _pow_checked(_i256_of(a_val), p, 1 << 256)
        if r is None or not (_I256_MIN <= r <= _I256_MAX):
            raise EnvError("i256 pow out of range")
        return _mk_i256(r)

    def u256_shl(inst, a_val, s_val):
        charge_ct(CT.Int256Shift)
        s = _u32_arg(s_val, "shift")
        if s >= 256:
            raise EnvError("u256 shift out of range")
        # checked_shl semantics: only the shift amount can error;
        # bits shifted past 256 are discarded
        return _mk_u256((_u256_of(a_val) << s) & _U256_MAX)

    def u256_shr(inst, a_val, s_val):
        charge_ct(CT.Int256Shift)
        s = _u32_arg(s_val, "shift")
        if s >= 256:
            raise EnvError("u256 shift out of range")
        return _mk_u256(_u256_of(a_val) >> s)

    def i256_shl(inst, a_val, s_val):
        charge_ct(CT.Int256Shift)
        s = _u32_arg(s_val, "shift")
        if s >= 256:
            raise EnvError("i256 shift out of range")
        # checked_shl: wrap into the signed 256-bit range, bits drop
        r = (_i256_of(a_val) << s) & _U256_MAX
        if r > _I256_MAX:
            r -= 1 << 256
        return _mk_i256(r)

    def i256_shr(inst, a_val, s_val):
        charge_ct(CT.Int256Shift)
        s = _u32_arg(s_val, "shift")
        if s >= 256:
            raise EnvError("i256 shift out of range")
        return _mk_i256(_i256_of(a_val) >> s)  # arithmetic shift

    def timepoint_obj_from_u64(inst, raw):
        raw = _raw64(raw)
        if raw <= _SMALL_MAX_U:
            return _make(TAG_TIMEPOINT_SMALL, raw)
        return cv.new_obj(TAG_TIMEPOINT_OBJ, raw)

    def timepoint_obj_to_u64(inst, val):
        if _tag(val) == TAG_TIMEPOINT_SMALL:
            return _body(val)
        return cv.obj(val, TAG_TIMEPOINT_OBJ)

    def duration_obj_from_u64(inst, raw):
        raw = _raw64(raw)
        if raw <= _SMALL_MAX_U:
            return _make(TAG_DURATION_SMALL, raw)
        return cv.new_obj(TAG_DURATION_OBJ, raw)

    def duration_obj_to_u64(inst, val):
        if _tag(val) == TAG_DURATION_SMALL:
            return _body(val)
        return cv.obj(val, TAG_DURATION_OBJ)

    # ---- vec (remaining surface) ----

    def _vec_of(val):
        return cv.obj(val, TAG_VEC_OBJ)

    def _vec_index(items, i_val, what="vec index", allow_end=False):
        i = _u32_arg(i_val, what)
        limit = len(items) + (1 if allow_end else 0)
        if i >= limit:
            raise EnvError(f"{what} out of bounds")
        return i

    def vec_put(inst, vec_val, i_val, x):
        items = list(_vec_of(vec_val))
        i = _vec_index(items, i_val)
        charge(10 + len(items), 8 * len(items))
        items[i] = x & _M64
        return cv.new_obj(TAG_VEC_OBJ, items)

    def vec_del(inst, vec_val, i_val):
        items = list(_vec_of(vec_val))
        i = _vec_index(items, i_val)
        charge(10 + len(items), 8 * len(items))
        del items[i]
        return cv.new_obj(TAG_VEC_OBJ, items)

    def vec_push_front(inst, vec_val, x):
        items = list(_vec_of(vec_val))
        charge(10 + len(items), 8 * (len(items) + 1))
        return cv.new_obj(TAG_VEC_OBJ, [x & _M64] + items)

    def vec_pop_front(inst, vec_val):
        items = list(_vec_of(vec_val))
        if not items:
            raise EnvError("pop from empty vec")
        charge(10 + len(items), 8 * len(items))
        return cv.new_obj(TAG_VEC_OBJ, items[1:])

    def vec_pop_back(inst, vec_val):
        items = list(_vec_of(vec_val))
        if not items:
            raise EnvError("pop from empty vec")
        charge(10 + len(items), 8 * len(items))
        return cv.new_obj(TAG_VEC_OBJ, items[:-1])

    def vec_front(inst, vec_val):
        items = _vec_of(vec_val)
        if not items:
            raise EnvError("front of empty vec")
        return items[0]

    def vec_back(inst, vec_val):
        items = _vec_of(vec_val)
        if not items:
            raise EnvError("back of empty vec")
        return items[-1]

    def vec_insert(inst, vec_val, i_val, x):
        items = list(_vec_of(vec_val))
        i = _vec_index(items, i_val, allow_end=True)
        charge(10 + len(items), 8 * (len(items) + 1))
        items.insert(i, x & _M64)
        return cv.new_obj(TAG_VEC_OBJ, items)

    def vec_append(inst, v1_val, v2_val):
        a, b = list(_vec_of(v1_val)), list(_vec_of(v2_val))
        charge(10 + len(a) + len(b), 8 * (len(a) + len(b)))
        return cv.new_obj(TAG_VEC_OBJ, a + b)

    def vec_slice(inst, vec_val, start_val, end_val):
        items = _vec_of(vec_val)
        start = _u32_arg(start_val, "slice start")
        end = _u32_arg(end_val, "slice end")
        if start > end or end > len(items):
            raise EnvError("vec slice out of range")
        charge(10 + (end - start), 8 * (end - start))
        return cv.new_obj(TAG_VEC_OBJ, list(items[start:end]))

    def vec_first_index_of(inst, vec_val, x):
        for i, item in enumerate(_vec_of(vec_val)):
            if _cmp_vals(item, x) == 0:
                return _make(TAG_U32, i)
        return _make(TAG_VOID)

    def vec_last_index_of(inst, vec_val, x):
        items = _vec_of(vec_val)
        for i in range(len(items) - 1, -1, -1):
            if _cmp_vals(items[i], x) == 0:
                return _make(TAG_U32, i)
        return _make(TAG_VOID)

    def vec_binary_search(inst, vec_val, x):
        """u64 result: (1<<32)|index when found, else the insertion
        point in the low 32 bits (the soroban result convention)."""
        items = _vec_of(vec_val)
        lo, hi = 0, len(items)
        while lo < hi:
            mid = (lo + hi) // 2
            r = _cmp_vals(items[mid], x)
            if r == 0:
                return (1 << 32) | mid
            if r < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def vec_new_from_linear_memory(inst, vals_pos, len_val):
        vp = _u32_arg(vals_pos, "vals pos")
        n = _u32_arg(len_val, "len")
        charge(50 + 10 * n, 8 * n)
        items = [int.from_bytes(inst.mem_read(vp + 8 * i, 8),
                                "little") for i in range(n)]
        return cv.new_obj(TAG_VEC_OBJ, items)

    def vec_unpack_to_linear_memory(inst, vec_val, vals_pos, len_val):
        items = _vec_of(vec_val)
        vp = _u32_arg(vals_pos, "vals pos")
        n = _u32_arg(len_val, "len")
        if n != len(items):
            raise EnvError("vec unpack length mismatch")
        charge(50 + 10 * n, 0)
        for i, item in enumerate(items):
            inst.mem_write(vp + 8 * i, (item & _M64).to_bytes(
                8, "little"))
        return _make(TAG_VOID)

    # ---- map (remaining surface) ----

    def _map_of(val):
        return cv.obj(val, TAG_MAP_OBJ)

    def map_del(inst, map_val, k):
        pairs = list(_map_of(map_val))
        kb = _map_key_bytes(k)
        for i, (pk, _pv) in enumerate(pairs):
            if _map_key_bytes(pk) == kb:
                charge(10 + len(pairs), 16 * len(pairs))
                del pairs[i]
                return cv.new_obj(TAG_MAP_OBJ, pairs)
        raise EnvError("map key not found")

    def map_key_by_pos(inst, map_val, i_val):
        pairs = _map_of(map_val)
        i = _u32_arg(i_val, "map pos")
        if i >= len(pairs):
            raise EnvError("map pos out of bounds")
        return pairs[i][0]

    def map_val_by_pos(inst, map_val, i_val):
        pairs = _map_of(map_val)
        i = _u32_arg(i_val, "map pos")
        if i >= len(pairs):
            raise EnvError("map pos out of bounds")
        return pairs[i][1]

    def map_keys(inst, map_val):
        pairs = _map_of(map_val)
        charge(10 + len(pairs), 8 * len(pairs))
        return cv.new_obj(TAG_VEC_OBJ, [pk for pk, _ in pairs])

    def map_values(inst, map_val):
        pairs = _map_of(map_val)
        charge(10 + len(pairs), 8 * len(pairs))
        return cv.new_obj(TAG_VEC_OBJ, [pv for _, pv in pairs])

    def _key_slices(inst, keys_pos: int, n: int):
        """n (ptr,len) u32-pairs at keys_pos -> symbol byte strings
        (the SDK's struct-field-name slices)."""
        out = []
        for i in range(n):
            pair = inst.mem_read(keys_pos + 8 * i, 8)
            ptr = int.from_bytes(pair[:4], "little")
            ln = int.from_bytes(pair[4:], "little")
            charge(20 + ln, ln)
            out.append(inst.mem_read(ptr, ln))
        return out

    def _sym_val(raw: bytes) -> int:
        if len(raw) <= 9:
            try:
                return sym_to_small(raw)
            except ValueError:
                pass
        return cv.new_obj(TAG_SYMBOL_OBJ, raw)

    def map_new_from_linear_memory(inst, keys_pos, vals_pos, len_val):
        kp = _u32_arg(keys_pos, "keys pos")
        vp = _u32_arg(vals_pos, "vals pos")
        n = _u32_arg(len_val, "len")
        charge(50 + 20 * n, 16 * n)
        import functools
        keys = [_sym_val(raw) for raw in _key_slices(inst, kp, n)]
        vals = [int.from_bytes(inst.mem_read(vp + 8 * i, 8), "little")
                for i in range(n)]
        pairs = sorted(zip(keys, vals), key=functools.cmp_to_key(
            lambda a, b: _cmp_vals(a[0], b[0])))
        for i in range(1, len(pairs)):
            if _map_key_bytes(pairs[i - 1][0]) == \
                    _map_key_bytes(pairs[i][0]):
                raise EnvError("duplicate map key")
        return cv.new_obj(TAG_MAP_OBJ, [list(p) for p in pairs])

    def map_unpack_to_linear_memory(inst, map_val, keys_pos, vals_pos,
                                    len_val):
        pairs = _map_of(map_val)
        kp = _u32_arg(keys_pos, "keys pos")
        vp = _u32_arg(vals_pos, "vals pos")
        n = _u32_arg(len_val, "len")
        if n != len(pairs):
            raise EnvError("map unpack length mismatch")
        charge(50 + 20 * n, 0)
        want = _key_slices(inst, kp, n)
        for i, (pk, pv) in enumerate(pairs):
            if _sym_bytes(pk) != want[i]:
                raise EnvError("map unpack key mismatch")
            inst.mem_write(vp + 8 * i,
                           (pv & _M64).to_bytes(8, "little"))
        return _make(TAG_VOID)

    # ---- buf: serialize + string/symbol + full bytes surface ----

    def serialize_to_bytes(inst, val):
        data = to_bytes(SCVal, cv.to_scval(val))
        charge_ct(CT.ValSer, len(data))
        return cv.new_obj(TAG_BYTES_OBJ, data)

    def deserialize_from_bytes(inst, b_val):
        from stellar_tpu_torch.xdr.runtime import from_bytes as _fb
        data = _bytes_of(b_val)
        charge_ct(CT.ValDeser, len(data))
        try:
            sc = _fb(SCVal, bytes(data))
        except Exception:
            raise EnvError("unparsable SCVal bytes")
        return cv.from_scval(sc)

    def string_copy_to_linear_memory(inst, s_val, s_pos, lm_pos,
                                     len_val):
        data = _str_bytes(s_val)
        sp = _u32_arg(s_pos, "string pos")
        lp = _u32_arg(lm_pos, "lm pos")
        n = _u32_arg(len_val, "len")
        if sp + n > len(data):
            raise EnvError("string copy out of range")
        charge(50 + 2 * n, 0)
        inst.mem_write(lp, data[sp:sp + n])
        return _make(TAG_VOID)

    def symbol_copy_to_linear_memory(inst, s_val, s_pos, lm_pos,
                                     len_val):
        data = _sym_bytes(s_val)
        sp = _u32_arg(s_pos, "symbol pos")
        lp = _u32_arg(lm_pos, "lm pos")
        n = _u32_arg(len_val, "len")
        if sp + n > len(data):
            raise EnvError("symbol copy out of range")
        charge(50 + 2 * n, 0)
        inst.mem_write(lp, data[sp:sp + n])
        return _make(TAG_VOID)

    def string_len(inst, s_val):
        return _make(TAG_U32, len(_str_bytes(s_val)))

    def symbol_len(inst, s_val):
        return _make(TAG_U32, len(_sym_bytes(s_val)))

    def bytes_copy_from_linear_memory(inst, b_val, b_pos, lm_pos,
                                      len_val):
        data = _bytes_of(b_val)
        bp = _u32_arg(b_pos, "bytes pos")
        lp = _u32_arg(lm_pos, "lm pos")
        n = _u32_arg(len_val, "len")
        if bp > len(data):
            raise EnvError("bytes pos out of range")
        charge(50 + 2 * n, n)
        chunk = inst.mem_read(lp, n)
        return cv.new_obj(TAG_BYTES_OBJ,
                          bytes(data[:bp]) + chunk +
                          bytes(data[bp + n:]))

    def bytes_new(inst):
        return cv.new_obj(TAG_BYTES_OBJ, b"")

    def bytes_put(inst, b_val, i_val, u_val):
        data = bytearray(_bytes_of(b_val))
        i = _u32_arg(i_val, "bytes index")
        u = _u32_arg(u_val, "byte value")
        if i >= len(data) or u > 255:
            raise EnvError("bytes put out of range")
        charge(10 + len(data), len(data))
        data[i] = u
        return cv.new_obj(TAG_BYTES_OBJ, bytes(data))

    def bytes_del(inst, b_val, i_val):
        data = bytearray(_bytes_of(b_val))
        i = _u32_arg(i_val, "bytes index")
        if i >= len(data):
            raise EnvError("bytes del out of range")
        charge(10 + len(data), len(data))
        del data[i]
        return cv.new_obj(TAG_BYTES_OBJ, bytes(data))

    def bytes_push(inst, b_val, u_val):
        data = _bytes_of(b_val)
        u = _u32_arg(u_val, "byte value")
        if u > 255:
            raise EnvError("byte value out of range")
        charge(10 + len(data), len(data) + 1)
        return cv.new_obj(TAG_BYTES_OBJ, bytes(data) + bytes([u]))

    def bytes_pop(inst, b_val):
        data = _bytes_of(b_val)
        if not data:
            raise EnvError("pop from empty bytes")
        charge(10 + len(data), len(data))
        return cv.new_obj(TAG_BYTES_OBJ, bytes(data[:-1]))

    def bytes_front(inst, b_val):
        data = _bytes_of(b_val)
        if not data:
            raise EnvError("front of empty bytes")
        return _make(TAG_U32, data[0])

    def bytes_back(inst, b_val):
        data = _bytes_of(b_val)
        if not data:
            raise EnvError("back of empty bytes")
        return _make(TAG_U32, data[-1])

    def bytes_insert(inst, b_val, i_val, u_val):
        data = bytearray(_bytes_of(b_val))
        i = _u32_arg(i_val, "bytes index")
        u = _u32_arg(u_val, "byte value")
        if i > len(data) or u > 255:
            raise EnvError("bytes insert out of range")
        charge(10 + len(data), len(data) + 1)
        data.insert(i, u)
        return cv.new_obj(TAG_BYTES_OBJ, bytes(data))

    def bytes_append(inst, b1_val, b2_val):
        a, b = _bytes_of(b1_val), _bytes_of(b2_val)
        charge(10 + len(a) + len(b), len(a) + len(b))
        return cv.new_obj(TAG_BYTES_OBJ, bytes(a) + bytes(b))

    def bytes_slice(inst, b_val, start_val, end_val):
        data = _bytes_of(b_val)
        start = _u32_arg(start_val, "slice start")
        end = _u32_arg(end_val, "slice end")
        if start > end or end > len(data):
            raise EnvError("bytes slice out of range")
        charge(10 + (end - start), end - start)
        return cv.new_obj(TAG_BYTES_OBJ, bytes(data[start:end]))

    def symbol_index_in_linear_memory(inst, sym_val, slices_pos,
                                      len_val):
        target = _sym_bytes(sym_val)
        sp = _u32_arg(slices_pos, "slices pos")
        n = _u32_arg(len_val, "len")
        for i, raw in enumerate(_key_slices(inst, sp, n)):
            if raw == target:
                return _make(TAG_U32, i)
        raise EnvError("symbol not found in linear memory slices")

    # ---- crypto ----

    def verify_sig_ed25519(inst, pk_val, payload_val, sig_val):
        pk = _bytes_of(pk_val)
        payload = _bytes_of(payload_val)
        sig = _bytes_of(sig_val)
        if len(pk) != 32 or len(sig) != 64:
            raise EnvError("bad ed25519 key/signature length")
        charge_ct(CT.VerifyEd25519Sig, len(payload))
        from stellar_tpu_torch.crypto.keys import PublicKey, verify_sig
        if not verify_sig(PublicKey(bytes(pk)), bytes(payload),
                          bytes(sig)):
            raise EnvError("ed25519 signature verification failed")
        return _make(TAG_VOID)

    def compute_hash_keccak256(inst, b_val):
        data = _bytes_of(b_val)
        charge_ct(CT.ComputeKeccak256Hash, len(data))
        from stellar_tpu_torch.crypto.keccak import keccak256
        return cv.new_obj(TAG_BYTES_OBJ, keccak256(bytes(data)))

    def recover_key_ecdsa_secp256k1(inst, digest_val, sig_val,
                                    rid_val):
        digest = _bytes_of(digest_val)
        sig = _bytes_of(sig_val)
        rid = _u32_arg(rid_val, "recovery id")
        charge_ct(CT.DecodeEcdsaCurve256Sig)
        charge_ct(CT.RecoverEcdsaSecp256k1Key)
        from stellar_tpu_torch.crypto.secp256 import (
            EcdsaError, recover_secp256k1,
        )
        try:
            pk = recover_secp256k1(bytes(digest), bytes(sig), rid)
        except EcdsaError as e:
            raise EnvError(f"secp256k1 recover: {e}")
        return cv.new_obj(TAG_BYTES_OBJ, pk)

    # ---- BLS12-381 (protocol 22, CAP-59) ----

    def _bls():
        from stellar_tpu_torch.crypto import bls12_381 as B
        return B

    def _g1_arg(val, check_subgroup=True):
        B = _bls()
        try:
            return B.g1_decode(bytes(_bytes_of(val)),
                               subgroup_check=check_subgroup)
        except B.BlsError as e:
            raise EnvError(f"bls12-381 g1: {e}")

    def _g2_arg(val, check_subgroup=True):
        B = _bls()
        try:
            return B.g2_decode(bytes(_bytes_of(val)),
                               subgroup_check=check_subgroup)
        except B.BlsError as e:
            raise EnvError(f"bls12-381 g2: {e}")

    def _fr_arg(val) -> int:
        return _u256_of(val) % _bls().R

    def bls12_381_check_g1_is_in_subgroup(inst, p_val):
        charge_ct(CT.Bls12381DecodeFp, iterations=2)
        charge_ct(CT.Bls12381G1CheckPointOnCurve)
        charge_ct(CT.Bls12381G1CheckPointInSubgroup)
        B = _bls()
        pt = _g1_arg(p_val, check_subgroup=False)
        try:
            B.g1_check(pt)
            return _make(TAG_TRUE)
        except B.BlsError:
            return _make(TAG_FALSE)

    def bls12_381_g1_add(inst, a_val, b_val):
        # add validates on-curve only (CAP-59: no subgroup check here)
        charge_ct(CT.Bls12381G1Add)
        charge_ct(CT.Bls12381EncodeFp, iterations=2)
        B = _bls()
        return cv.new_obj(TAG_BYTES_OBJ, B.g1_encode(B.g1_add(
            _g1_arg(a_val, check_subgroup=False),
            _g1_arg(b_val, check_subgroup=False))))

    def bls12_381_g1_mul(inst, p_val, k_val):
        charge_ct(CT.Bls12381G1Mul)
        charge_ct(CT.Bls12381EncodeFp, iterations=2)
        B = _bls()
        return cv.new_obj(TAG_BYTES_OBJ, B.g1_encode(
            B.g1_mul(_fr_arg(k_val), _g1_arg(p_val))))

    def bls12_381_g1_msm(inst, points_val, scalars_val):
        B = _bls()
        pts = [_g1_arg(v) for v in _vec_of(points_val)]
        ks = [_fr_arg(v) for v in _vec_of(scalars_val)]
        if len(pts) != len(ks):
            raise EnvError("bls12-381 msm length mismatch")
        charge_ct(CT.Bls12381G1Msm, len(pts))
        return cv.new_obj(TAG_BYTES_OBJ,
                          B.g1_encode(B.g1_msm(list(zip(ks, pts)))))

    def _h2c():
        from stellar_tpu_torch.crypto import h2c
        return h2c

    def bls12_381_map_fp_to_g1(inst, fp_val):
        # RFC 9380 map_to_curve: SSWU + 11-isogeny, NO cofactor
        # clearing (reference host WBMap semantics — the result is
        # on-curve but generally outside the r-subgroup); constants
        # derived and verified by tools/derive_h2c.py (reproduces the
        # RFC's own curve parameters and Z = 11)
        charge_ct(CT.Bls12381MapFpToG1)
        raw = bytes(_bytes_of(fp_val))
        if len(raw) != 48:
            raise EnvError("fp encoding must be 48 bytes")
        u = int.from_bytes(raw, "big")
        if u >= _bls().P:
            raise EnvError("fp value out of range")
        return cv.new_obj(TAG_BYTES_OBJ,
                          _bls().g1_encode(_h2c().map_fp_to_g1(u)))

    def bls12_381_hash_to_g1(inst, msg_val, dst_val):
        msg = bytes(_bytes_of(msg_val))
        charge_ct(CT.Bls12381HashToG1, len(msg))
        dst = bytes(_bytes_of(dst_val))
        if not dst or len(dst) > 255:
            raise EnvError("dst must be 1..255 bytes")
        return cv.new_obj(TAG_BYTES_OBJ,
                          _bls().g1_encode(_h2c().hash_to_g1(msg, dst)))

    def bls12_381_check_g2_is_in_subgroup(inst, p_val):
        charge_ct(CT.Bls12381DecodeFp, iterations=4)
        charge_ct(CT.Bls12381G2CheckPointOnCurve)
        charge_ct(CT.Bls12381G2CheckPointInSubgroup)
        B = _bls()
        pt = _g2_arg(p_val, check_subgroup=False)
        try:
            B.g2_check(pt)
            return _make(TAG_TRUE)
        except B.BlsError:
            return _make(TAG_FALSE)

    def bls12_381_g2_add(inst, a_val, b_val):
        charge_ct(CT.Bls12381G2Add)
        charge_ct(CT.Bls12381EncodeFp, iterations=4)
        B = _bls()
        return cv.new_obj(TAG_BYTES_OBJ, B.g2_encode(B.g2_add(
            _g2_arg(a_val, check_subgroup=False),
            _g2_arg(b_val, check_subgroup=False))))

    def bls12_381_g2_mul(inst, p_val, k_val):
        charge_ct(CT.Bls12381G2Mul)
        charge_ct(CT.Bls12381EncodeFp, iterations=4)
        B = _bls()
        return cv.new_obj(TAG_BYTES_OBJ, B.g2_encode(
            B.g2_mul(_fr_arg(k_val), _g2_arg(p_val))))

    def bls12_381_g2_msm(inst, points_val, scalars_val):
        B = _bls()
        pts = [_g2_arg(v) for v in _vec_of(points_val)]
        ks = [_fr_arg(v) for v in _vec_of(scalars_val)]
        if len(pts) != len(ks):
            raise EnvError("bls12-381 msm length mismatch")
        charge_ct(CT.Bls12381G2Msm, len(pts))
        return cv.new_obj(TAG_BYTES_OBJ,
                          B.g2_encode(B.g2_msm(list(zip(ks, pts)))))

    def bls12_381_map_fp2_to_g2(inst, fp2_val):
        # same wire convention as the g2 point codec: c1 || c0
        charge_ct(CT.Bls12381MapFp2ToG2)
        raw = bytes(_bytes_of(fp2_val))
        if len(raw) != 96:
            raise EnvError("fp2 encoding must be 96 bytes")
        c1 = int.from_bytes(raw[:48], "big")
        c0 = int.from_bytes(raw[48:], "big")
        if c0 >= _bls().P or c1 >= _bls().P:
            raise EnvError("fp2 value out of range")
        return cv.new_obj(TAG_BYTES_OBJ,
                          _bls().g2_encode(_h2c().map_fp2_to_g2((c0, c1))))

    def bls12_381_hash_to_g2(inst, msg_val, dst_val):
        msg = bytes(_bytes_of(msg_val))
        charge_ct(CT.Bls12381HashToG2, len(msg))
        dst = bytes(_bytes_of(dst_val))
        if not dst or len(dst) > 255:
            raise EnvError("dst must be 1..255 bytes")
        return cv.new_obj(TAG_BYTES_OBJ,
                          _bls().g2_encode(_h2c().hash_to_g2(msg, dst)))

    def bls12_381_multi_pairing_check(inst, vp1_val, vp2_val):
        B = _bls()
        ps = [_g1_arg(v) for v in _vec_of(vp1_val)]
        qs = [_g2_arg(v) for v in _vec_of(vp2_val)]
        if len(ps) != len(qs) or not ps:
            raise EnvError("bls12-381 pairing vector mismatch")
        charge_ct(CT.Bls12381Pairing, len(ps))
        ok = B.pairing_check(list(zip(ps, qs)))
        return _make(TAG_TRUE if ok else TAG_FALSE)

    def _fr_result(n: int):
        return _mk_u256(n % _bls().R)

    def bls12_381_fr_add(inst, a_val, b_val):
        charge_ct(CT.Bls12381FrAddSub)
        return _fr_result(_bls().fr_add(_fr_arg(a_val), _fr_arg(b_val)))

    def bls12_381_fr_sub(inst, a_val, b_val):
        charge_ct(CT.Bls12381FrAddSub)
        return _fr_result(_bls().fr_sub(_fr_arg(a_val), _fr_arg(b_val)))

    def bls12_381_fr_mul(inst, a_val, b_val):
        charge_ct(CT.Bls12381FrMul)
        return _fr_result(_bls().fr_mul(_fr_arg(a_val), _fr_arg(b_val)))

    def bls12_381_fr_pow(inst, a_val, e_val):
        charge_ct(CT.Bls12381FrPow, 64)  # input: exponent bit-width
        # the exponent is a tagged U64Val, not a raw wasm u64
        e_sc = cv.to_scval(e_val)
        if e_sc.arm != T.SCV_U64:
            raise EnvError("fr_pow exponent must be a u64")
        return _fr_result(_bls().fr_pow(_fr_arg(a_val), e_sc.value))

    def bls12_381_fr_inv(inst, a_val):
        charge_ct(CT.Bls12381FrInv)
        B = _bls()
        try:
            return _fr_result(B.fr_inv(_fr_arg(a_val)))
        except B.BlsError as e:
            raise EnvError(f"bls12-381 fr: {e}")

    def verify_sig_ecdsa_secp256r1(inst, pk_val, digest_val, sig_val):
        pk = _bytes_of(pk_val)
        digest = _bytes_of(digest_val)
        sig = _bytes_of(sig_val)
        charge_ct(CT.Sec1DecodePointUncompressed)
        charge_ct(CT.DecodeEcdsaCurve256Sig)
        charge_ct(CT.VerifyEcdsaSecp256r1Sig)
        from stellar_tpu_torch.crypto.secp256 import (
            SECP256R1, EcdsaError, verify_ecdsa,
        )
        try:
            ok = verify_ecdsa(SECP256R1, bytes(pk), bytes(digest),
                              bytes(sig))
        except EcdsaError as e:
            raise EnvError(f"secp256r1 verify: {e}")
        if not ok:
            raise EnvError("secp256r1 signature verification failed")
        return _make(TAG_VOID)

    # ---- ledger (create/upload/id-derivation surface) ----

    def _addr_of(val):
        return cv.obj(val, TAG_ADDRESS_OBJ)

    def _from_address_preimage(deployer, salt: bytes):
        from stellar_tpu_torch.xdr.contract import (
            ContractIDPreimage, ContractIDPreimageFromAddress,
            ContractIDPreimageType,
        )
        return ContractIDPreimage.make(
            ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS,
            ContractIDPreimageFromAddress(address=deployer,
                                          salt=salt))

    def create_contract(inst, deployer_val, wasm_hash_val, salt_val):
        from stellar_tpu_torch.soroban.host import _address_bytes, _create
        from stellar_tpu_torch.xdr.contract import (
            ContractExecutable, ContractExecutableType,
            CreateContractArgs, SorobanAuthorizedFunction,
            SorobanAuthorizedFunctionType,
        )
        deployer = _addr_of(deployer_val)
        wasm_hash = bytes(_bytes_of(wasm_hash_val))
        salt = bytes(_bytes_of(salt_val))
        if len(wasm_hash) != 32 or len(salt) != 32:
            raise EnvError("wasm hash and salt must be 32 bytes")
        cc = CreateContractArgs(
            contractIDPreimage=_from_address_preimage(deployer, salt),
            executable=ContractExecutable.make(
                ContractExecutableType.CONTRACT_EXECUTABLE_WASM,
                wasm_hash))
        # a deployer other than the running contract must authorize
        if _address_bytes(deployer) != \
                _address_bytes(env.contract_addr):
            inv = SorobanAuthorizedFunction.make(
                SorobanAuthorizedFunctionType
                .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN,
                cc)
            env.host.require_auth(
                SCVal.make(T.SCV_ADDRESS, deployer), inv, env.depth)
        rv = _create(env.host, cc, env.host.network_id)
        return cv.from_scval(rv)

    def create_asset_contract(inst, asset_val):
        from stellar_tpu_torch.soroban.host import _create
        from stellar_tpu_torch.xdr.contract import (
            ContractExecutable, ContractExecutableType,
            ContractIDPreimage, ContractIDPreimageType,
            CreateContractArgs,
        )
        from stellar_tpu_torch.xdr.runtime import from_bytes as _fb
        from stellar_tpu_torch.xdr.types import Asset
        try:
            asset = _fb(Asset, bytes(_bytes_of(asset_val)))
        except Exception:
            raise EnvError("unparsable Asset XDR")
        cc = CreateContractArgs(
            contractIDPreimage=ContractIDPreimage.make(
                ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET,
                asset),
            executable=ContractExecutable.make(
                ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET))
        rv = _create(env.host, cc, env.host.network_id)
        return cv.from_scval(rv)

    def get_contract_id(inst, deployer_val, salt_val):
        from stellar_tpu_torch.soroban.host import derive_contract_id
        from stellar_tpu_torch.xdr.contract import contract_address
        deployer = _addr_of(deployer_val)
        salt = bytes(_bytes_of(salt_val))
        if len(salt) != 32:
            raise EnvError("salt must be 32 bytes")
        charge(500, 32)
        cid = derive_contract_id(
            env.host.network_id,
            _from_address_preimage(deployer, salt))
        return cv.new_obj(TAG_ADDRESS_OBJ, contract_address(cid))

    def get_asset_contract_id(inst, asset_val):
        from stellar_tpu_torch.soroban.host import derive_contract_id
        from stellar_tpu_torch.xdr.contract import (
            ContractIDPreimage, ContractIDPreimageType,
            contract_address,
        )
        from stellar_tpu_torch.xdr.runtime import from_bytes as _fb
        from stellar_tpu_torch.xdr.types import Asset
        try:
            asset = _fb(Asset, bytes(_bytes_of(asset_val)))
        except Exception:
            raise EnvError("unparsable Asset XDR")
        charge(500, 32)
        cid = derive_contract_id(
            env.host.network_id,
            ContractIDPreimage.make(
                ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET,
                asset))
        return cv.new_obj(TAG_ADDRESS_OBJ, contract_address(cid))

    def upload_wasm(inst, b_val):
        from stellar_tpu_torch.soroban.host import _upload
        rv = _upload(env.host, bytes(_bytes_of(b_val)),
                     env.host.storage.read_write)
        return cv.from_scval(rv)

    def update_current_contract_wasm(inst, hash_val):
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.soroban.host import (
            _wrap_entry, contract_code_key, contract_data_key,
        )
        from stellar_tpu_torch.xdr.contract import (
            ContractDataDurability, ContractDataEntry,
            ContractExecutable, ContractExecutableType,
            SCContractInstance,
        )
        from stellar_tpu_torch.xdr.types import (
            ExtensionPoint, LedgerEntryType,
        )
        new_hash = bytes(_bytes_of(hash_val))
        if len(new_hash) != 32:
            raise EnvError("wasm hash must be 32 bytes")
        if env.host.storage.get(
                key_bytes(contract_code_key(new_hash))) is None:
            raise EnvError("new wasm not uploaded")
        key = SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE)
        lk = contract_data_key(env.contract_addr, key,
                               ContractDataDurability.PERSISTENT)
        kb = key_bytes(lk)
        entry = env.host.storage.get(kb)
        if entry is None:
            raise EnvError("missing instance entry")
        inst_v = entry.data.value.val.value
        new_inst = ContractDataEntry(
            ext=ExtensionPoint.make(0), contract=env.contract_addr,
            key=key, durability=ContractDataDurability.PERSISTENT,
            val=SCVal.make(T.SCV_CONTRACT_INSTANCE, SCContractInstance(
                executable=ContractExecutable.make(
                    ContractExecutableType.CONTRACT_EXECUTABLE_WASM,
                    new_hash),
                storage=inst_v.storage)))
        env.host.storage.put(kb, _wrap_entry(
            LedgerEntryType.CONTRACT_DATA, new_inst,
            env.host.ledger_seq), None)
        return _make(TAG_VOID)

    def extend_contract_instance_and_code_ttl(inst, addr_val,
                                              thresh_val, ext_val):
        """Like extend_current_contract_instance_and_code_ttl but for
        an arbitrary contract address."""
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.soroban.host import (
            contract_code_key, contract_data_key,
        )
        from stellar_tpu_torch.xdr.contract import (
            ContractDataDurability, ContractExecutableType,
        )
        target = _addr_of(addr_val)
        thresh = _u32_arg(thresh_val, "threshold")
        ext = _u32_arg(ext_val, "extend_to")
        inst_kb = key_bytes(contract_data_key(
            target, SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE),
            ContractDataDurability.PERSISTENT))
        env.host.extend_ttl(inst_kb, thresh, ext)
        slot = env.host.storage.entries.get(inst_kb)
        if slot is not None and slot[0] is not None:
            instance = slot[0].data.value.val.value
            if instance.executable.arm == \
                    ContractExecutableType.CONTRACT_EXECUTABLE_WASM:
                env.host.extend_ttl(
                    key_bytes(contract_code_key(
                        instance.executable.value)), thresh, ext)
        return _make(TAG_VOID)

    # ---- call: try_call with frame rollback ----

    def try_call(inst, addr_val, fn_val, args_val):
        from stellar_tpu_torch.soroban.host import HostError
        from stellar_tpu_torch.xdr.contract import SCError, SCErrorCode
        addr_sc = cv.to_scval(addr_val)
        fn_sc = cv.to_scval(fn_val)
        args_sc = cv.to_scval(args_val)
        if addr_sc.arm != T.SCV_ADDRESS or fn_sc.arm != T.SCV_SYMBOL \
                or args_sc.arm != T.SCV_VEC:
            raise EnvError("try_call needs (address, symbol, vec)")
        snap = env.host.snapshot()
        try:
            rv = env.host.call_contract(addr_sc.value, fn_sc.value,
                                        list(args_sc.value or ()),
                                        env.depth + 1)
        except HostError as e:
            if e.kind == HostError.BUDGET:
                raise  # metering exhaustion is never catchable
            env.host.restore(snap)
            if e.error_sc is not None:
                # hand the CALLEE'S fail_with_error val to the caller
                return cv.from_scval(e.error_sc)
            from stellar_tpu_torch.xdr.contract import SCErrorType
            return cv.from_scval(SCVal.make(T.SCV_ERROR, SCError.make(
                SCErrorType.SCE_CONTEXT,
                SCErrorCode.SCEC_INVALID_ACTION)))
        return cv.from_scval(rv)

    # ---- address ----

    def require_auth_for_args(inst, addr_val, args_val):
        from stellar_tpu_torch.xdr.contract import (
            InvokeContractArgs, SorobanAuthorizedFunction,
            SorobanAuthorizedFunctionType,
        )
        addr = _addr_of(addr_val)
        args_sc = cv.to_scval(args_val)
        if args_sc.arm != T.SCV_VEC:
            raise EnvError("require_auth_for_args needs a vec")
        if env.invocation is None or env.invocation.arm != \
                SorobanAuthorizedFunctionType \
                .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN:
            raise EnvError("no contract invocation context")
        cur = env.invocation.value
        inv = SorobanAuthorizedFunction.make(
            SorobanAuthorizedFunctionType
            .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
            InvokeContractArgs(contractAddress=cur.contractAddress,
                               functionName=cur.functionName,
                               args=list(args_sc.value or ())))
        env.host.require_auth(SCVal.make(T.SCV_ADDRESS, addr), inv,
                              env.depth)
        return _make(TAG_VOID)

    def strkey_to_address(inst, key_val):
        from stellar_tpu_torch.crypto import strkey as sk
        from stellar_tpu_torch.xdr.contract import (
            SCAddressType, contract_address,
        )
        from stellar_tpu_torch.xdr.types import account_id
        tag = _tag(key_val)
        if tag == TAG_BYTES_OBJ:
            raw = bytes(_bytes_of(key_val))
        elif tag == TAG_STRING_OBJ:
            raw = bytes(_str_bytes(key_val))
        else:
            raise EnvError("strkey must be bytes or string")
        charge(200, 0)
        try:
            s = raw.decode("ascii")
        except UnicodeDecodeError:
            raise EnvError("strkey must be ascii")
        try:
            if s.startswith("G"):
                addr = SCAddress.make(
                    SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                    account_id(sk.decode_account(s)))
            elif s.startswith("C"):
                addr = contract_address(sk.decode_contract(s))
            else:
                raise EnvError("unsupported strkey kind")
        except sk.StrKeyError as e:
            raise EnvError(f"bad strkey: {e}")
        return cv.new_obj(TAG_ADDRESS_OBJ, addr)

    def address_to_strkey(inst, addr_val):
        from stellar_tpu_torch.crypto import strkey as sk
        from stellar_tpu_torch.xdr.contract import SCAddressType
        from stellar_tpu_torch.xdr.types import account_ed25519
        addr = _addr_of(addr_val)
        charge(200, 64)
        if addr.arm == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            s = sk.encode_account(account_ed25519(addr.value))
        else:
            s = sk.encode_contract(addr.value)
        return cv.new_obj(TAG_STRING_OBJ, s.encode("ascii"))

    def authorize_as_curr_contract(inst, auth_vec_val):
        """Register sub-invocation authorizations by the RUNNING
        contract (reference authorize_as_curr_contract). Entry shape
        accepted here: vec [address, fn-symbol, args-vec] per entry —
        the flattened invocation list (the reference takes the
        recursive InvokerContractAuthEntry tree; this registry keys
        on the same (contract, fn, args) identity require_auth
        matches on)."""
        from stellar_tpu_torch.soroban.host import _address_bytes
        from stellar_tpu_torch.xdr.contract import (
            InvokeContractArgs, SorobanAuthorizedFunction,
            SorobanAuthorizedFunctionType,
        )
        entries_sc = cv.to_scval(auth_vec_val)
        if entries_sc.arm != T.SCV_VEC:
            raise EnvError("authorize_as_curr_contract needs a vec")
        my_ab = _address_bytes(env.contract_addr)
        for entry in (entries_sc.value or ()):
            if entry.arm != T.SCV_VEC or len(entry.value or ()) != 3:
                raise EnvError("auth entry must be "
                               "[address, symbol, args]")
            addr_sc, fn_sc, args_sc = entry.value
            if addr_sc.arm != T.SCV_ADDRESS or \
                    fn_sc.arm != T.SCV_SYMBOL or \
                    args_sc.arm != T.SCV_VEC:
                raise EnvError("auth entry must be "
                               "[address, symbol, args]")
            inv = SorobanAuthorizedFunction.make(
                SorobanAuthorizedFunctionType
                .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
                InvokeContractArgs(contractAddress=addr_sc.value,
                                   functionName=fn_sc.value,
                                   args=list(args_sc.value or ())))
            charge(100, 64)
            env.host.contract_auths.setdefault(my_ab, []).append(
                (len(env.host.frame_addrs),
                 to_bytes(SorobanAuthorizedFunction, inv)))
        return _make(TAG_VOID)

    # ---- test ----

    def dummy0(inst):
        return _make(TAG_VOID)

    def protocol_gated_dummy(inst):
        # era availability comes from the central MIN_PROTOCOL gate
        return _make(TAG_VOID)

    # =====================================================================
    # the import table: every canonical handler registers under BOTH
    # its (module, single-char export) name — what genuine SDK
    # contracts import (see env_interface.py) — and (module, long
    # name); the historical aliases this repo's earlier builder
    # contracts imported stay bound to the same closures.
    # =====================================================================

    canonical = {
        # context "x"
        "log_from_linear_memory": ("x", log_from_linear_memory),
        "obj_cmp": ("x", obj_cmp),
        "contract_event": ("x", contract_event),
        "get_ledger_version": ("x", get_ledger_version),
        "get_ledger_sequence": ("x", ledger_sequence),
        "get_ledger_timestamp": ("x", ledger_timestamp),
        "fail_with_error": ("x", fail_with_error),
        "get_ledger_network_id": ("x", get_ledger_network_id),
        "get_current_contract_address":
            ("x", current_contract_address),
        "get_max_live_until_ledger": ("x", get_max_live_until_ledger),
        # int "i"
        "obj_from_u64": ("i", obj_from_u64),
        "obj_to_u64": ("i", obj_to_u64),
        "obj_from_i64": ("i", obj_from_i64),
        "obj_to_i64": ("i", obj_to_i64),
        "obj_from_u128_pieces": ("i", obj_from_u128_pieces),
        "obj_to_u128_lo64": ("i", obj_to_u128_lo64),
        "obj_to_u128_hi64": ("i", obj_to_u128_hi64),
        "obj_from_i128_pieces": ("i", obj_from_i128_pieces),
        "obj_to_i128_lo64": ("i", obj_to_i128_lo64),
        "obj_to_i128_hi64": ("i", obj_to_i128_hi64),
        "obj_from_u256_pieces": ("i", obj_from_u256_pieces),
        "u256_val_from_be_bytes": ("i", u256_val_from_be_bytes),
        "u256_val_to_be_bytes": ("i", u256_val_to_be_bytes),
        "obj_to_u256_hi_hi": ("i", obj_to_u256_hi_hi),
        "obj_to_u256_hi_lo": ("i", obj_to_u256_hi_lo),
        "obj_to_u256_lo_hi": ("i", obj_to_u256_lo_hi),
        "obj_to_u256_lo_lo": ("i", obj_to_u256_lo_lo),
        "obj_from_i256_pieces": ("i", obj_from_i256_pieces),
        "i256_val_from_be_bytes": ("i", i256_val_from_be_bytes),
        "i256_val_to_be_bytes": ("i", i256_val_to_be_bytes),
        "obj_to_i256_hi_hi": ("i", obj_to_i256_hi_hi),
        "obj_to_i256_hi_lo": ("i", obj_to_i256_hi_lo),
        "obj_to_i256_lo_hi": ("i", obj_to_i256_lo_hi),
        "obj_to_i256_lo_lo": ("i", obj_to_i256_lo_lo),
        "u256_add": ("i", u256_add),
        "u256_sub": ("i", u256_sub),
        "u256_mul": ("i", u256_mul),
        "u256_div": ("i", u256_div),
        "u256_rem_euclid": ("i", u256_rem_euclid),
        "u256_pow": ("i", u256_pow),
        "u256_shl": ("i", u256_shl),
        "u256_shr": ("i", u256_shr),
        "i256_add": ("i", i256_add),
        "i256_sub": ("i", i256_sub),
        "i256_mul": ("i", i256_mul),
        "i256_div": ("i", i256_div),
        "i256_rem_euclid": ("i", i256_rem_euclid),
        "i256_pow": ("i", i256_pow),
        "i256_shl": ("i", i256_shl),
        "i256_shr": ("i", i256_shr),
        "timepoint_obj_from_u64": ("i", timepoint_obj_from_u64),
        "timepoint_obj_to_u64": ("i", timepoint_obj_to_u64),
        "duration_obj_from_u64": ("i", duration_obj_from_u64),
        "duration_obj_to_u64": ("i", duration_obj_to_u64),
        # map "m"
        "map_new": ("m", map_new),
        "map_put": ("m", map_put),
        "map_get": ("m", map_get),
        "map_del": ("m", map_del),
        "map_len": ("m", map_len),
        "map_has": ("m", map_has),
        "map_key_by_pos": ("m", map_key_by_pos),
        "map_val_by_pos": ("m", map_val_by_pos),
        "map_keys": ("m", map_keys),
        "map_values": ("m", map_values),
        "map_new_from_linear_memory":
            ("m", map_new_from_linear_memory),
        "map_unpack_to_linear_memory":
            ("m", map_unpack_to_linear_memory),
        # vec "v"
        "vec_new": ("v", vec_new),
        "vec_put": ("v", vec_put),
        "vec_get": ("v", vec_get),
        "vec_del": ("v", vec_del),
        "vec_len": ("v", vec_len),
        "vec_push_front": ("v", vec_push_front),
        "vec_pop_front": ("v", vec_pop_front),
        "vec_push_back": ("v", vec_push_back),
        "vec_pop_back": ("v", vec_pop_back),
        "vec_front": ("v", vec_front),
        "vec_back": ("v", vec_back),
        "vec_insert": ("v", vec_insert),
        "vec_append": ("v", vec_append),
        "vec_slice": ("v", vec_slice),
        "vec_first_index_of": ("v", vec_first_index_of),
        "vec_last_index_of": ("v", vec_last_index_of),
        "vec_binary_search": ("v", vec_binary_search),
        "vec_new_from_linear_memory":
            ("v", vec_new_from_linear_memory),
        "vec_unpack_to_linear_memory":
            ("v", vec_unpack_to_linear_memory),
        # ledger "l"
        "put_contract_data": ("l", put_contract_data),
        "has_contract_data": ("l", has_contract_data),
        "get_contract_data": ("l", get_contract_data),
        "del_contract_data": ("l", del_contract_data),
        "extend_contract_data_ttl": ("l", extend_contract_data_ttl),
        "extend_current_contract_instance_and_code_ttl":
            ("l", extend_instance_and_code_ttl),
        "extend_contract_instance_and_code_ttl":
            ("l", extend_contract_instance_and_code_ttl),
        "create_contract": ("l", create_contract),
        "create_asset_contract": ("l", create_asset_contract),
        "get_asset_contract_id": ("l", get_asset_contract_id),
        "upload_wasm": ("l", upload_wasm),
        "update_current_contract_wasm":
            ("l", update_current_contract_wasm),
        "get_contract_id": ("l", get_contract_id),
        # call "d"
        "call": ("d", call),
        "try_call": ("d", try_call),
        # buf "b"
        "serialize_to_bytes": ("b", serialize_to_bytes),
        "deserialize_from_bytes": ("b", deserialize_from_bytes),
        "string_copy_to_linear_memory":
            ("b", string_copy_to_linear_memory),
        "symbol_copy_to_linear_memory":
            ("b", symbol_copy_to_linear_memory),
        "string_new_from_linear_memory":
            ("b", string_new_from_linear_memory),
        "symbol_new_from_linear_memory":
            ("b", symbol_new_from_linear_memory),
        "string_len": ("b", string_len),
        "symbol_len": ("b", symbol_len),
        "bytes_copy_to_linear_memory":
            ("b", bytes_copy_to_linear_memory),
        "bytes_copy_from_linear_memory":
            ("b", bytes_copy_from_linear_memory),
        "bytes_new_from_linear_memory":
            ("b", bytes_new_from_linear_memory),
        "bytes_new": ("b", bytes_new),
        "bytes_put": ("b", bytes_put),
        "bytes_get": ("b", bytes_get),
        "bytes_del": ("b", bytes_del),
        "bytes_len": ("b", bytes_len),
        "bytes_push": ("b", bytes_push),
        "bytes_pop": ("b", bytes_pop),
        "bytes_front": ("b", bytes_front),
        "bytes_back": ("b", bytes_back),
        "bytes_insert": ("b", bytes_insert),
        "bytes_append": ("b", bytes_append),
        "bytes_slice": ("b", bytes_slice),
        "symbol_index_in_linear_memory":
            ("b", symbol_index_in_linear_memory),
        # crypto "c"
        "compute_hash_sha256": ("c", compute_sha256),
        "verify_sig_ed25519": ("c", verify_sig_ed25519),
        "compute_hash_keccak256": ("c", compute_hash_keccak256),
        "recover_key_ecdsa_secp256k1":
            ("c", recover_key_ecdsa_secp256k1),
        "verify_sig_ecdsa_secp256r1":
            ("c", verify_sig_ecdsa_secp256r1),
        "bls12_381_check_g1_is_in_subgroup":
            ("c", bls12_381_check_g1_is_in_subgroup),
        "bls12_381_g1_add": ("c", bls12_381_g1_add),
        "bls12_381_g1_mul": ("c", bls12_381_g1_mul),
        "bls12_381_g1_msm": ("c", bls12_381_g1_msm),
        "bls12_381_map_fp_to_g1": ("c", bls12_381_map_fp_to_g1),
        "bls12_381_hash_to_g1": ("c", bls12_381_hash_to_g1),
        "bls12_381_check_g2_is_in_subgroup":
            ("c", bls12_381_check_g2_is_in_subgroup),
        "bls12_381_g2_add": ("c", bls12_381_g2_add),
        "bls12_381_g2_mul": ("c", bls12_381_g2_mul),
        "bls12_381_g2_msm": ("c", bls12_381_g2_msm),
        "bls12_381_map_fp2_to_g2": ("c", bls12_381_map_fp2_to_g2),
        "bls12_381_hash_to_g2": ("c", bls12_381_hash_to_g2),
        "bls12_381_multi_pairing_check":
            ("c", bls12_381_multi_pairing_check),
        "bls12_381_fr_add": ("c", bls12_381_fr_add),
        "bls12_381_fr_sub": ("c", bls12_381_fr_sub),
        "bls12_381_fr_mul": ("c", bls12_381_fr_mul),
        "bls12_381_fr_pow": ("c", bls12_381_fr_pow),
        "bls12_381_fr_inv": ("c", bls12_381_fr_inv),
        # address "a"
        "require_auth_for_args": ("a", require_auth_for_args),
        "require_auth": ("a", require_auth),
        "strkey_to_address": ("a", strkey_to_address),
        "address_to_strkey": ("a", address_to_strkey),
        "authorize_as_curr_contract":
            ("a", authorize_as_curr_contract),
        # test "t"
        "dummy0": ("t", dummy0),
        "protocol_gated_dummy": ("t", protocol_gated_dummy),
        # prng "p"
        "prng_reseed": ("p", prng_reseed),
        "prng_bytes_new": ("p", prng_bytes_new),
        "prng_u64_in_inclusive_range":
            ("p", prng_u64_in_inclusive_range),
        "prng_vec_shuffle": ("p", prng_vec_shuffle),
    }

    # protocol-era gating (reference pins one soroban-env-host crate
    # per protocol, src/rust/Cargo.toml:51-80, so a p21-era replay
    # cannot see p22 functions). Two layers, because the import table
    # is pooled across frames and the frame's protocol can differ per
    # tx: (1) LINK time — check_import_binding reads __min_protocol__ /
    # __frame_version__ and refuses the import like the reference's
    # per-era host would (import-but-never-call still fails); (2) CALL
    # time — defense in depth for direct handler invocation.
    from stellar_tpu_torch.soroban.env_interface import MIN_PROTOCOL
    from stellar_tpu_torch.soroban.wasm import handler_arity as _harity

    def _version_gated(long_name, min_proto, fn):
        def gated(inst, *args):
            version = _frame_version()
            if version < min_proto:
                raise EnvError(
                    f"{long_name} requires protocol {min_proto}; "
                    f"ledger is protocol {version}")
            return fn(inst, *args)
        gated.__env_arity__ = _harity(fn)  # keep link-check visibility
        gated.__min_protocol__ = min_proto
        gated.__frame_version__ = _frame_version
        gated.__name__ = f"{long_name}_p{min_proto}_gate"
        return gated

    table: Dict[Tuple[str, str], Callable] = {}
    shorts = _SHORTS()
    for long_name, (mod, fn) in canonical.items():
        smod, schar = shorts[long_name]
        # a handler filed under a different module than the registry
        # would otherwise register its short name under the wrong key
        # and fail only at contract link time
        assert smod == mod, f"module mismatch for {long_name}"
        min_proto = MIN_PROTOCOL.get(long_name)
        if min_proto is not None:
            fn = _version_gated(long_name, min_proto, fn)
        table[(mod, long_name)] = fn
        table[(mod, schar)] = fn

    # historical aliases (this repo's earlier internal dialect, kept
    # for wasm_builder contracts already pinned in goldens/fixtures)
    table.update({
        ("x", "log"): log,
        ("x", "ledger_sequence"): ledger_sequence,
        ("x", "ledger_timestamp"): ledger_timestamp,
        ("x", "current_contract_address"): current_contract_address,
        ("x", "contract_event"): contract_event,
        ("x", "fail"): fail,
        ("l", "put_contract_data"): put_contract_data,
        ("l", "get_contract_data"): get_contract_data,
        ("l", "has_contract_data"): has_contract_data,
        ("l", "del_contract_data"): del_contract_data,
        ("l", "extend_contract_data_ttl"): extend_contract_data_ttl,
        ("l", "extend_instance_and_code_ttl"):
            extend_instance_and_code_ttl,
        ("v", "vec_new"): vec_new,
        ("v", "vec_push_back"): vec_push_back,
        ("v", "vec_get"): vec_get,
        ("v", "vec_len"): vec_len,
        ("m", "map_new"): map_new,
        ("m", "map_put"): map_put,
        ("m", "map_get"): map_get,
        ("m", "map_has"): map_has,
        ("m", "map_len"): map_len,
        ("b", "bytes_new_from_linear_memory"):
            bytes_new_from_linear_memory,
        ("b", "bytes_copy_to_linear_memory"):
            bytes_copy_to_linear_memory,
        ("b", "bytes_len"): bytes_len,
        ("b", "bytes_get"): bytes_get,
        ("b", "symbol_new_from_linear_memory"):
            symbol_new_from_linear_memory,
        ("b", "string_new_from_linear_memory"):
            string_new_from_linear_memory,
        ("i", "obj_from_u64"): obj_from_u64,
        ("i", "obj_to_u64"): obj_to_u64,
        ("i", "obj_from_i64"): obj_from_i64,
        ("i", "obj_to_i64"): obj_to_i64,
        ("a", "require_auth"): require_auth,
        ("c", "call"): call,
        ("d", "compute_sha256"): compute_sha256,
        ("p", "prng_u64_in_inclusive_range"):
            prng_u64_in_inclusive_range,
        ("p", "prng_bytes_new"): prng_bytes_new,
        ("p", "prng_reseed"): prng_reseed,
    })
    return table
