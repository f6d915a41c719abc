"""Minimal XDR (RFC 4506) runtime: declarative types with pack/unpack.

The reference compiles ``.x`` protocol files to C++ with xdrc
(``src/Makefile.am:88-91``, xdrpp in ``lib/``); here the same wire format
is expressed as composable Python type objects. Every type object
implements ``pack(packer, value)`` and ``unpack(unpacker) -> value``;
structs and unions are declared declaratively and round-trip to the exact
big-endian 4-byte-aligned XDR encoding, so hashes of encoded structures
(tx hashes, bucket hashes, ledger headers) are wire-compatible with the
reference's.

The port's copy of ``stellar_tpu/xdr/runtime.py``, with the port's
imports.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "XdrError", "Packer", "Unpacker", "Uint32", "Int32", "Uint64", "Int64",
    "Bool", "Opaque", "VarOpaque", "XdrString", "FixedArray", "VarArray",
    "Option", "Enum", "Struct", "Union", "Void", "to_bytes", "from_bytes",
]


class XdrError(Exception):
    pass


class Packer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def pack_uint(self, v: int):
        if not 0 <= v <= 0xFFFFFFFF:
            raise XdrError(f"uint32 out of range: {v}")
        self.buf += struct.pack(">I", v)

    def pack_int(self, v: int):
        if not -0x80000000 <= v <= 0x7FFFFFFF:
            raise XdrError(f"int32 out of range: {v}")
        self.buf += struct.pack(">i", v)

    def pack_uhyper(self, v: int):
        if not 0 <= v <= 0xFFFFFFFFFFFFFFFF:
            raise XdrError(f"uint64 out of range: {v}")
        self.buf += struct.pack(">Q", v)

    def pack_hyper(self, v: int):
        if not -0x8000000000000000 <= v <= 0x7FFFFFFFFFFFFFFF:
            raise XdrError(f"int64 out of range: {v}")
        self.buf += struct.pack(">q", v)

    def pack_fopaque(self, n: int, v: bytes):
        if len(v) != n:
            raise XdrError(f"fixed opaque: want {n} bytes, got {len(v)}")
        self.buf += v
        if n % 4:
            self.buf += b"\x00" * (4 - n % 4)

    def pack_opaque(self, v: bytes, maxlen: int):
        if len(v) > maxlen:
            raise XdrError(f"opaque too long: {len(v)} > {maxlen}")
        self.pack_uint(len(v))
        self.pack_fopaque(len(v), v)

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Unpacker:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise XdrError("unexpected end of XDR data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack_uint(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def unpack_int(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def unpack_uhyper(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def unpack_hyper(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def unpack_fopaque(self, n: int) -> bytes:
        out = self._take(n)
        if n % 4:
            pad = self._take(4 - n % 4)
            if pad != b"\x00" * len(pad):
                raise XdrError("non-zero XDR padding")
        return out

    def unpack_opaque(self, maxlen: int) -> bytes:
        n = self.unpack_uint()
        if n > maxlen:
            raise XdrError(f"opaque too long: {n} > {maxlen}")
        return self.unpack_fopaque(n)

    def done(self):
        if self.pos != len(self.data):
            raise XdrError(f"{len(self.data) - self.pos} trailing bytes")


# ---------------- type objects ----------------

class _Prim:
    IMMUTABLE = True  # values are ints: copy by identity

    def __init__(self, packname, unpackname):
        self._p, self._u = packname, unpackname

    def pack(self, p: Packer, v):
        getattr(p, self._p)(v)

    def unpack(self, u: Unpacker):
        return getattr(u, self._u)()

    @staticmethod
    def copy(v):
        return v


Uint32 = _Prim("pack_uint", "unpack_uint")
Int32 = _Prim("pack_int", "unpack_int")
Uint64 = _Prim("pack_uhyper", "unpack_uhyper")
Int64 = _Prim("pack_hyper", "unpack_hyper")


class _Bool:
    IMMUTABLE = True

    @staticmethod
    def copy(v):
        return v

    def pack(self, p, v):
        p.pack_uint(1 if v else 0)

    def unpack(self, u):
        v = u.unpack_uint()
        if v not in (0, 1):
            raise XdrError(f"bad bool {v}")
        return bool(v)


Bool = _Bool()


class _Void:
    IMMUTABLE = True

    @staticmethod
    def copy(v):
        return v

    def pack(self, p, v):
        if v is not None:
            raise XdrError("void takes None")

    def unpack(self, u):
        return None


Void = _Void()


class Opaque:
    IMMUTABLE = True  # values are bytes

    @staticmethod
    def copy(v):
        return v

    def __init__(self, n: int):
        self.n = n

    def pack(self, p, v):
        p.pack_fopaque(self.n, v)

    def unpack(self, u):
        return u.unpack_fopaque(self.n)


class VarOpaque:
    IMMUTABLE = True

    @staticmethod
    def copy(v):
        return v

    def __init__(self, maxlen: int = 0xFFFFFFFF):
        self.maxlen = maxlen

    def pack(self, p, v):
        p.pack_opaque(v, self.maxlen)

    def unpack(self, u):
        return u.unpack_opaque(self.maxlen)


class XdrString:
    """XDR string<maxlen>; values are Python bytes (the reference treats
    string32/string64 as raw bytes too)."""

    IMMUTABLE = True

    @staticmethod
    def copy(v):
        return v

    def __init__(self, maxlen: int = 0xFFFFFFFF):
        self.maxlen = maxlen

    def pack(self, p, v):
        if isinstance(v, str):
            v = v.encode()
        p.pack_opaque(v, self.maxlen)

    def unpack(self, u):
        return u.unpack_opaque(self.maxlen)


class FixedArray:
    def __init__(self, elem, n: int):
        self.elem, self.n = elem, n
        self._elem_immutable = getattr(elem, "IMMUTABLE", False)

    def copy(self, v):
        if self._elem_immutable:
            return list(v)
        return [self.elem.copy(e) for e in v]

    def pack(self, p, v):
        if len(v) != self.n:
            raise XdrError(f"fixed array: want {self.n}, got {len(v)}")
        for e in v:
            self.elem.pack(p, e)

    def unpack(self, u):
        return [self.elem.unpack(u) for _ in range(self.n)]


class VarArray:
    def __init__(self, elem, maxlen: int = 0xFFFFFFFF):
        self.elem, self.maxlen = elem, maxlen
        self._elem_immutable = getattr(elem, "IMMUTABLE", False)

    def copy(self, v):
        if self._elem_immutable:
            return list(v)
        return [self.elem.copy(e) for e in v]

    def pack(self, p, v):
        if len(v) > self.maxlen:
            raise XdrError(f"array too long: {len(v)} > {self.maxlen}")
        p.pack_uint(len(v))
        for e in v:
            self.elem.pack(p, e)

    def unpack(self, u):
        n = u.unpack_uint()
        if n > self.maxlen:
            raise XdrError(f"array too long: {n} > {self.maxlen}")
        return [self.elem.unpack(u) for _ in range(n)]


class Option:
    def __init__(self, elem):
        self.elem = elem
        self._elem_immutable = getattr(elem, "IMMUTABLE", False)

    def copy(self, v):
        if v is None or self._elem_immutable:
            return v
        return self.elem.copy(v)

    def pack(self, p, v):
        if v is None:
            p.pack_uint(0)
        else:
            p.pack_uint(1)
            self.elem.pack(p, v)

    def unpack(self, u):
        flag = u.unpack_uint()
        if flag == 0:
            return None
        if flag != 1:
            raise XdrError(f"bad optional flag {flag}")
        return self.elem.unpack(u)


class Enum:
    """Named int-valued enum; packs as int32, rejects unknown values."""

    def __init__(self, name: str, values: Dict[str, int]):
        self.name = name
        self.by_name = dict(values)
        self.by_value = {v: k for k, v in values.items()}
        for k, v in values.items():
            setattr(self, k, v)

    IMMUTABLE = True  # values are plain ints

    @staticmethod
    def copy(v):
        return v

    def pack(self, p, v):
        if v not in self.by_value:
            raise XdrError(f"bad {self.name} value {v}")
        p.pack_int(v)

    def unpack(self, u):
        v = u.unpack_int()
        if v not in self.by_value:
            raise XdrError(f"bad {self.name} value {v}")
        return v

    def name_of(self, v) -> str:
        return self.by_value.get(v, f"<{self.name}:{v}>")


class _StructMeta(type):
    def __new__(mcls, name, bases, ns):
        fields = ns.get("FIELDS")
        if fields:
            # real __slots__: catches misspelled field assignments and
            # drops per-instance dict overhead
            ns.setdefault("__slots__", tuple(f[0] for f in fields))
        cls = super().__new__(mcls, name, bases, ns)
        if fields:
            cls._names = tuple(f[0] for f in fields)
            cls._types = tuple(f[1] for f in fields)
        return cls


class Struct(metaclass=_StructMeta):
    """Declarative XDR struct: subclass with FIELDS = [(name, type), ...].

    Instances are plain attribute bags; equality/repr/pack/unpack derived.
    """
    __slots__ = ()
    FIELDS: List[Tuple[str, Any]] = []
    _names: Tuple[str, ...] = ()
    _types: Tuple[Any, ...] = ()

    def __init__(self, **kw):
        for n in self._names:
            setattr(self, n, kw.pop(n, None))
        if kw:
            raise TypeError(f"unknown fields {sorted(kw)} for "
                            f"{type(self).__name__}")

    @classmethod
    def _compile_codecs(cls):
        """Generate straight-line pack/unpack for this struct (the
        namedtuple trick): no per-field loop, zip, or getattr. Error
        context is recovered by re-running the slow field loop on
        failure, so messages stay field-precise."""
        ns = {"_types": cls._types, "_cls": cls}
        pack_body = "\n".join(
            f"    _types[{i}].pack(p, v.{n})"
            for i, n in enumerate(cls._names)) or "    pass"
        unpack_body = "\n".join(
            f"    out.{n} = _types[{i}].unpack(u)"
            for i, n in enumerate(cls._names)) or "    pass"
        # (copy is served exclusively by the compiled tree copier)
        src = (f"def _fast_pack(p, v):\n{pack_body}\n"
               f"def _fast_unpack(u):\n"
               f"    out = _cls.__new__(_cls)\n{unpack_body}\n"
               f"    return out\n")
        exec(src, ns)  # noqa: S102 - trusted, generated from FIELDS
        # plain functions (not staticmethod wrappers): every lookup goes
        # through cls.__dict__, bypassing the descriptor protocol
        cls._fast_pack = ns["_fast_pack"]
        cls._fast_unpack = ns["_fast_unpack"]

    @classmethod
    def pack(cls, p: Packer, v: "Struct"):
        fast = cls.__dict__.get("_tree_pack_fn")
        if fast is None:
            fast = tree_packer(cls)
        mark = len(p.buf)
        try:
            fast(p.buf, v)
        except XdrError:
            raise
        except Exception as e:
            # rewind the partial fast attempt, re-run the field loop
            # for a field-precise error, and keep the original chained
            del p.buf[mark:]
            cls._pack_slow(p, v, e)

    @classmethod
    def _pack_slow(cls, p: Packer, v: "Struct", cause: Exception):
        for n, t in zip(cls._names, cls._types):
            try:
                t.pack(p, getattr(v, n))
            except XdrError:
                raise
            except Exception as e:
                raise XdrError(
                    f"{cls.__name__}.{n}: {e}") from e
        raise XdrError(f"{cls.__name__}: fast pack failed but the "
                       "field loop succeeded (flaky field?)") from cause

    @classmethod
    def unpack(cls, u: Unpacker) -> "Struct":
        fast = cls.__dict__.get("_tree_unpack_fn")
        if fast is None:
            fast = tree_unpacker(cls)
        try:
            v, pos = fast(u.data, u.pos)
        except XdrError:
            raise
        except Exception:
            # canonical error (e.g. 'unexpected end of XDR data') via
            # the generic field loop from the same offset
            return cls._unpack_generic(u)
        u.pos = pos
        return v

    @classmethod
    def _unpack_generic(cls, u: Unpacker) -> "Struct":
        fast = cls.__dict__.get("_fast_unpack")
        if fast is None:
            cls._compile_codecs()
            fast = cls.__dict__["_fast_unpack"]
        return fast(u)

    @classmethod
    def copy(cls, v: "Struct") -> "Struct":
        """Deep copy without the wire roundtrip: compiled straight-line
        field copies with inlined arrays/options/unions, identity for
        immutable leaves."""
        fast = cls.__dict__.get("_tree_copy_fn")
        if fast is None:
            fast = tree_copier(cls)
        return fast(v)

    def __eq__(self, other):
        return (type(self) is type(other)
                and all(getattr(self, n) == getattr(other, n)
                        for n in self._names))

    def __hash__(self):
        return hash((type(self).__name__, to_bytes(type(self), self)))

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._names)
        return f"{type(self).__name__}({inner})"


class Union:
    """XDR discriminated union. Values are (arm_value, payload) pairs
    exposed as a small object with .arm and .value.

    arms: dict mapping discriminant value -> payload type (Void for void
    arms); default: payload type for unlisted discriminants (None = reject).
    """

    class Value:
        # _xdr_cache: memoized encoding slot for identity-hot values
        # (LedgerKey bytes — see ledger_txn.key_bytes). Never written
        # by the runtime itself.
        __slots__ = ("arm", "value", "_xdr_cache")

        def __init__(self, arm, value=None):
            self.arm = arm
            self.value = value

        def __eq__(self, other):
            return (isinstance(other, Union.Value)
                    and self.arm == other.arm and self.value == other.value)

        def __hash__(self):
            return hash((self.arm, repr(self.value)))

        def __repr__(self):
            return f"Union({self.arm}, {self.value!r})"

    def __init__(self, name: str, disc, arms: Dict[Any, Any], default=None):
        self.name = name
        self.disc = disc
        self.arms = arms
        self.default = default
        self._tree_fn = None
        self._tree_unpack_fn = None
        self._tree_copy_fn = None

    def make(self, arm, value=None) -> "Union.Value":
        return Union.Value(arm, value)

    def _armtype(self, arm):
        t = self.arms.get(arm, self.default)
        if t is None:
            raise XdrError(f"{self.name}: bad union arm {arm}")
        return t

    def _pack_generic(self, p, v: "Union.Value"):
        t = self._armtype(v.arm)
        self.disc.pack(p, v.arm)
        t.pack(p, v.value)

    def pack(self, p, v: "Union.Value"):
        fn = self._tree_fn
        if fn is None:
            fn = self._tree_fn = tree_packer(self)
        mark = len(p.buf)
        try:
            fn(p.buf, v)
        except XdrError:
            raise
        except Exception:
            # rewind, then generic for an arm-precise error
            del p.buf[mark:]
            self._pack_generic(p, v)
            raise XdrError(f"{self.name}: tree pack failed but "
                           "generic pack succeeded")

    def unpack(self, u):
        fn = self._tree_unpack_fn
        if fn is None:
            fn = self._tree_unpack_fn = tree_unpacker(self)
        try:
            v, pos = fn(u.data, u.pos)
        except XdrError:
            raise
        except Exception:
            return self._unpack_generic(u)
        u.pos = pos
        return v

    def _unpack_generic(self, u):
        arm = self.disc.unpack(u)
        t = self._armtype(arm)
        return Union.Value(arm, t.unpack(u))

    def copy(self, v: "Union.Value") -> "Union.Value":
        fn = self._tree_copy_fn
        if fn is None:
            fn = self._tree_copy_fn = tree_copier(self)
        return fn(v)

    def _copy_generic(self, v: "Union.Value") -> "Union.Value":
        t = self._armtype(v.arm)
        if getattr(t, "IMMUTABLE", False):
            return Union.Value(v.arm, v.value)
        return Union.Value(v.arm, t.copy(v.value))


# ---------------------------------------------------------------------------
# Inline tree-pack compiler
# ---------------------------------------------------------------------------
# The generic pack path costs ~6 Python calls per leaf (classmethod ->
# compiled field line -> type.pack -> Packer method -> struct.pack).
# Serialization IS the apply loop's hot path (tx hashing, entry sizes,
# meta, bucket hashing — reference xdrpp is compiled C++), so each type
# gets ONE generated function appending straight to a bytearray:
# primitives become prebound struct.Struct packs, enums become
# value->bytes dict lookups, arrays/options inline their element
# handling, and composite children are direct function calls. Rarely-
# taken error paths (bad enum value, wrong opaque length raising
# through struct.error/KeyError) fall back to the generic packer for
# field-precise XdrErrors — same discipline as Struct._pack_slow.

_SU32 = struct.Struct(">I").pack
_SI32 = struct.Struct(">i").pack
_SU64 = struct.Struct(">Q").pack
_SI64 = struct.Struct(">q").pack
_ZERO4 = b"\x00\x00\x00\x00"
_ONE4 = b"\x00\x00\x00\x01"
_PADS = {1: b"\x00\x00\x00", 2: b"\x00\x00", 3: b"\x00"}

# RLock: compiling a composite recursively compiles its children
_tree_lock = __import__("threading").RLock()
_tree_registry: Dict[int, Any] = {}
_tree_keepalive: List[Any] = []  # pin type objects so ids stay unique


def _resolve_lazy(t):
    real = getattr(t, "_real", None)
    return real() if callable(real) else t


def _void_tree(buf, v):
    if v is not None:
        raise XdrError("void takes None")


def _emit_node(t, expr, lines, ns, ctr, indent):
    """Append source lines that pack ``expr`` (a Python expression)
    into the local bytearray ``buf``."""
    pre = "    " * indent
    t = _resolve_lazy(t)
    if t is Uint32:
        lines.append(f"{pre}buf += _SU32({expr})")
        return
    if t is Int32:
        lines.append(f"{pre}buf += _SI32({expr})")
        return
    if t is Uint64:
        lines.append(f"{pre}buf += _SU64({expr})")
        return
    if t is Int64:
        lines.append(f"{pre}buf += _SI64({expr})")
        return
    if isinstance(t, _Bool):
        lines.append(f"{pre}buf += _ONE4 if {expr} else _ZERO4")
        return
    if isinstance(t, _Void):
        k = next(ctr)
        lines.append(f"{pre}if {expr} is not None:")
        lines.append(f"{pre}    raise XdrError('void takes None')")
        return
    if isinstance(t, Opaque):
        k = next(ctr)
        n = t.n
        lines.append(f"{pre}v{k} = {expr}")
        lines.append(f"{pre}if len(v{k}) != {n}:")
        lines.append(f"{pre}    raise XdrError("
                     f"'fixed opaque: want {n} bytes')")
        lines.append(f"{pre}buf += v{k}")
        if n % 4:
            lines.append(f"{pre}buf += {_PADS[n % 4]!r}")
        return
    if isinstance(t, (VarOpaque, XdrString)):
        k = next(ctr)
        lines.append(f"{pre}v{k} = {expr}")
        if isinstance(t, XdrString):
            lines.append(f"{pre}if type(v{k}) is str:")
            lines.append(f"{pre}    v{k} = v{k}.encode()")
        lines.append(f"{pre}n{k} = len(v{k})")
        lines.append(f"{pre}if n{k} > {t.maxlen}:")
        lines.append(f"{pre}    raise XdrError('opaque too long: ' +"
                     f" str(n{k}) + ' > {t.maxlen}')")
        lines.append(f"{pre}buf += _SU32(n{k})")
        lines.append(f"{pre}buf += v{k}")
        lines.append(f"{pre}if n{k} & 3:")
        lines.append(f"{pre}    buf += _PADS[n{k} & 3]")
        return
    if isinstance(t, Enum):
        k = next(ctr)
        ns[f"_e{k}"] = {v: _SI32(v) for v in t.by_value}
        lines.append(f"{pre}buf += _e{k}[{expr}]")  # KeyError->fallback
        return
    if isinstance(t, FixedArray):
        k = next(ctr)
        lines.append(f"{pre}a{k} = {expr}")
        lines.append(f"{pre}if len(a{k}) != {t.n}:")
        lines.append(f"{pre}    raise XdrError('fixed array: want "
                     f"{t.n}, got ' + str(len(a{k})))")
        lines.append(f"{pre}for e{k} in a{k}:")
        _emit_node(t.elem, f"e{k}", lines, ns, ctr, indent + 1)
        return
    if isinstance(t, VarArray):
        k = next(ctr)
        lines.append(f"{pre}a{k} = {expr}")
        lines.append(f"{pre}if len(a{k}) > {t.maxlen}:")
        lines.append(f"{pre}    raise XdrError('array too long: ' + "
                     f"str(len(a{k})) + ' > {t.maxlen}')")
        lines.append(f"{pre}buf += _SU32(len(a{k}))")
        lines.append(f"{pre}for e{k} in a{k}:")
        _emit_node(t.elem, f"e{k}", lines, ns, ctr, indent + 1)
        return
    if isinstance(t, Option):
        k = next(ctr)
        lines.append(f"{pre}v{k} = {expr}")
        lines.append(f"{pre}if v{k} is None:")
        lines.append(f"{pre}    buf += _ZERO4")
        lines.append(f"{pre}else:")
        lines.append(f"{pre}    buf += _ONE4")
        _emit_node(t.elem, f"v{k}", lines, ns, ctr, indent + 1)
        return
    if (isinstance(t, type) and issubclass(t, Struct)) or \
            isinstance(t, Union):
        k = next(ctr)
        ns[f"_f{k}"] = tree_packer(t)
        lines.append(f"{pre}_f{k}(buf, {expr})")
        return
    # unknown custom type: generic pack onto the shared buffer
    k = next(ctr)
    ns[f"_t{k}"] = t
    ns["_Packer"] = Packer
    lines.append(f"{pre}p{k} = _Packer()")
    lines.append(f"{pre}p{k}.buf = buf")
    lines.append(f"{pre}_t{k}.pack(p{k}, {expr})")


def _compile_tree(t):
    """Build the tree-pack function for one composite type."""
    import itertools
    ctr = itertools.count()
    ns = {"_SU32": _SU32, "_SI32": _SI32, "_SU64": _SU64,
          "_SI64": _SI64, "_ZERO4": _ZERO4, "_ONE4": _ONE4,
          "_PADS": _PADS, "XdrError": XdrError}
    lines: List[str] = []
    if isinstance(t, type) and issubclass(t, Struct):
        for n, ft in zip(t._names, t._types):
            _emit_node(ft, f"v.{n}", lines, ns, ctr, 1)
        body = "\n".join(lines) or "    pass"
        src = f"def _tp(buf, v):\n{body}\n"
        exec(src, ns)  # noqa: S102 - generated from declarative FIELDS
        return ns["_tp"]
    if isinstance(t, Union):
        arms = {}
        for arm, at in t.arms.items():
            at = _resolve_lazy(at)
            arms[arm] = _void_tree if isinstance(at, _Void) \
                else tree_packer(at)
        default = None
        if t.default is not None:
            dt = _resolve_lazy(t.default)
            default = _void_tree if isinstance(dt, _Void) \
                else tree_packer(dt)
        ns["_arms_get"] = arms.get
        ns["_dflt"] = default
        ns["_name"] = t.name
        disc = _resolve_lazy(t.disc)
        if isinstance(disc, Enum):
            ns["_ed"] = {v: _SI32(v) for v in disc.by_value}
            disc_line = "    buf += _ed[arm]"
        elif disc is Int32:
            disc_line = "    buf += _SI32(arm)"
        elif disc is Uint32:
            disc_line = "    buf += _SU32(arm)"
        else:  # exotic discriminant: generic path handles it
            ns["_disc"] = disc
            ns["_Packer"] = Packer
            disc_line = ("    p0 = _Packer()\n    p0.buf = buf\n"
                         "    _disc.pack(p0, arm)")
        src = (
            "def _tp(buf, v):\n"
            "    arm = v.arm\n"
            "    f = _arms_get(arm, _dflt)\n"
            "    if f is None:\n"
            "        raise XdrError('%s: bad union arm %r'"
            " % (_name, arm))\n"
            f"{disc_line}\n"
            "    f(buf, v.value)\n")
        exec(src, ns)  # noqa: S102
        return ns["_tp"]
    # non-composite root (primitive/array/option): wrap a single node
    lines = []
    _emit_node(t, "v", lines, ns, ctr, 1)
    src = "def _tp(buf, v):\n" + "\n".join(lines) + "\n"
    exec(src, ns)  # noqa: S102
    return ns["_tp"]


# ---------------------------------------------------------------------------
# Inline tree-copy compiler (completes the codec triad)
# ---------------------------------------------------------------------------
# LedgerTxn load/commit semantics deep-copy entries constantly; the
# generic path pays a method dispatch per composite node. Generated
# copiers inline IMMUTABLE leaves as identity, arrays as list() or
# comprehensions, options as conditional expressions, and unions as
# arm->function dict dispatch.

_untree_copy_registry: Dict[int, Any] = {}


def _is_immutable(t) -> bool:
    return bool(getattr(t, "IMMUTABLE", False))


def _copy_expr(t, expr, ns, ctr):
    """An EXPRESSION producing a deep copy of ``expr``."""
    t = _resolve_lazy(t)
    if _is_immutable(t) or isinstance(t, _Void):
        return expr
    if isinstance(t, Option):
        if _is_immutable(_resolve_lazy(t.elem)):
            return expr
        tmp = f"_o{next(ctr)}"
        sub = _copy_expr(t.elem, tmp, ns, ctr)
        return f"(None if ({tmp} := {expr}) is None else {sub})"
    if isinstance(t, (FixedArray, VarArray)):
        if _is_immutable(_resolve_lazy(t.elem)):
            return f"list({expr})"
        tmp = f"_e{next(ctr)}"
        sub = _copy_expr(t.elem, tmp, ns, ctr)
        return f"[{sub} for {tmp} in {expr}]"
    if (isinstance(t, type) and issubclass(t, Struct)) or \
            isinstance(t, Union):
        k = next(ctr)
        ns[f"_c{k}"] = tree_copier(t)
        return f"_c{k}({expr})"
    k = next(ctr)  # unknown custom type: its own generic copy
    ns[f"_t{k}"] = t
    return f"_t{k}.copy({expr})"


_MISSING_ARM = object()


def _compile_copytree(t):
    import itertools
    ctr = itertools.count()
    ns = {}
    if isinstance(t, type) and issubclass(t, Struct):
        ns["_cls"] = t
        lines = [f"    out.{n} = "
                 f"{_copy_expr(ft, f'v.{n}', ns, ctr)}"
                 for n, ft in zip(t._names, t._types)]
        src = ("def _tc(v):\n    out = _cls.__new__(_cls)\n" +
               "\n".join(lines) + "\n    return out\n")
        exec(src, ns)  # noqa: S102 - generated from declarative FIELDS
        return ns["_tc"]
    if isinstance(t, Union):
        arms = {}
        for arm, at in t.arms.items():
            at = _resolve_lazy(at)
            arms[arm] = None if (_is_immutable(at) or
                                 isinstance(at, _Void)) \
                else tree_copier(at)
        ns["_arms_get"] = arms.get
        ns["_MISSING"] = _MISSING_ARM
        ns["_gen"] = t._copy_generic
        ns["_UV"] = Union.Value
        src = (
            "def _tc(v):\n"
            "    arm = v.arm\n"
            "    f = _arms_get(arm, _MISSING)\n"
            "    if f is None:\n"
            "        return _UV(arm, v.value)\n"
            "    if f is _MISSING:\n"
            "        return _gen(v)\n"  # default arm / invalid
            "    return _UV(arm, f(v.value))\n")
        exec(src, ns)  # noqa: S102
        return ns["_tc"]
    expr = _copy_expr(t, "v", ns, ctr)
    src = f"def _tc(v):\n    return {expr}\n"
    exec(src, ns)  # noqa: S102
    return ns["_tc"]


def tree_copier(t):
    """Memoized tree-copy function for ``t``."""
    return _memoized_tree_fn(t, "_tree_copy_fn", _untree_copy_registry,
                             _compile_copytree,
                             "tree copy compilation failed")


def _memoized_tree_fn(t, attr, registry, compiler, fail_msg):
    """Shared memoization scaffold for the tree pack/unpack compilers.

    Cycle-safe and concurrency-safe: a forwarder is registered in the
    ``registry`` BEFORE compilation (compile-time recursion closes
    cycles through it), while the Struct class attribute ``attr`` is
    published only once the real function exists, so a concurrent
    Struct.pack/unpack that misses the attr lands on the forwarder and
    blocks on the lock instead of calling through an un-filled cell."""
    fn = registry.get(id(t))
    if fn is not None:
        return fn
    orig = t
    t = _resolve_lazy(t)
    is_struct = isinstance(t, type) and issubclass(t, Struct)
    fn = t.__dict__.get(attr) if is_struct else registry.get(id(t))
    if fn is not None:
        if orig is not t:
            registry[id(orig)] = fn
            _tree_keepalive.append(orig)
        return fn
    with _tree_lock:
        # re-check under the lock
        fn = t.__dict__.get(attr) if is_struct else registry.get(id(t))
        if fn is not None:
            return fn
        cell = [None]

        def forward(*args, _cell=cell):
            f = _cell[0]
            if f is None:
                # a concurrent thread sees the forwarder mid-compile:
                # wait for the compiling thread to release the lock
                with _tree_lock:
                    f = _cell[0]
                if f is None:
                    raise XdrError(fail_msg)
            return f(*args)

        registry[id(t)] = forward
        _tree_keepalive.append(t)
        try:
            real = compiler(t)
        except BaseException:
            del registry[id(t)]
            raise
        cell[0] = real
        if is_struct:
            setattr(t, attr, real)
        registry[id(t)] = real
        if orig is not t:
            registry[id(orig)] = real
            _tree_keepalive.append(orig)
        return real


def tree_packer(t):
    """Memoized tree-pack function for ``t``."""
    return _memoized_tree_fn(t, "_tree_pack_fn", _tree_registry,
                             _compile_tree,
                             "tree pack compilation failed")


def to_bytes(t, v) -> bytes:
    tp = tree_packer(t)
    buf = bytearray()
    try:
        tp(buf, v)
    except XdrError:
        raise
    except Exception as e:
        # rare/exceptional encodings (bad enum value, wrong types):
        # re-run the generic packer for a field-precise XdrError
        p = Packer()
        t.pack(p, v)
        raise XdrError(
            f"tree pack failed but generic pack succeeded: {e!r}"
        ) from e
    return bytes(buf)


# ---------------------------------------------------------------------------
# Inline tree-unpack compiler (mirror of the tree packer)
# ---------------------------------------------------------------------------
# Generated per-type functions take (data, pos) and return (value,
# pos'), with primitives inlined as prebound struct.Struct.unpack_from
# calls, explicit bounds/padding checks matching the generic
# Unpacker's, and struct instances built field-by-field via __new__.
# Rare failures (short buffer raising struct.error, bad enum) fall
# back to the generic unpacker from the SAME offset for the canonical
# field-precise XdrError.

_UU32 = struct.Struct(">I").unpack_from
_UI32 = struct.Struct(">i").unpack_from
_UU64 = struct.Struct(">Q").unpack_from
_UI64 = struct.Struct(">q").unpack_from

_untree_registry: Dict[int, Any] = {}


def _emit_unode(t, lines, ns, ctr, indent, dest):
    """Append source lines that read ``dest`` from data/pos."""
    pre = "    " * indent
    t = _resolve_lazy(t)
    if t is Uint32:
        lines.append(f"{pre}{dest} = _UU32(data, pos)[0]; pos += 4")
        return
    if t is Int32:
        lines.append(f"{pre}{dest} = _UI32(data, pos)[0]; pos += 4")
        return
    if t is Uint64:
        lines.append(f"{pre}{dest} = _UU64(data, pos)[0]; pos += 8")
        return
    if t is Int64:
        lines.append(f"{pre}{dest} = _UI64(data, pos)[0]; pos += 8")
        return
    if isinstance(t, _Bool):
        k = next(ctr)
        lines.append(f"{pre}b{k} = _UU32(data, pos)[0]; pos += 4")
        lines.append(f"{pre}if b{k} > 1:")
        lines.append(f"{pre}    raise XdrError('bad bool ' + str(b{k}))")
        lines.append(f"{pre}{dest} = b{k} == 1")
        return
    if isinstance(t, _Void):
        lines.append(f"{pre}{dest} = None")
        return
    if isinstance(t, Opaque):
        n = t.n
        total = n + (4 - n % 4 if n % 4 else 0)
        lines.append(f"{pre}if pos + {total} > len(data):")
        lines.append(f"{pre}    raise XdrError("
                     "'unexpected end of XDR data')")
        lines.append(f"{pre}{dest} = data[pos:pos + {n}]")
        if n % 4:
            pad_lit = repr(b"\x00" * (4 - n % 4))
            lines.append(f"{pre}if data[pos + {n}:pos + {total}] != "
                         f"{pad_lit}:")
            lines.append(f"{pre}    raise XdrError("
                         "'non-zero XDR padding')")
        lines.append(f"{pre}pos += {total}")
        return
    if isinstance(t, (VarOpaque, XdrString)):
        k = next(ctr)
        lines.append(f"{pre}n{k} = _UU32(data, pos)[0]; pos += 4")
        lines.append(f"{pre}if n{k} > {t.maxlen}:")
        lines.append(f"{pre}    raise XdrError('opaque too long: ' +"
                     f" str(n{k}) + ' > {t.maxlen}')")
        lines.append(f"{pre}e{k} = pos + n{k} + (-n{k} & 3)")
        lines.append(f"{pre}if e{k} > len(data):")
        lines.append(f"{pre}    raise XdrError("
                     "'unexpected end of XDR data')")
        lines.append(f"{pre}{dest} = data[pos:pos + n{k}]")
        lines.append(f"{pre}if n{k} & 3 and "
                     f"data[pos + n{k}:e{k}].strip(b'\\x00'):")
        lines.append(f"{pre}    raise XdrError("
                     "'non-zero XDR padding')")
        lines.append(f"{pre}pos = e{k}")
        return
    if isinstance(t, Enum):
        k = next(ctr)
        ns[f"_es{k}"] = frozenset(t.by_value)
        lines.append(f"{pre}{dest} = _UI32(data, pos)[0]; pos += 4")
        lines.append(f"{pre}if {dest} not in _es{k}:")
        lines.append(f"{pre}    raise XdrError('bad {t.name} value '"
                     f" + str({dest}))")
        return
    if isinstance(t, FixedArray):
        k = next(ctr)
        lines.append(f"{pre}{dest} = []")
        lines.append(f"{pre}for _i{k} in range({t.n}):")
        _emit_unode(t.elem, lines, ns, ctr, indent + 1, f"x{k}")
        lines.append(f"{pre}    {dest}.append(x{k})")
        return
    if isinstance(t, VarArray):
        k = next(ctr)
        lines.append(f"{pre}n{k} = _UU32(data, pos)[0]; pos += 4")
        lines.append(f"{pre}if n{k} > {t.maxlen}:")
        lines.append(f"{pre}    raise XdrError('array too long: ' +"
                     f" str(n{k}) + ' > {t.maxlen}')")
        lines.append(f"{pre}{dest} = []")
        lines.append(f"{pre}for _i{k} in range(n{k}):")
        _emit_unode(t.elem, lines, ns, ctr, indent + 1, f"x{k}")
        lines.append(f"{pre}    {dest}.append(x{k})")
        return
    if isinstance(t, Option):
        k = next(ctr)
        lines.append(f"{pre}f{k} = _UU32(data, pos)[0]; pos += 4")
        lines.append(f"{pre}if f{k} == 0:")
        lines.append(f"{pre}    {dest} = None")
        lines.append(f"{pre}elif f{k} == 1:")
        _emit_unode(t.elem, lines, ns, ctr, indent + 1, dest)
        lines.append(f"{pre}else:")
        lines.append(f"{pre}    raise XdrError('bad optional flag '"
                     f" + str(f{k}))")
        return
    if (isinstance(t, type) and issubclass(t, Struct)) or \
            isinstance(t, Union):
        k = next(ctr)
        ns[f"_g{k}"] = tree_unpacker(t)
        lines.append(f"{pre}{dest}, pos = _g{k}(data, pos)")
        return
    # unknown custom type: generic unpack resumed at this offset
    k = next(ctr)
    ns[f"_t{k}"] = t
    ns["_Unpacker"] = Unpacker
    lines.append(f"{pre}u{k} = _Unpacker(data)")
    lines.append(f"{pre}u{k}.pos = pos")
    lines.append(f"{pre}{dest} = _t{k}.unpack(u{k})")
    lines.append(f"{pre}pos = u{k}.pos")


def _compile_untree(t):
    import itertools
    ctr = itertools.count()
    ns = {"_UU32": _UU32, "_UI32": _UI32, "_UU64": _UU64,
          "_UI64": _UI64, "XdrError": XdrError}
    lines: List[str] = []
    if isinstance(t, type) and issubclass(t, Struct):
        ns["_cls"] = t
        for n, ft in zip(t._names, t._types):
            _emit_unode(ft, lines, ns, ctr, 1, f"_fv_{n}")
        body = "\n".join(lines) or "    pass"
        assigns = "\n".join(f"    out.{n} = _fv_{n}"
                            for n in t._names) or "    pass"
        src = (f"def _tu(data, pos):\n{body}\n"
               f"    out = _cls.__new__(_cls)\n{assigns}\n"
               "    return out, pos\n")
        exec(src, ns)  # noqa: S102 - generated from declarative FIELDS
        return ns["_tu"]
    if isinstance(t, Union):
        arms = {}
        for arm, at in t.arms.items():
            arms[arm] = tree_unpacker(_resolve_lazy(at))
        default = None
        if t.default is not None:
            default = tree_unpacker(_resolve_lazy(t.default))
        ns["_arms_get"] = arms.get
        ns["_dflt"] = default
        ns["_name"] = t.name
        ns["_UV"] = Union.Value
        disc = _resolve_lazy(t.disc)
        if isinstance(disc, Enum):
            ns["_es"] = frozenset(disc.by_value)
            # canonical message parity: the generic path raises with
            # the ENUM's name (Enum.unpack), not the union's
            ns["_ename"] = disc.name
            disc_src = (
                "    arm = _UI32(data, pos)[0]; pos += 4\n"
                "    if arm not in _es:\n"
                "        raise XdrError('bad %s value %s'"
                " % (_ename, arm))\n")
        elif disc is Int32:
            disc_src = "    arm = _UI32(data, pos)[0]; pos += 4\n"
        elif disc is Uint32:
            disc_src = "    arm = _UU32(data, pos)[0]; pos += 4\n"
        else:
            ns["_disc"] = disc
            ns["_Unpacker"] = Unpacker
            disc_src = ("    u0 = _Unpacker(data)\n    u0.pos = pos\n"
                        "    arm = _disc.unpack(u0)\n    pos = u0.pos\n")
        src = (
            "def _tu(data, pos):\n"
            f"{disc_src}"
            "    f = _arms_get(arm, _dflt)\n"
            "    if f is None:\n"
            "        raise XdrError('%s: bad union arm %r'"
            " % (_name, arm))\n"
            "    v, pos = f(data, pos)\n"
            "    return _UV(arm, v), pos\n")
        exec(src, ns)  # noqa: S102
        return ns["_tu"]
    # non-composite root
    lines = []
    _emit_unode(t, lines, ns, ctr, 1, "v")
    src = ("def _tu(data, pos):\n" + "\n".join(lines) +
           "\n    return v, pos\n")
    exec(src, ns)  # noqa: S102
    return ns["_tu"]


def tree_unpacker(t):
    """Memoized tree-unpack function for ``t``."""
    return _memoized_tree_fn(t, "_tree_unpack_fn", _untree_registry,
                             _compile_untree,
                             "tree unpack compilation failed")


def _from_bytes_generic(t, data: bytes):
    u = Unpacker(data)
    out = t.unpack(u)
    u.done()
    return out


def from_bytes(t, data: bytes):
    fn = tree_unpacker(t)
    try:
        v, pos = fn(data, 0)
    except XdrError:
        raise
    except Exception as e:
        # short buffer (struct.error) etc: canonical error via the
        # generic path, which re-reads from the start
        out = _from_bytes_generic(t, data)
        raise XdrError(
            f"tree unpack failed but generic unpack succeeded: {e!r}"
        ) from e
    if pos != len(data):
        raise XdrError(f"{len(data) - pos} trailing bytes")
    return v
