"""Wasm-MVP decoder, validator and metered interpreter — the execution
engine behind ``invoke_host_function`` (reference: stellar-core executes
contracts through soroban-env-host's wasmi VM behind
``src/rust/src/lib.rs:61-83,182-195``; this module plays wasmi's role).

Scope: the integer subset of wasm MVP that Soroban-style contracts use —
i32/i64 arithmetic, linear memory, structured control flow, direct and
indirect calls, globals, plus the sign-extension ops. Floating point is
REJECTED at validation time, exactly as the reference environment does
(soroban-env-host configures wasmi to reject float opcodes; contracts
containing them fail to upload).

Design notes: contract execution is host-side consensus logic —
branchy, byte-oriented, metered per instruction — so it runs on the
host CPU, not the card. Each function body is pre-decoded
ONCE at parse into a flat op list with every structured branch resolved
to an absolute target plus a landing stack height (the height-only core
of the standard wasm validation algorithm), so the hot loop is a table
dispatch with no runtime label bookkeeping; the per-instruction budget
charge then matches the reference's wasmi fuel metering.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Trap", "WasmError", "WasmModule", "WasmInstance", "parse_module",
    "PAGE_SIZE", "MAX_PAGES",
]

PAGE_SIZE = 65536
MAX_PAGES = 1024  # 64 MiB hard cap, above any soroban memory budget
MAX_CALL_FRAMES = 256


class WasmError(Exception):
    """Malformed or unsupported module (upload-time failure)."""


class Trap(Exception):
    """Runtime trap (unreachable, OOB access, div by zero, ...)."""


# ---------------------------------------------------------------------------
# Binary reader
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("b", "i", "n")

    def __init__(self, b: bytes, i: int = 0, n: Optional[int] = None):
        self.b = b
        self.i = i
        self.n = len(b) if n is None else n

    def eof(self) -> bool:
        return self.i >= self.n

    def byte(self) -> int:
        if self.i >= self.n:
            raise WasmError("truncated module")
        v = self.b[self.i]
        self.i += 1
        return v

    def bytes(self, k: int) -> bytes:
        if k < 0 or self.i + k > self.n:
            raise WasmError("truncated module")
        v = self.b[self.i:self.i + k]
        self.i += k
        return v

    def u32(self) -> int:
        """LEB128 unsigned, <= 32 bit."""
        r = s = 0
        while True:
            b = self.byte()
            r |= (b & 0x7F) << s
            if not b & 0x80:
                break
            s += 7
            if s > 32:
                raise WasmError("u32 LEB overflow")
        if r >= 1 << 32:
            raise WasmError("u32 out of range")
        return r

    def s_leb(self, bits: int) -> int:
        """LEB128 signed, <= ``bits`` wide."""
        r = s = 0
        while True:
            b = self.byte()
            r |= (b & 0x7F) << s
            s += 7
            if not b & 0x80:
                if s < bits and (b & 0x40):
                    r |= -1 << s
                break
            if s > bits + 7:
                raise WasmError("sLEB overflow")
        # canonical two's-complement wrap into range
        r &= (1 << bits) - 1
        if r >= 1 << (bits - 1):
            r -= 1 << bits
        return r

    def name(self) -> str:
        raw = self.bytes(self.u32())
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            raise WasmError("bad UTF-8 name")


# ---------------------------------------------------------------------------
# Module structures
# ---------------------------------------------------------------------------

I32, I64, F32, F64, FUNCREF = 0x7F, 0x7E, 0x7D, 0x7C, 0x70


class FuncType:
    __slots__ = ("params", "results")

    def __init__(self, params: Tuple[int, ...], results: Tuple[int, ...]):
        self.params = params
        self.results = results

    def __eq__(self, other):
        return (self.params, self.results) == \
            (other.params, other.results)

    def __hash__(self):
        return hash((self.params, self.results))


_CO_VARARGS = 0x04


def handler_arity(fn):
    """Positional arity of a host-import handler, excluding the leading
    instance arg; None when not introspectable (builtin) or variadic.
    The single source of truth for both the link-time check below and
    the generated evidence-tier audit table (tools/gen_env_tiers.py).
    Wrappers that hide their wrapped function's signature (e.g. the
    protocol-version gates in env.py) declare it via ``__env_arity__``."""
    declared = getattr(fn, "__env_arity__", None)
    if declared is not None:
        return declared
    code = getattr(fn, "__code__", None)
    if code is None or (code.co_flags & _CO_VARARGS):
        return None
    return code.co_argcount - 1


def check_import_era(mod: str, name: str, fn) -> None:
    """Protocol-era link refusal: a handler carrying ``__min_protocol__``
    (the env's version gates) must be UNRESOLVABLE below its era, not
    merely trap when called — the reference pins one host crate per
    protocol, so a p21-era frame importing a p22 function fails at
    instantiation even if the function is never executed."""
    min_proto = getattr(fn, "__min_protocol__", None)
    if min_proto is None:
        return
    version = fn.__frame_version__()
    if version < min_proto:
        raise WasmError(
            f"unresolved import {mod!r}.{name!r}: requires protocol "
            f"{min_proto}, frame runs protocol {version}")


def check_import_binding(mod: str, name: str, ftype: FuncType, fn) -> None:
    """Link-time arity cross-check: the contract's own
    import declaration is independent evidence of which host function an
    export name denotes. The env-interface registry derives most of its
    short-name orderings offline, so a mis-derived index that happens to
    resolve must fail HERE, loudly — naming the binding and the long
    name the derivation chose — rather than link to the wrong function
    and misbehave at run time. (Reference links the real
    ``soroban-env-host`` crates, src/rust/src/lib.rs:61-83, where the
    linker does this job.)"""
    check_import_era(mod, name, fn)
    have = handler_arity(fn)
    if have is None:  # non-introspectable or variadic wrapper
        return
    declared = len(ftype.params)
    if declared == have:
        return
    detail = ""
    try:  # best effort: soroban registry context for the error
        from stellar_tpu_torch.soroban.env_interface import describe_binding
        detail = describe_binding(mod, name)
    except Exception:
        pass
    code = fn.__code__
    who = getattr(code, "co_qualname", None) or \
        getattr(fn, "__name__", repr(fn))
    raise WasmError(
        f"import arity mismatch for {mod!r}.{name!r}: contract declares "
        f"{declared} params, resolved handler {who!r} takes "
        f"{have}{detail}")


class _Func:
    """One defined function: flattened code + frame layout."""
    __slots__ = ("type", "locals", "ops")

    def __init__(self, ftype: FuncType, locals_: List[int], ops: List):
        self.type = ftype
        self.locals = locals_
        self.ops = ops


class WasmModule:
    def __init__(self):
        self.types: List[FuncType] = []
        # imports: (module, name, functype) — only function imports
        self.imports: List[Tuple[str, str, FuncType]] = []
        self.func_type_idx: List[int] = []     # defined funcs
        self.funcs: List[_Func] = []
        self.table_min = 0
        self.mem_min = 0
        self.mem_max: Optional[int] = None
        # globals: list of [valtype, mutable, init_value]
        self.globals: List[List] = []
        self.exports: Dict[str, Tuple[str, int]] = {}  # name->(kind,idx)
        self.elements: List[Tuple[int, List[int]]] = []  # (offset, idxs)
        self.data: List[Tuple[int, bytes]] = []
        self.start: Optional[int] = None
        # custom sections by name (first occurrence wins); the soroban
        # "contractenvmetav0" section carries the env interface version
        # the contract was compiled against
        self.customs: Dict[str, bytes] = {}
        self._env_meta: Tuple = ()  # lazily-computed cache

    @property
    def env_meta_version(self) -> Optional[int]:
        """Interface version from the contractenvmetav0 custom section
        (SCEnvMetaEntry: u32 kind 0 + u64 version), or None if absent.
        Modern SDK builds encode ``protocol << 32 | prerelease``; the
        reference's testdata fixtures carry small pre-1.0 versions.
        Cached — the dialect check runs on every invoke."""
        if self._env_meta:
            return self._env_meta[0]
        body = self.customs.get("contractenvmetav0")
        version = None
        if body is not None and len(body) >= 12 and \
                int.from_bytes(body[:4], "big") == 0:
            version = int.from_bytes(body[4:12], "big")
        self._env_meta = (version,)
        return version

    def func_type(self, func_idx: int) -> FuncType:
        """Type of function ``func_idx`` in the unified index space
        (imports first, then defined)."""
        ni = len(self.imports)
        if func_idx < ni:
            return self.imports[func_idx][2]
        return self.types[self.func_type_idx[func_idx - ni]]


def parse_module(code: bytes) -> WasmModule:
    """Decode + validate a wasm binary; raises WasmError on anything
    outside the supported integer-MVP subset."""
    if len(code) < 8 or code[:4] != b"\x00asm":
        raise WasmError("bad magic")
    if code[4:8] != b"\x01\x00\x00\x00":
        raise WasmError("unsupported wasm version")
    m = WasmModule()
    r = _Reader(code, 8)
    last_id = -1
    code_bodies: List[bytes] = []
    while not r.eof():
        sec_id = r.byte()
        size = r.u32()
        payload = r.bytes(size)
        if sec_id != 0:
            if sec_id <= last_id:
                raise WasmError("sections out of order")
            last_id = sec_id
        sr = _Reader(payload)
        if sec_id == 0:
            # custom section: retain (env/spec metadata), never validate
            try:
                cname = sr.bytes(sr.u32()).decode("utf-8")
            except Exception:
                continue
            m.customs.setdefault(cname, payload[sr.i:])
            continue
        elif sec_id == 1:
            _parse_types(sr, m)
        elif sec_id == 2:
            _parse_imports(sr, m)
        elif sec_id == 3:
            for _ in range(sr.u32()):
                ti = sr.u32()
                if ti >= len(m.types):
                    raise WasmError("func type index out of range")
                m.func_type_idx.append(ti)
        elif sec_id == 4:
            _parse_tables(sr, m)
        elif sec_id == 5:
            _parse_memories(sr, m)
        elif sec_id == 6:
            _parse_globals(sr, m)
        elif sec_id == 7:
            _parse_exports(sr, m)
        elif sec_id == 8:
            m.start = sr.u32()
        elif sec_id == 9:
            _parse_elements(sr, m)
        elif sec_id == 10:
            for _ in range(sr.u32()):
                code_bodies.append(sr.bytes(sr.u32()))
        elif sec_id == 11:
            _parse_data(sr, m)
        else:
            raise WasmError(f"unknown section {sec_id}")
    if len(code_bodies) != len(m.func_type_idx):
        raise WasmError("function/code section count mismatch")
    for ti, body in zip(m.func_type_idx, code_bodies):
        m.funcs.append(_decode_body(m, m.types[ti], body))
    n_funcs = len(m.imports) + len(m.funcs)
    for name, (kind, idx) in m.exports.items():
        if kind == "func" and idx >= n_funcs:
            raise WasmError(f"export {name!r}: bad func index")
        if kind == "global" and idx >= len(m.globals):
            raise WasmError(f"export {name!r}: bad global index")
    if m.start is not None:
        if m.start >= n_funcs:
            raise WasmError("bad start function")
        st = m.func_type(m.start)
        if st.params or st.results:
            raise WasmError("start function must be [] -> []")
    for _, idxs in m.elements:
        for fi in idxs:
            if fi >= n_funcs:
                raise WasmError("element func index out of range")
    return m


def _valtype(b: int) -> int:
    if b in (I32, I64):
        return b
    if b in (F32, F64):
        raise WasmError("floating point is not supported")
    raise WasmError(f"bad value type 0x{b:02x}")


def _parse_types(r: _Reader, m: WasmModule):
    for _ in range(r.u32()):
        if r.byte() != 0x60:
            raise WasmError("bad functype tag")
        params = tuple(_valtype(r.byte()) for _ in range(r.u32()))
        results = tuple(_valtype(r.byte()) for _ in range(r.u32()))
        if len(results) > 1:
            raise WasmError("multi-value results not supported")
        m.types.append(FuncType(params, results))


def _parse_imports(r: _Reader, m: WasmModule):
    for _ in range(r.u32()):
        mod, name = r.name(), r.name()
        kind = r.byte()
        if kind == 0x00:
            ti = r.u32()
            if ti >= len(m.types):
                raise WasmError("import type index out of range")
            m.imports.append((mod, name, m.types[ti]))
        else:
            # memory/table/global imports are not part of the contract
            # ABI (the host provides none)
            raise WasmError("only function imports are supported")


def _parse_tables(r: _Reader, m: WasmModule):
    n = r.u32()
    if n > 1:
        raise WasmError("multiple tables")
    for _ in range(n):
        if r.byte() != FUNCREF:
            raise WasmError("only funcref tables")
        flags = r.byte()
        m.table_min = r.u32()
        if m.table_min > 100_000:
            raise WasmError("table too large")
        if flags & 1:
            r.u32()  # max: accepted, unenforced (table never grows)


def _parse_memories(r: _Reader, m: WasmModule):
    n = r.u32()
    if n > 1:
        raise WasmError("multiple memories")
    for _ in range(n):
        flags = r.byte()
        m.mem_min = r.u32()
        m.mem_max = r.u32() if flags & 1 else None
        if m.mem_min > MAX_PAGES:
            raise WasmError("initial memory too large")


def _parse_globals(r: _Reader, m: WasmModule):
    for _ in range(r.u32()):
        vt = _valtype(r.byte())
        mut = r.byte()
        if mut not in (0, 1):
            raise WasmError("bad global mutability")
        mask = _M32 if vt == I32 else _M64
        m.globals.append([vt, bool(mut), _const_expr(r) & mask])


def _const_expr(r: _Reader) -> int:
    op = r.byte()
    if op == 0x41:
        v = r.s_leb(32)
    elif op == 0x42:
        v = r.s_leb(64)
    else:
        raise WasmError("unsupported const expr")
    if r.byte() != 0x0B:
        raise WasmError("const expr not terminated")
    return v


def _parse_exports(r: _Reader, m: WasmModule):
    kinds = {0: "func", 1: "table", 2: "mem", 3: "global"}
    for _ in range(r.u32()):
        name = r.name()
        kind = r.byte()
        idx = r.u32()
        if kind not in kinds:
            raise WasmError("bad export kind")
        if name in m.exports:
            raise WasmError(f"duplicate export {name!r}")
        m.exports[name] = (kinds[kind], idx)


def _parse_elements(r: _Reader, m: WasmModule):
    for _ in range(r.u32()):
        if r.u32() != 0:
            raise WasmError("only active table-0 element segments")
        off = _const_expr(r)
        idxs = [r.u32() for _ in range(r.u32())]
        m.elements.append((off, idxs))


def _parse_data(r: _Reader, m: WasmModule):
    for _ in range(r.u32()):
        if r.u32() != 0:
            raise WasmError("only active memory-0 data segments")
        off = _const_expr(r)
        m.data.append((off, r.bytes(r.u32())))


# ---------------------------------------------------------------------------
# Integer helpers
# ---------------------------------------------------------------------------

_M32, _M64 = (1 << 32) - 1, (1 << 64) - 1


def _s32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _s64(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _clz(v: int, bits: int) -> int:
    return bits - v.bit_length() if v else bits


def _ctz(v: int, bits: int) -> int:
    return ((v & -v).bit_length() - 1) if v else bits


def _div_s(a: int, b: int, bits: int) -> int:
    if b == 0:
        raise Trap("integer divide by zero")
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    if q == 1 << (bits - 1):
        raise Trap("integer overflow")
    return q


def _rem_s(a: int, b: int) -> int:
    if b == 0:
        raise Trap("integer divide by zero")
    r = abs(a) % abs(b)
    return -r if a < 0 else r


# pure numeric ops: how many operands each pops (all push exactly 1)
_NUMERIC_POPS = {}
for _op in range(0x46, 0x50):
    _NUMERIC_POPS[_op] = 2          # i32 binary comparisons
for _op in range(0x51, 0x5B):
    _NUMERIC_POPS[_op] = 2          # i64 binary comparisons
for _op in range(0x6A, 0x79):
    _NUMERIC_POPS[_op] = 2          # i32 binary arithmetic
for _op in range(0x7C, 0x8B):
    _NUMERIC_POPS[_op] = 2          # i64 binary arithmetic
for _op in (0x45, 0x50, 0x67, 0x68, 0x69, 0x79, 0x7A, 0x7B,
            0xA7, 0xAC, 0xAD, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4):
    _NUMERIC_POPS[_op] = 1          # unary / test / conversion


# ---------------------------------------------------------------------------
# Body decoding: flatten structured control flow to absolute jumps
# ---------------------------------------------------------------------------
#
# One pass walks the body tracking static operand-stack HEIGHTS (the
# height-only core of the standard wasm validation algorithm): every
# branch is annotated (target_pc, result_arity, landing_height) from
# its target frame, so the interpreter can discard dead temporaries
# exactly as wasm label semantics require without runtime label
# bookkeeping. Reachable stack underflow is a decode error (upload-time
# rejection, like the reference's wasmi validation); code after
# br/return/unreachable is height-polymorphic until the enclosing
# else/end, per the spec's validation rules.

_BLOCK_OPS = (0x02, 0x03, 0x04)


class _Frame:
    __slots__ = ("kind", "pc", "n_out", "h_base", "patches", "else_pc",
                 "unreachable")

    def __init__(self, kind, pc, n_out, h_base):
        self.kind = kind          # "func" | 0x02 block | 0x03 loop | 0x04 if
        self.pc = pc              # pc of the entry op
        self.n_out = n_out
        self.h_base = h_base      # stack height at frame entry
        self.patches = []         # (br_pc, br_table_slot_index | None)
        self.else_pc = None
        self.unreachable = False


def _decode_body(m: WasmModule, ftype: FuncType, body: bytes) -> _Func:
    r = _Reader(body)
    locals_: List[int] = list(ftype.params)
    for _ in range(r.u32()):
        count = r.u32()
        vt = _valtype(r.byte())
        if count > 50_000 or len(locals_) + count > 50_000:
            raise WasmError("too many locals")
        locals_.extend([vt] * count)

    ops: List[List] = []
    ctrl: List[_Frame] = [_Frame("func", -1, len(ftype.results), 0)]
    h = 0  # static operand-stack height

    def pop(n: int):
        nonlocal h
        cur = ctrl[-1]
        if cur.unreachable:
            h = max(h - n, cur.h_base)
        else:
            if h - n < cur.h_base:
                raise WasmError("operand stack underflow")
            h -= n

    def push(n: int):
        nonlocal h
        h += n

    def branch_target(depth: int):
        """(frame, arity, landing_height) for a branch ``depth`` out."""
        if depth >= len(ctrl):
            raise WasmError("br depth out of range")
        f = ctrl[-1 - depth]
        arity = 0 if f.kind == 0x03 else f.n_out  # loop: jump to head
        return f, arity, f.h_base + arity

    def block_out(bt: int) -> int:
        if bt == 0x40:
            return 0
        if bt in (I32, I64):
            return 1
        if bt in (F32, F64):
            raise WasmError("floating point is not supported")
        raise WasmError("type-index block types not supported")

    while True:
        if r.eof():
            raise WasmError("body not terminated")
        op = r.byte()
        pc = len(ops)
        if op in _BLOCK_OPS:
            n_out = block_out(r.byte())
            if op == 0x04:
                pop(1)  # the condition
            ctrl.append(_Frame(op, pc, n_out, h))
            ops.append([op, None])
        elif op == 0x05:  # else
            cur = ctrl[-1]
            if cur.kind != 0x04 or cur.else_pc is not None:
                raise WasmError("else outside if")
            if not cur.unreachable and h != cur.h_base + cur.n_out:
                raise WasmError("then-arm result arity mismatch")
            cur.else_pc = pc
            cur.unreachable = False
            h = cur.h_base
            ops.append([op, None])  # jump over the else arm (to end)
        elif op == 0x0B:  # end
            frame = ctrl.pop()
            ops.append([op, None])
            # a reachable frame exit must have produced exactly the
            # declared results — without this, an upload-"valid"
            # module underflows the operand stack at runtime
            if not frame.unreachable and \
                    h != frame.h_base + frame.n_out:
                raise WasmError("block result arity mismatch")
            h = frame.h_base + frame.n_out
            if frame.kind == "func":
                if not r.eof():
                    raise WasmError("trailing bytes after function end")
                # a br to the function frame is a return: jump past the
                # last op so the run loop exits and yields the results
                for ppc, slot in frame.patches:
                    if slot is None:
                        ops[ppc][1][0] = pc + 1
                    else:
                        ops[ppc][1][slot][0] = pc + 1
                break
            end_pc = pc
            target = frame.pc + 1 if frame.kind == 0x03 else end_pc + 1
            for ppc, slot in frame.patches:
                if slot is None:
                    ops[ppc][1][0] = target
                else:
                    ops[ppc][1][slot][0] = target
            if frame.kind == 0x04:
                if frame.else_pc is None and frame.n_out != 0:
                    raise WasmError("if without else yields a value")
                ops[frame.pc][1] = (
                    (frame.else_pc + 1) if frame.else_pc is not None
                    else end_pc + 1)
                if frame.else_pc is not None:
                    ops[frame.else_pc][1] = end_pc + 1
            else:
                ops[frame.pc][1] = end_pc + 1  # unused at runtime
        elif op == 0x0C:  # br
            f, arity, land = branch_target(r.u32())
            pop(arity)
            f.patches.append((pc, None))
            ops.append([op, [None, arity, land]])
            ctrl[-1].unreachable = True
            h = ctrl[-1].h_base
        elif op == 0x0D:  # br_if
            pop(1)
            f, arity, land = branch_target(r.u32())
            pop(arity)
            push(arity)  # not taken: the values stay
            f.patches.append((pc, None))
            ops.append([op, [None, arity, land]])
        elif op == 0x0E:  # br_table
            pop(1)
            depths = [r.u32() for _ in range(r.u32())]
            depths.append(r.u32())  # default label
            slots = []
            arity0 = None
            for d in depths:
                f, arity, _land = branch_target(d)
                if arity0 is None:
                    arity0 = arity
                elif arity != arity0:
                    raise WasmError("br_table arity mismatch")
                f.patches.append((pc, len(slots)))
                slots.append([None, arity, _land])
            pop(arity0 or 0)
            ops.append([op, slots])
            ctrl[-1].unreachable = True
            h = ctrl[-1].h_base
        elif op == 0x0F:  # return
            pop(len(ftype.results))
            ops.append([op, len(ftype.results)])
            ctrl[-1].unreachable = True
            h = ctrl[-1].h_base
        elif op == 0x10:  # call
            fi = r.u32()
            if fi >= len(m.imports) + len(m.func_type_idx):
                raise WasmError("call index out of range")
            ft = m.func_type(fi)
            pop(len(ft.params))
            push(len(ft.results))
            ops.append([op, fi])
        elif op == 0x11:  # call_indirect
            ti = r.u32()
            if ti >= len(m.types):
                raise WasmError("call_indirect type out of range")
            if r.byte() != 0x00:
                raise WasmError("call_indirect reserved byte")
            ft = m.types[ti]
            pop(1 + len(ft.params))
            push(len(ft.results))
            ops.append([op, ti])
        elif op == 0x41:  # i32.const
            push(1)
            ops.append([op, r.s_leb(32) & _M32])
        elif op == 0x42:  # i64.const
            push(1)
            ops.append([op, r.s_leb(64) & _M64])
        elif op in (0x43, 0x44):
            raise WasmError("floating point is not supported")
        elif op in (0x20, 0x21, 0x22):  # local.get/set/tee
            li = r.u32()
            if li >= len(locals_):
                raise WasmError("local index out of range")
            if op == 0x20:
                push(1)
            elif op == 0x21:
                pop(1)
            else:
                pop(1)
                push(1)
            ops.append([op, li])
        elif op in (0x23, 0x24):  # global.get/set
            gi = r.u32()
            if gi >= len(m.globals):
                raise WasmError("global index out of range")
            if op == 0x24:
                if not m.globals[gi][1]:
                    raise WasmError("global.set on immutable global")
                pop(1)
            else:
                push(1)
            ops.append([op, gi])
        elif 0x28 <= op <= 0x3E:  # loads / stores
            if op in (0x2A, 0x2B, 0x38, 0x39):
                raise WasmError("floating point is not supported")
            r.u32()  # alignment hint: ignored
            off = r.u32()
            if op <= 0x35:
                pop(1)
                push(1)
            else:
                pop(2)
            ops.append([op, off])
        elif op == 0x3F:  # memory.size
            if r.byte() != 0x00:
                raise WasmError("memory index must be 0")
            push(1)
            ops.append([op, None])
        elif op == 0x40:  # memory.grow
            if r.byte() != 0x00:
                raise WasmError("memory index must be 0")
            pop(1)
            push(1)
            ops.append([op, None])
        elif op == 0x00:  # unreachable
            ops.append([op, None])
            ctrl[-1].unreachable = True
            h = ctrl[-1].h_base
        elif op == 0x01:  # nop
            ops.append([op, None])
        elif op == 0x1A:  # drop
            pop(1)
            ops.append([op, None])
        elif op == 0x1B:  # select
            pop(3)
            push(1)
            ops.append([op, None])
        elif op in _NUMERIC_POPS:
            pop(_NUMERIC_POPS[op])
            push(1)
            ops.append([op, None])
        elif op == 0xFC:
            # bulk-memory prefix (LLVM emits memory.copy/fill for
            # memcpy/memset by default; soroban's wasmi enables them)
            sub = r.u32()
            if sub == 10:  # memory.copy: dst, src memory indices
                if r.byte() != 0 or r.byte() != 0:
                    raise WasmError("memory.copy: bad memory index")
            elif sub == 11:  # memory.fill: memory index
                if r.byte() != 0:
                    raise WasmError("memory.fill: bad memory index")
            else:
                raise WasmError(f"unsupported 0xFC subop {sub}")
            pop(3)
            ops.append([op, sub])
        else:
            raise WasmError(f"unsupported opcode 0x{op:02x}")

    return _Func(
        ftype, locals_,
        [(o[0], tuple(o[1])) if isinstance(o[1], list) and
         o[0] in (0x0C, 0x0D) else (o[0], o[1]) for o in ops])


# ---------------------------------------------------------------------------
# Instance + interpreter
# ---------------------------------------------------------------------------

class WasmInstance:
    """An instantiated module: memory, globals, table, host imports.

    ``imports`` maps (module, name) -> callable(instance, *args) ->
    int|None. ``charge`` is called with an instruction count to meter
    execution (maps onto the soroban budget's cpu dimension);
    ``mem_charge`` with allocated linear-memory bytes.
    """

    def __init__(self, module: WasmModule,
                 imports: Dict[Tuple[str, str], Callable],
                 charge: Callable[[int], None],
                 mem_charge: Optional[Callable[[int], None]] = None):
        self.m = module
        self.charge = charge
        self.host_fns: List[Callable] = []
        for mod, name, ftype in module.imports:
            fn = imports.get((mod, name))
            if fn is None:
                raise WasmError(f"unresolved import {mod}.{name}")
            check_import_binding(mod, name, ftype, fn)
            self.host_fns.append(fn)
        self.memory = bytearray(module.mem_min * PAGE_SIZE)
        self.mem_charge = mem_charge
        if mem_charge and self.memory:
            mem_charge(len(self.memory))
        self.globals = [g[2] for g in module.globals]
        self.table: List[Optional[int]] = [None] * module.table_min
        for off, idxs in module.elements:
            if off < 0 or off + len(idxs) > len(self.table):
                raise Trap("element segment out of bounds")
            for i, fi in enumerate(idxs):
                self.table[off + i] = fi
        for off, data in module.data:
            if off < 0 or off + len(data) > len(self.memory):
                raise Trap("data segment out of bounds")
            self.memory[off:off + len(data)] = data
        self.depth = 0
        if module.start is not None:
            self._call_function(module.start, [])

    # -------------- public API --------------

    def invoke(self, name: str, args: List[int]) -> Optional[int]:
        exp = self.m.exports.get(name)
        if exp is None or exp[0] != "func":
            raise Trap(f"no exported function {name!r}")
        ft = self.m.func_type(exp[1])
        if len(args) != len(ft.params):
            raise Trap(f"{name!r} expects {len(ft.params)} args")
        return self._call_function(exp[1], list(args))

    def exports_function(self, name: str) -> bool:
        e = self.m.exports.get(name)
        return e is not None and e[0] == "func"

    # -------------- memory helpers (host fns use these) --------------

    def mem_read(self, ptr: int, n: int) -> bytes:
        if ptr < 0 or n < 0 or ptr + n > len(self.memory):
            raise Trap("memory access out of bounds")
        return bytes(self.memory[ptr:ptr + n])

    def mem_write(self, ptr: int, data: bytes):
        if ptr < 0 or ptr + len(data) > len(self.memory):
            raise Trap("memory access out of bounds")
        self.memory[ptr:ptr + len(data)] = data

    # -------------- execution --------------

    def _call_function(self, func_idx: int, args: List[int]):
        ni = len(self.m.imports)
        if func_idx < ni:
            self.charge(HOST_CALL_COST)
            return self.host_fns[func_idx](self, *args)
        func = self.m.funcs[func_idx - ni]
        if self.depth >= MAX_CALL_FRAMES:
            raise Trap("call stack exhausted")
        self.depth += 1
        try:
            return self._run(func, args)
        finally:
            self.depth -= 1

    def _run(self, func: _Func, args: List[int]):
        m = self.m
        locals_ = args + [0] * (len(func.locals) - len(args))
        stack: List[int] = []
        ops = func.ops
        n_ops = len(ops)
        pc = 0
        charge = self.charge
        # charge in chunks: a Python call per op would cost more than
        # the op itself; 64-op granularity keeps budget traps tight
        tick = 0
        while pc < n_ops:
            op, imm = ops[pc]
            pc += 1
            tick += 1
            if tick >= 64:
                charge(tick)
                tick = 0
            if op == 0x41 or op == 0x42:      # i32/i64.const
                stack.append(imm)
            elif op == 0x20:                  # local.get
                stack.append(locals_[imm])
            elif op == 0x21:                  # local.set
                locals_[imm] = stack.pop()
            elif op == 0x22:                  # local.tee
                locals_[imm] = stack[-1]
            elif op == 0x0B or op == 0x01 or op == 0x02 or op == 0x03:
                pass                          # end / nop / block / loop
            elif op == 0x04:                  # if (imm = false target)
                if not stack.pop() & _M32:
                    pc = imm
            elif op == 0x05:                  # else: skip the else arm
                pc = imm
            elif op == 0x0C:                  # br
                target, arity, land = imm
                if arity:
                    if len(stack) != land:
                        stack[land - arity:] = stack[-arity:]
                elif len(stack) > land:
                    del stack[land:]
                pc = target
            elif op == 0x0D:                  # br_if
                if stack.pop() & _M32:
                    target, arity, land = imm
                    if arity:
                        if len(stack) != land:
                            stack[land - arity:] = stack[-arity:]
                    elif len(stack) > land:
                        del stack[land:]
                    pc = target
            elif op == 0x0E:                  # br_table
                i = stack.pop() & _M32
                slot = imm[i] if i < len(imm) - 1 else imm[-1]
                target, arity, land = slot
                if arity:
                    if len(stack) != land:
                        stack[land - arity:] = stack[-arity:]
                elif len(stack) > land:
                    del stack[land:]
                pc = target
            elif op == 0x0F:                  # return
                charge(tick)
                return stack.pop() if imm else None
            elif op == 0x10:                  # call
                # flush before the crossing so the budget is current
                # when the callee (or a host fn) charges — keeps the
                # charge stream identical to the native engine's
                charge(tick)
                tick = 0
                ft = m.func_type(imm)
                n = len(ft.params)
                if n:
                    call_args = stack[len(stack) - n:]
                    del stack[len(stack) - n:]
                else:
                    call_args = []
                rv = self._call_function(imm, call_args)
                if ft.results:
                    stack.append((rv if rv is not None else 0) &
                                 (_M32 if ft.results[0] == I32 else _M64))
            elif op == 0x11:                  # call_indirect
                charge(tick)
                tick = 0
                ti = stack.pop() & _M32
                if ti >= len(self.table) or self.table[ti] is None:
                    raise Trap("uninitialized table element")
                fi = self.table[ti]
                ft = m.types[imm]
                if m.func_type(fi) != ft:
                    raise Trap("indirect call type mismatch")
                n = len(ft.params)
                if n:
                    call_args = stack[len(stack) - n:]
                    del stack[len(stack) - n:]
                else:
                    call_args = []
                rv = self._call_function(fi, call_args)
                if ft.results:
                    stack.append((rv if rv is not None else 0) &
                                 (_M32 if ft.results[0] == I32 else _M64))
            elif op == 0x1A:                  # drop
                stack.pop()
            elif op == 0x1B:                  # select
                c = stack.pop()
                b, a = stack.pop(), stack.pop()
                stack.append(a if c & _M32 else b)
            elif op == 0x23:                  # global.get
                stack.append(self.globals[imm])
            elif op == 0x24:                  # global.set
                self.globals[imm] = stack.pop()
            elif 0x28 <= op <= 0x35:          # loads
                addr = (stack.pop() & _M32) + imm
                signed, size, mask = _LOAD_TABLE[op]
                mem = self.memory
                if addr + size > len(mem):
                    raise Trap("memory access out of bounds")
                v = int.from_bytes(mem[addr:addr + size], "little",
                                   signed=signed)
                stack.append(v & mask)
            elif 0x36 <= op <= 0x3E:          # stores
                val = stack.pop()
                addr = (stack.pop() & _M32) + imm
                size = _STORE_TABLE[op]
                mem = self.memory
                if addr + size > len(mem):
                    raise Trap("memory access out of bounds")
                mem[addr:addr + size] = \
                    (val & ((1 << (8 * size)) - 1)).to_bytes(size,
                                                             "little")
            elif op == 0x3F:                  # memory.size
                stack.append(len(self.memory) // PAGE_SIZE)
            elif op == 0x40:                  # memory.grow
                charge(tick)
                tick = 0
                stack.append(self._grow(stack.pop() & _M32))
            elif op == 0x00:                  # unreachable
                raise Trap("unreachable executed")
            elif op == 0xFC:                  # memory.copy / fill
                n = stack.pop() & _M32
                s_or_v = stack.pop()
                d = stack.pop() & _M32
                mem = self.memory
                if imm == 10:
                    s = s_or_v & _M32
                    if d + n > len(mem) or s + n > len(mem):
                        raise Trap("memory access out of bounds")
                    mem[d:d + n] = mem[s:s + n]
                else:
                    if d + n > len(mem):
                        raise Trap("memory access out of bounds")
                    mem[d:d + n] = bytes([s_or_v & 0xFF]) * n
                # bytes moved are metered work (same n//8 surcharge as
                # the native engine — the differential contract)
                tick += n >> 3
                if tick >= 64:
                    charge(tick)
                    tick = 0
            else:
                stack.append(_numeric(op, stack))
        charge(tick)
        if func.type.results:
            return stack.pop()
        return None

    def _grow(self, delta: int) -> int:
        cur = len(self.memory) // PAGE_SIZE
        limit = self.m.mem_max if self.m.mem_max is not None else MAX_PAGES
        if cur + delta > min(limit, MAX_PAGES):
            return 0xFFFFFFFF  # -1: grow refused
        if delta:
            if self.mem_charge:
                self.mem_charge(delta * PAGE_SIZE)
            self.memory.extend(bytes(delta * PAGE_SIZE))
        return cur


HOST_CALL_COST = 50  # metered instructions per host-function crossing

# op -> (signed, byte_size, result_mask)
_LOAD_TABLE = {
    0x28: (False, 4, _M32), 0x29: (False, 8, _M64),
    0x2C: (True, 1, _M32), 0x2D: (False, 1, _M32),
    0x2E: (True, 2, _M32), 0x2F: (False, 2, _M32),
    0x30: (True, 1, _M64), 0x31: (False, 1, _M64),
    0x32: (True, 2, _M64), 0x33: (False, 2, _M64),
    0x34: (True, 4, _M64), 0x35: (False, 4, _M64),
}
_STORE_TABLE = {0x36: 4, 0x37: 8, 0x3A: 1, 0x3B: 2, 0x3C: 1,
                0x3D: 2, 0x3E: 4}


def _numeric(op: int, stack: List[int]) -> int:
    """All pure value-producing numeric ops (comparisons, arithmetic,
    conversions). Stack values are kept in UNSIGNED canonical form;
    signed ops reinterpret on entry."""
    # --- i32 comparisons ---
    if op == 0x45:  # i32.eqz
        return 1 if stack.pop() & _M32 == 0 else 0
    if 0x46 <= op <= 0x4F:
        b, a = stack.pop() & _M32, stack.pop() & _M32
        sa, sb = _s32(a), _s32(b)
        return 1 if {
            0x46: a == b, 0x47: a != b, 0x48: sa < sb, 0x49: a < b,
            0x4A: sa > sb, 0x4B: a > b, 0x4C: sa <= sb, 0x4D: a <= b,
            0x4E: sa >= sb, 0x4F: a >= b}[op] else 0
    if op == 0x50:  # i64.eqz
        return 1 if stack.pop() & _M64 == 0 else 0
    if 0x51 <= op <= 0x5A:
        b, a = stack.pop() & _M64, stack.pop() & _M64
        sa, sb = _s64(a), _s64(b)
        return 1 if {
            0x51: a == b, 0x52: a != b, 0x53: sa < sb, 0x54: a < b,
            0x55: sa > sb, 0x56: a > b, 0x57: sa <= sb, 0x58: a <= b,
            0x59: sa >= sb, 0x5A: a >= b}[op] else 0
    # --- i32 arithmetic ---
    if 0x67 <= op <= 0x69:
        a = stack.pop() & _M32
        if op == 0x67:
            return _clz(a, 32)
        if op == 0x68:
            return _ctz(a, 32)
        return bin(a).count("1")
    if 0x6A <= op <= 0x78:
        b, a = stack.pop() & _M32, stack.pop() & _M32
        if op == 0x6A:
            return (a + b) & _M32
        if op == 0x6B:
            return (a - b) & _M32
        if op == 0x6C:
            return (a * b) & _M32
        if op == 0x6D:
            return _div_s(_s32(a), _s32(b), 32) & _M32
        if op == 0x6E:
            if b == 0:
                raise Trap("integer divide by zero")
            return a // b
        if op == 0x6F:
            return _rem_s(_s32(a), _s32(b)) & _M32
        if op == 0x70:
            if b == 0:
                raise Trap("integer divide by zero")
            return a % b
        if op == 0x71:
            return a & b
        if op == 0x72:
            return a | b
        if op == 0x73:
            return a ^ b
        k = b & 31
        if op == 0x74:
            return (a << k) & _M32
        if op == 0x75:
            return (_s32(a) >> k) & _M32
        if op == 0x76:
            return a >> k
        if op == 0x77:
            return ((a << k) | (a >> (32 - k))) & _M32 if k else a
        return ((a >> k) | (a << (32 - k))) & _M32 if k else a
    # --- i64 arithmetic ---
    if 0x79 <= op <= 0x7B:
        a = stack.pop() & _M64
        if op == 0x79:
            return _clz(a, 64)
        if op == 0x7A:
            return _ctz(a, 64)
        return bin(a).count("1")
    if 0x7C <= op <= 0x8A:
        b, a = stack.pop() & _M64, stack.pop() & _M64
        if op == 0x7C:
            return (a + b) & _M64
        if op == 0x7D:
            return (a - b) & _M64
        if op == 0x7E:
            return (a * b) & _M64
        if op == 0x7F:
            return _div_s(_s64(a), _s64(b), 64) & _M64
        if op == 0x80:
            if b == 0:
                raise Trap("integer divide by zero")
            return a // b
        if op == 0x81:
            return _rem_s(_s64(a), _s64(b)) & _M64
        if op == 0x82:
            if b == 0:
                raise Trap("integer divide by zero")
            return a % b
        if op == 0x83:
            return a & b
        if op == 0x84:
            return a | b
        if op == 0x85:
            return a ^ b
        k = b & 63
        if op == 0x86:
            return (a << k) & _M64
        if op == 0x87:
            return (_s64(a) >> k) & _M64
        if op == 0x88:
            return a >> k
        if op == 0x89:
            return ((a << k) | (a >> (64 - k))) & _M64 if k else a
        return ((a >> k) | (a << (64 - k))) & _M64 if k else a
    # --- conversions ---
    if op == 0xA7:  # i32.wrap_i64
        return stack.pop() & _M32
    if op == 0xAC:  # i64.extend_i32_s
        return _s32(stack.pop() & _M32) & _M64
    if op == 0xAD:  # i64.extend_i32_u
        return stack.pop() & _M32
    # --- sign extension (core post-MVP, emitted by LLVM by default) ---
    if op == 0xC0:  # i32.extend8_s
        v = stack.pop() & 0xFF
        return (v - 0x100 if v & 0x80 else v) & _M32
    if op == 0xC1:  # i32.extend16_s
        v = stack.pop() & 0xFFFF
        return (v - 0x10000 if v & 0x8000 else v) & _M32
    if op == 0xC2:  # i64.extend8_s
        v = stack.pop() & 0xFF
        return (v - 0x100 if v & 0x80 else v) & _M64
    if op == 0xC3:  # i64.extend16_s
        v = stack.pop() & 0xFFFF
        return (v - 0x10000 if v & 0x8000 else v) & _M64
    if op == 0xC4:  # i64.extend32_s
        return _s32(stack.pop() & _M32) & _M64
    raise Trap(f"unsupported opcode 0x{op:02x}")
