"""In-process wasm assembler: build real wasm-MVP binaries from Python
(no wat toolchain ships in this environment). Used by tests, the load
generator, and docs examples to produce genuinely compiled contract
modules for the wasm VM (``soroban/wasm.py``) — the same role the
reference's checked-in ``.wasm`` fixtures play for soroban-env-host
(``src/testdata/soroban/*.wasm``).

Minimal by design: emit exactly the integer-MVP subset the VM executes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = ["Code", "ModuleBuilder", "I32", "I64", "leb_u", "leb_s"]

I32, I64 = 0x7F, 0x7E


def leb_u(v: int) -> bytes:
    if v < 0:
        raise ValueError("unsigned LEB of negative")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def leb_s(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        done = (v == 0 and not b & 0x40) or (v == -1 and b & 0x40)
        out.append(b if done else b | 0x80)
        if done:
            return bytes(out)


class Code:
    """Instruction emitter for one function body. Tracks block depth so
    ``ModuleBuilder.add_func`` knows whether the body already carries
    its terminating ``end`` (byte inspection can't tell: a trailing
    LEB byte 0x0B, e.g. ``i64_const(11)``, looks identical)."""

    def __init__(self):
        self.b = bytearray()
        self._depth = 0
        self._ended = False

    def raw(self, *bs: int) -> "Code":
        self.b.extend(bs)
        return self

    # control
    def unreachable(self):
        return self.raw(0x00)

    def nop(self):
        return self.raw(0x01)

    def block(self, bt: int = 0x40):
        self._depth += 1
        return self.raw(0x02, bt)

    def loop(self, bt: int = 0x40):
        self._depth += 1
        return self.raw(0x03, bt)

    def if_(self, bt: int = 0x40):
        self._depth += 1
        return self.raw(0x04, bt)

    def else_(self):
        return self.raw(0x05)

    def end(self):
        if self._depth:
            self._depth -= 1
        else:
            self._ended = True
        return self.raw(0x0B)

    def br(self, depth: int):
        self.b.append(0x0C)
        self.b.extend(leb_u(depth))
        return self

    def br_if(self, depth: int):
        self.b.append(0x0D)
        self.b.extend(leb_u(depth))
        return self

    def br_table(self, depths: Sequence[int], default: int):
        self.b.append(0x0E)
        self.b.extend(leb_u(len(depths)))
        for d in depths:
            self.b.extend(leb_u(d))
        self.b.extend(leb_u(default))
        return self

    def return_(self):
        return self.raw(0x0F)

    def call(self, func_idx: int):
        self.b.append(0x10)
        self.b.extend(leb_u(func_idx))
        return self

    def call_indirect(self, type_idx: int):
        self.b.append(0x11)
        self.b.extend(leb_u(type_idx))
        self.b.append(0x00)
        return self

    # parametric / variable
    def drop(self):
        return self.raw(0x1A)

    def select(self):
        return self.raw(0x1B)

    def local_get(self, i: int):
        self.b.append(0x20)
        self.b.extend(leb_u(i))
        return self

    def local_set(self, i: int):
        self.b.append(0x21)
        self.b.extend(leb_u(i))
        return self

    def local_tee(self, i: int):
        self.b.append(0x22)
        self.b.extend(leb_u(i))
        return self

    def global_get(self, i: int):
        self.b.append(0x23)
        self.b.extend(leb_u(i))
        return self

    def global_set(self, i: int):
        self.b.append(0x24)
        self.b.extend(leb_u(i))
        return self

    # memory
    def _mem(self, op: int, align: int, offset: int):
        self.b.append(op)
        self.b.extend(leb_u(align))
        self.b.extend(leb_u(offset))
        return self

    def i32_load(self, offset: int = 0, align: int = 2):
        return self._mem(0x28, align, offset)

    def i64_load(self, offset: int = 0, align: int = 3):
        return self._mem(0x29, align, offset)

    def i32_load8_u(self, offset: int = 0):
        return self._mem(0x2D, 0, offset)

    def i64_load8_u(self, offset: int = 0):
        return self._mem(0x31, 0, offset)

    def i32_store(self, offset: int = 0, align: int = 2):
        return self._mem(0x36, align, offset)

    def i64_store(self, offset: int = 0, align: int = 3):
        return self._mem(0x37, align, offset)

    def i32_store8(self, offset: int = 0):
        return self._mem(0x3A, 0, offset)

    def memory_size(self):
        return self.raw(0x3F, 0x00)

    def memory_grow(self):
        return self.raw(0x40, 0x00)

    def memory_copy(self):
        """Bulk memory: [dst, src, n] -> [] (0xFC 10)."""
        return self.raw(0xFC, 0x0A, 0x00, 0x00)

    def memory_fill(self):
        """Bulk memory: [dst, val, n] -> [] (0xFC 11)."""
        return self.raw(0xFC, 0x0B, 0x00)

    # consts
    def i32_const(self, v: int):
        self.b.append(0x41)
        self.b.extend(leb_s(v if v < 1 << 31 else v - (1 << 32)))
        return self

    def i64_const(self, v: int):
        self.b.append(0x42)
        self.b.extend(leb_s(v if v < 1 << 63 else v - (1 << 64)))
        return self

    def __getattr__(self, name: str):
        """Opcode-by-name fallback: ``c.i64_add()``, ``c.i32_eqz()``,
        ``c.i64_shr_u()`` etc. map straight to their opcodes."""
        op = _BY_NAME.get(name)
        if op is None:
            raise AttributeError(name)

        def emit():
            self.b.append(op)
            return self
        return emit


_BY_NAME = {
    "i32_eqz": 0x45, "i32_eq": 0x46, "i32_ne": 0x47, "i32_lt_s": 0x48,
    "i32_lt_u": 0x49, "i32_gt_s": 0x4A, "i32_gt_u": 0x4B,
    "i32_le_s": 0x4C, "i32_le_u": 0x4D, "i32_ge_s": 0x4E,
    "i32_ge_u": 0x4F,
    "i64_eqz": 0x50, "i64_eq": 0x51, "i64_ne": 0x52, "i64_lt_s": 0x53,
    "i64_lt_u": 0x54, "i64_gt_s": 0x55, "i64_gt_u": 0x56,
    "i64_le_s": 0x57, "i64_le_u": 0x58, "i64_ge_s": 0x59,
    "i64_ge_u": 0x5A,
    "i32_clz": 0x67, "i32_ctz": 0x68, "i32_popcnt": 0x69,
    "i32_add": 0x6A, "i32_sub": 0x6B, "i32_mul": 0x6C,
    "i32_div_s": 0x6D, "i32_div_u": 0x6E, "i32_rem_s": 0x6F,
    "i32_rem_u": 0x70, "i32_and": 0x71, "i32_or": 0x72,
    "i32_xor": 0x73, "i32_shl": 0x74, "i32_shr_s": 0x75,
    "i32_shr_u": 0x76, "i32_rotl": 0x77, "i32_rotr": 0x78,
    "i64_clz": 0x79, "i64_ctz": 0x7A, "i64_popcnt": 0x7B,
    "i64_add": 0x7C, "i64_sub": 0x7D, "i64_mul": 0x7E,
    "i64_div_s": 0x7F, "i64_div_u": 0x80, "i64_rem_s": 0x81,
    "i64_rem_u": 0x82, "i64_and": 0x83, "i64_or": 0x84,
    "i64_xor": 0x85, "i64_shl": 0x86, "i64_shr_s": 0x87,
    "i64_shr_u": 0x88, "i64_rotl": 0x89, "i64_rotr": 0x8A,
    "i32_wrap_i64": 0xA7, "i64_extend_i32_s": 0xAC,
    "i64_extend_i32_u": 0xAD,
    "i32_extend8_s": 0xC0, "i32_extend16_s": 0xC1,
    "i64_extend8_s": 0xC2, "i64_extend16_s": 0xC3,
    "i64_extend32_s": 0xC4,
}


class ModuleBuilder:
    def __init__(self):
        self._types: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        self._imports: List[Tuple[str, str, int]] = []
        self._funcs: List[Tuple[int, List[int], bytes]] = []
        self._mem: Optional[Tuple[int, Optional[int]]] = None
        self._globals: List[Tuple[int, bool, int]] = []
        self._exports: List[Tuple[str, int, int]] = []
        self._table_min = 0
        self._elems: List[Tuple[int, List[int]]] = []
        self._data: List[Tuple[int, bytes]] = []
        self._start: Optional[int] = None

    # -------- declarations --------

    def type_idx(self, params: Sequence[int],
                 results: Sequence[int]) -> int:
        key = (tuple(params), tuple(results))
        if key in self._types:
            return self._types.index(key)
        self._types.append(key)
        return len(self._types) - 1

    def import_func(self, mod: str, name: str, params: Sequence[int],
                    results: Sequence[int]) -> int:
        if self._funcs:
            raise ValueError("declare imports before functions")
        self._imports.append((mod, name, self.type_idx(params, results)))
        return len(self._imports) - 1

    def add_func(self, params: Sequence[int], results: Sequence[int],
                 locals_: Sequence[int], code: Code,
                 export: Optional[str] = None) -> int:
        ti = self.type_idx(params, results)
        body = bytes(code.b)
        if not code._ended:
            body += b"\x0B"
        self._funcs.append((ti, list(locals_), body))
        idx = len(self._imports) + len(self._funcs) - 1
        if export is not None:
            self._exports.append((export, 0, idx))
        return idx

    def add_memory(self, min_pages: int, max_pages: Optional[int] = None,
                   export: Optional[str] = None):
        self._mem = (min_pages, max_pages)
        if export is not None:
            self._exports.append((export, 2, 0))
        return self

    def add_global(self, valtype: int, mutable: bool, init: int) -> int:
        self._globals.append((valtype, mutable, init))
        return len(self._globals) - 1

    def add_table(self, min_size: int):
        self._table_min = min_size
        return self

    def add_elem(self, offset: int, func_idxs: Sequence[int]):
        self._elems.append((offset, list(func_idxs)))
        return self

    def add_data(self, offset: int, data: bytes):
        self._data.append((offset, data))
        return self

    def set_start(self, func_idx: int):
        self._start = func_idx
        return self

    def export(self, name: str, kind: int, idx: int):
        self._exports.append((name, kind, idx))
        return self

    # -------- emission --------

    @staticmethod
    def _section(sec_id: int, payload: bytes) -> bytes:
        return bytes([sec_id]) + leb_u(len(payload)) + payload

    @staticmethod
    def _vec(items: List[bytes]) -> bytes:
        return leb_u(len(items)) + b"".join(items)

    @staticmethod
    def _name(s: str) -> bytes:
        raw = s.encode()
        return leb_u(len(raw)) + raw

    def build(self) -> bytes:
        out = bytearray(b"\x00asm\x01\x00\x00\x00")
        if self._types:
            out += self._section(1, self._vec([
                b"\x60" + leb_u(len(p)) + bytes(p) +
                leb_u(len(r)) + bytes(r)
                for p, r in self._types]))
        if self._imports:
            out += self._section(2, self._vec([
                self._name(m) + self._name(n) + b"\x00" + leb_u(ti)
                for m, n, ti in self._imports]))
        if self._funcs:
            out += self._section(3, self._vec(
                [leb_u(ti) for ti, _, _ in self._funcs]))
        if self._table_min:
            out += self._section(4, self._vec(
                [b"\x70\x00" + leb_u(self._table_min)]))
        if self._mem is not None:
            mn, mx = self._mem
            lim = (b"\x01" + leb_u(mn) + leb_u(mx)
                   if mx is not None else b"\x00" + leb_u(mn))
            out += self._section(5, self._vec([lim]))
        if self._globals:
            out += self._section(6, self._vec([
                bytes([vt, 1 if mut else 0]) +
                (b"\x41" + leb_s(init) if vt == I32
                 else b"\x42" + leb_s(init)) + b"\x0B"
                for vt, mut, init in self._globals]))
        if self._exports:
            out += self._section(7, self._vec([
                self._name(n) + bytes([k]) + leb_u(i)
                for n, k, i in self._exports]))
        if self._start is not None:
            out += self._section(8, leb_u(self._start))
        if self._elems:
            out += self._section(9, self._vec([
                b"\x00\x41" + leb_s(off) + b"\x0B" +
                self._vec([leb_u(fi) for fi in idxs])
                for off, idxs in self._elems]))
        if self._funcs:
            bodies = []
            for _, locals_, body in self._funcs:
                groups = []
                i = 0
                while i < len(locals_):
                    j = i
                    while j < len(locals_) and locals_[j] == locals_[i]:
                        j += 1
                    groups.append(leb_u(j - i) + bytes([locals_[i]]))
                    i = j
                inner = self._vec(groups) + body
                bodies.append(leb_u(len(inner)) + inner)
            out += self._section(10, self._vec(bodies))
        if self._data:
            out += self._section(11, self._vec([
                b"\x00\x41" + leb_s(off) + b"\x0B" +
                leb_u(len(d)) + d
                for off, d in self._data]))
        return bytes(out)
