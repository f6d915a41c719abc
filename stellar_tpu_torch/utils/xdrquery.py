"""xdrquery-lite: field-path filters over decoded XDR values (reference
``src/util/xdrquery`` — the mini DSL behind ``dump-ledger --filter``).

Grammar (scoped): ``<path> <op> <value>`` joined by ``&&``; ops are
``== != < <= > >=``. A path walks struct fields dot-separated; union
values are transparent (a segment applies to the active arm's payload),
and the special leading segment ``type`` resolves an entry's
LedgerEntryType name. Values: integers, single-quoted strings, or hex
byte strings.
"""

from __future__ import annotations

import re
from typing import Any, Callable, List

__all__ = ["compile_query"]

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_TERM = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_.]*)\s*(==|!=|<=|>=|<|>)\s*(.+?)\s*$")


def _value_for(raw: str, got):
    """Interpret the literal in the light of what it compares against
    (a digit string can be an int or hex bytes)."""
    raw = raw.strip()
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1]
    if isinstance(got, (bytes, bytearray)):
        h = raw.removeprefix("0x")
        if re.fullmatch(r"[0-9a-fA-F]+", h) and len(h) % 2 == 0:
            return bytes.fromhex(h)
        return raw.encode()
    if re.fullmatch(r"-?[0-9]+", raw):
        return int(raw)
    return raw


def _walk(obj: Any, segments: List[str]):
    """Resolve a dotted path; unions are transparent."""
    for seg in segments:
        # unwrap union values until a struct with the field appears
        for _ in range(4):
            if hasattr(obj, seg):
                break
            if hasattr(obj, "value"):
                obj = obj.value
            else:
                raise AttributeError(seg)
        obj = getattr(obj, seg)
    # final unwrap for comparisons against payloads
    return obj


def compile_query(query: str) -> Callable[[Any], bool]:
    """Compile ``query`` into a predicate over LedgerEntry values."""
    terms = []
    for part in query.split("&&"):
        m = _TERM.match(part)
        if m is None:
            raise ValueError(f"bad query term: {part!r}")
        path, op, raw = m.groups()
        terms.append((path.split("."), _OPS[op], raw))

    def predicate(entry) -> bool:
        for segments, op, raw in terms:
            try:
                if segments[0] == "type":
                    from stellar_tpu_torch.xdr.types import LedgerEntryType
                    got = LedgerEntryType.name_of(entry.data.arm)
                else:
                    got = _walk(entry, segments)
                    # unwrap simple wrappers (Union.Value payloads)
                    for _ in range(2):
                        if isinstance(got, (int, str, bytes, bytearray,
                                            bool)):
                            break
                        inner = getattr(got, "value", None)
                        if inner is None:
                            break
                        got = inner
                want = _value_for(raw, got)
                if isinstance(got, (bytes, bytearray)) and \
                        isinstance(want, str):
                    got = got.decode("utf-8", "replace")
                if not op(got, want):
                    return False
            except Exception:
                return False
        return True

    return predicate
