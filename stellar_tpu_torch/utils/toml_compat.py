"""Minimal TOML parser used when stdlib ``tomllib`` is unavailable
(Python < 3.11 — this container ships 3.10 and nothing may be installed).

Covers exactly the subset the node config format uses (see
``docs/stellar_tpu_example.cfg`` and ``Config.from_toml``):

* comments, blank lines
* ``key = value`` with bare or quoted keys
* basic/literal strings, integers, floats, booleans
* arrays, including multi-line arrays and trailing commas
* ``[table]`` / ``[dotted.table]`` headers
* ``[[array.of.tables]]`` headers

Deliberately NOT covered (the config never uses them, and a strict
error beats silent misparsing): datetimes, inline tables, multi-line
strings, dotted keys on the left-hand side, exotic escapes.

API matches the two entry points ``Config.from_toml`` needs:
``load(binary_fp)`` and ``loads(text)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["load", "loads", "TOMLDecodeError"]


class TOMLDecodeError(ValueError):
    pass


def load(fp) -> Dict[str, Any]:
    data = fp.read()
    if isinstance(data, bytes):
        data = data.decode("utf-8")
    return loads(data)


def loads(text: str) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    current = root
    declared = set()  # [table] headers seen, for tomllib-equal strictness
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise TOMLDecodeError(f"bad table-array header: {line}")
            parent, leaf = _walk(root, line[2:-2].strip())
            arr = parent.setdefault(leaf, [])
            if not isinstance(arr, list):
                raise TOMLDecodeError(f"{leaf} is not a table array")
            current = {}
            arr.append(current)
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise TOMLDecodeError(f"bad table header: {line}")
            name = line[1:-1].strip()
            if name in declared:
                # stdlib tomllib rejects re-declared tables; silently
                # merging here would make config validity depend on the
                # Python version
                raise TOMLDecodeError(f"cannot declare table twice: {name}")
            declared.add(name)
            parent, leaf = _walk(root, name)
            current = parent.setdefault(leaf, {})
            if not isinstance(current, dict):
                raise TOMLDecodeError(f"{leaf} is not a table")
            continue
        if "=" not in line:
            raise TOMLDecodeError(f"expected key = value: {line}")
        key, _, rest = line.partition("=")
        key = _parse_key(key.strip())
        rest = rest.strip()
        # multi-line arrays: keep consuming lines until brackets balance
        while _open_brackets(rest) > 0:
            if i >= len(lines):
                raise TOMLDecodeError(f"unterminated array for key {key}")
            rest += " " + _strip_comment(lines[i]).strip()
            i += 1
        value, pos = _parse_value(rest, 0)
        if rest[pos:].strip():
            raise TOMLDecodeError(
                f"trailing garbage after value for {key}: {rest[pos:]!r}")
        if key in current:
            raise TOMLDecodeError(f"duplicate key {key}")
        current[key] = value
    return root


def _walk(root: Dict[str, Any], dotted: str) -> Tuple[Dict[str, Any], str]:
    """Resolve a dotted table path, returning (parent_table, leaf_name).
    Intermediate array-of-tables segments resolve to their last element."""
    parts = [p.strip() for p in dotted.split(".")]
    if not parts or any(not p for p in parts):
        raise TOMLDecodeError(f"bad table name: {dotted}")
    node = root
    for part in parts[:-1]:
        part = _parse_key(part)
        nxt = node.setdefault(part, {})
        if isinstance(nxt, list):
            if not nxt:
                raise TOMLDecodeError(f"empty table array {part}")
            nxt = nxt[-1]
        if not isinstance(nxt, dict):
            raise TOMLDecodeError(f"{part} is not a table")
        node = nxt
    return node, _parse_key(parts[-1])


def _parse_key(key: str) -> str:
    if len(key) >= 2 and key[0] == key[-1] and key[0] in "\"'":
        return key[1:-1]
    if not key or not all(c.isalnum() or c in "-_" for c in key):
        raise TOMLDecodeError(f"bad key: {key!r}")
    return key


def _strip_comment(line: str) -> str:
    """Drop a # comment, ignoring # inside strings (backslash escapes
    only count inside basic strings — literal '...' strings have none)."""
    quote = None
    idx = 0
    while idx < len(line):
        c = line[idx]
        if quote is None:
            if c in "\"'":
                quote = c
            elif c == "#":
                return line[:idx]
        elif quote == '"' and c == "\\":
            idx += 1  # skip the escaped character (e.g. \" or \\)
        elif c == quote:
            quote = None
        idx += 1
    return line


def _open_brackets(s: str) -> int:
    depth = 0
    quote = None
    for c in s:
        if quote is None:
            if c in "\"'":
                quote = c
            elif c == "[":
                depth += 1
            elif c == "]":
                depth -= 1
        elif c == quote:
            quote = None
    return depth


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
            "b": "\b", "f": "\f"}


def _parse_value(s: str, pos: int) -> Tuple[Any, int]:
    while pos < len(s) and s[pos].isspace():
        pos += 1
    if pos >= len(s):
        raise TOMLDecodeError("expected a value")
    c = s[pos]
    if c == "[":
        return _parse_array(s, pos)
    if c == '"' or c == "'":
        return _parse_string(s, pos)
    # bare scalar: booleans, ints, floats
    end = pos
    while end < len(s) and s[end] not in ",]\t #":
        end += 1
    tok = s[pos:end].strip()
    if tok == "true":
        return True, end
    if tok == "false":
        return False, end
    try:
        if any(ch in tok for ch in ".eE") and not tok.startswith("0x"):
            return float(tok), end
        return int(tok.replace("_", ""), 0), end
    except ValueError:
        raise TOMLDecodeError(f"bad value: {tok!r}")


def _parse_string(s: str, pos: int) -> Tuple[str, int]:
    quote = s[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if c == "\\" and quote == '"':
            if i + 1 >= len(s):
                raise TOMLDecodeError("dangling escape")
            nxt = s[i + 1]
            if nxt == "u" and i + 5 < len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
            if nxt not in _ESCAPES:
                raise TOMLDecodeError(f"unsupported escape \\{nxt}")
            out.append(_ESCAPES[nxt])
            i += 2
            continue
        if c == quote:
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise TOMLDecodeError("unterminated string")


def _parse_array(s: str, pos: int) -> Tuple[List[Any], int]:
    out: List[Any] = []
    i = pos + 1
    while True:
        while i < len(s) and s[i] in " \t,":
            i += 1
        if i >= len(s):
            raise TOMLDecodeError("unterminated array")
        if s[i] == "]":
            return out, i + 1
        val, i = _parse_value(s, i)
        out.append(val)
