"""SipHash-2-4 short hashing for in-memory hash tables.

The reference seeds a process-global SipHash key at startup and routes
unordered-container hashing through it (``src/crypto/ShortHash.h:9-19``,
``shortHash::computeHash``, ``initialize``/``seedRecordingEnabled`` for
deterministic tests). Same surface here: ``initialize()`` draws a random
key, ``seed(k)`` pins it for deterministic tests, ``compute_hash`` is
SipHash-2-4 producing a 64-bit value.
"""

from __future__ import annotations

import os
import struct

__all__ = ["initialize", "seed", "compute_hash", "xdr_computed_hash"]

_MASK = 0xFFFFFFFFFFFFFFFF
_key = (0, 0)
_initialized = False


def initialize():
    global _key, _initialized
    if not _initialized:
        raw = os.urandom(16)
        _key = struct.unpack("<QQ", raw)
        _initialized = True


def seed(key16: bytes):
    """Pin the key (tests; reference BUILD_TESTS reseeding hooks)."""
    global _key, _initialized
    _key = struct.unpack("<QQ", key16)
    _initialized = True


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def _sipround(v0, v1, v2, v3):
    v0 = (v0 + v1) & _MASK
    v1 = _rotl(v1, 13) ^ v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & _MASK
    v3 = _rotl(v3, 16) ^ v2
    v0 = (v0 + v3) & _MASK
    v3 = _rotl(v3, 21) ^ v0
    v2 = (v2 + v1) & _MASK
    v1 = _rotl(v1, 17) ^ v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def compute_hash(data: bytes) -> int:
    """SipHash-2-4 of ``data`` under the process key -> uint64."""
    if not _initialized:
        initialize()
    k0, k1 = _key
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573
    b = len(data) & 0xFF
    n_full = len(data) // 8
    for i in range(n_full):
        m = struct.unpack_from("<Q", data, i * 8)[0]
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
    tail = data[n_full * 8:]
    m = b << 56
    for i, ch in enumerate(tail):
        m |= ch << (8 * i)
    v3 ^= m
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 ^= m
    v2 ^= 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


def xdr_computed_hash(xdr_type, value) -> int:
    """Short hash of an XDR value's canonical encoding (reference
    ``shortHash::xdrComputeHash``)."""
    from stellar_tpu_torch.xdr.runtime import to_bytes
    return compute_hash(to_bytes(xdr_type, value))
