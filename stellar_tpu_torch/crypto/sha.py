"""SHA-256 / SHA-512, HMAC-SHA256, and HKDF.

Mirrors the reference's hashing surface (``src/crypto/SHA.h:60-63``:
``sha256``, ``SHA256`` incremental hasher, ``hmacSha256``,
``hmacSha256Verify``, ``hkdfExtract``, ``hkdfExpand``) on top of the
CPython built-ins (the reference wraps libsodium the same way). HKDF here
matches libsodium's crypto_kdf/RFC 5869 usage in ``PeerAuth``: extract =
HMAC(salt=0^32, ikm); expand = first 32 bytes of HMAC(prk, info || 0x01).

The port's copy of ``stellar_tpu/crypto/sha.py``, with the port's
imports.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac

__all__ = [
    "sha256", "sha512", "SHA256", "hmac_sha256", "hmac_sha256_verify",
    "hkdf_extract", "hkdf_expand",
]


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


class SHA256:
    """Incremental hasher with the reference's add/finish shape
    (``SHA.h`` ``SHA256::add``/``finish``; finish is single-shot)."""

    def __init__(self):
        self._h = hashlib.sha256()
        self._done = False

    def add(self, data: bytes) -> "SHA256":
        if self._done:
            raise RuntimeError("SHA256: add after finish")
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        if self._done:
            raise RuntimeError("SHA256: finish twice")
        self._done = True
        return self._h.digest()

    def reset(self):
        self._h = hashlib.sha256()
        self._done = False


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    # hmac.digest() rides CPython's one-shot C fast path (no HMAC
    # object construction) — overlay channels MAC every message twice
    return _hmac.digest(key, data, "sha256")


def hmac_sha256_verify(mac: bytes, key: bytes, data: bytes) -> bool:
    return _hmac.compare_digest(mac, hmac_sha256(key, data))


def hkdf_extract(ikm: bytes) -> bytes:
    """HKDF-Extract with a zero salt (reference ``SHA.cpp hkdfExtract``)."""
    return hmac_sha256(b"\x00" * 32, ikm)


def hkdf_expand(prk: bytes, info: bytes) -> bytes:
    """Single-block HKDF-Expand (reference ``SHA.cpp hkdfExpand``)."""
    return hmac_sha256(prk, info + b"\x01")
