"""X25519 ECDH for overlay channel auth (reference
``src/crypto/Curve25519.cpp`` wrapping libsodium crypto_scalarmult;
RFC 7748 semantics re-implemented on the same GF(2^255-19) the ed25519
oracle uses).

Host-side and tiny: one scalar mult per peer handshake — nowhere near
the batch-crypto hot path.
"""

from __future__ import annotations

import hmac as _hmac
import os

__all__ = ["scalarmult", "scalarmult_base", "random_secret",
           "public_from_secret", "hkdf_extract", "hkdf_expand",
           "hmac_sha256", "verify_hmac_sha256"]

P = 2 ** 255 - 19
A24 = 121665


def _clamp(k: bytes) -> int:
    n = bytearray(k)
    n[0] &= 248
    n[31] &= 127
    n[31] |= 64
    return int.from_bytes(bytes(n), "little")


try:  # OpenSSL X25519 (identical RFC 7748 clamping/semantics; the
    # pure-Python ladder below stays as the differential oracle —
    # test_crypto_host pins agreement incl. the small-order rejection)
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey as _OsslX25519Priv,
        X25519PublicKey as _OsslX25519Pub,
    )
except ImportError:  # pragma: no cover
    _OsslX25519Priv = None


def scalarmult(secret: bytes, point: bytes) -> bytes:
    """X25519(secret, point) with libsodium's small-order rejection."""
    if len(secret) != 32 or len(point) != 32:
        raise ValueError("X25519 takes 32-byte scalar and point")
    if _OsslX25519Priv is not None:
        sk = _OsslX25519Priv.from_private_bytes(secret)
        pk = _OsslX25519Pub.from_public_bytes(point)
        try:
            return sk.exchange(pk)
        except ValueError as e:
            # OpenSSL rejects all-zero shared secrets like libsodium
            raise ValueError(
                "small-order X25519 point: all-zero shared secret"
            ) from e
    return _scalarmult_ladder(secret, point)


def _scalarmult_ladder(secret: bytes, point: bytes) -> bytes:
    """RFC 7748 Montgomery ladder (pure-Python oracle)."""
    k = _clamp(secret)
    u = int.from_bytes(point, "little") & ((1 << 255) - 1)
    x1 = u % P
    x2, z2 = 1, 0
    x3, z3 = x1, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = z3 * z3 % P
        z3 = z3 * x1 % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    # libsodium's crypto_scalarmult fails on small-order peer points
    # (all-zero shared secret); without this a malicious peer could force
    # session keys derived from public data alone.
    if out == 0:
        raise ValueError("small-order X25519 point: all-zero shared secret")
    return out.to_bytes(32, "little")


BASE_POINT = (9).to_bytes(32, "little")


def scalarmult_base(secret: bytes) -> bytes:
    return scalarmult(secret, BASE_POINT)


def random_secret() -> bytes:
    return os.urandom(32)


def public_from_secret(secret: bytes) -> bytes:
    return scalarmult_base(secret)


# single KDF implementation lives in crypto/sha.py


from stellar_tpu_torch.crypto.sha import (  # noqa: E402,F401
    hkdf_expand, hkdf_extract,
)


# one shared implementation (crypto/sha.py) — it MACs every overlay
# message twice (send + receive verify), so it rides hmac.digest()'s
# one-shot C fast path there
from stellar_tpu_torch.crypto.sha import hmac_sha256  # noqa: E402,F401


def verify_hmac_sha256(key: bytes, msg: bytes, mac: bytes) -> bool:
    return _hmac.compare_digest(hmac_sha256(key, msg), mac)
