"""libsodium ``crypto_box_seal`` construction: X25519 +
XSalsa20-Poly1305 (reference scope: ``SurveyManager`` encrypts survey
response bodies with libsodium sealed boxes,
``src/overlay/SurveyManager.h:20-38`` / ``src/crypto/Curve25519.cpp``).

Pure-Python Salsa20 core / HSalsa20 / Poly1305 assembled exactly per
the NaCl papers and the libsodium sealed-box layout:

    sealed = ephemeral_pk(32) || secretbox(m,
                 nonce = BLAKE2b-192(ephemeral_pk || recipient_pk),
                 key   = HSalsa20(X25519(ephemeral_sk, recipient_pk),
                                   0^16))

Verification in-tree (no libsodium/PyNaCl ships in this image): the
Salsa20 rounds are differential-tested against OpenSSL's scrypt
(hashlib.scrypt BlockMix runs Salsa20/8 over the same core), Poly1305
against the RFC 8439 vector, quarterround against the Salsa20 spec
examples, and X25519 against the ``cryptography`` package.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import struct

from stellar_tpu_torch.crypto import curve25519 as c25519

__all__ = ["salsa20_core", "hsalsa20", "xsalsa20_xor", "poly1305",
           "secretbox", "secretbox_open", "box_beforenm",
           "seal", "seal_open", "BoxError"]

_M32 = 0xFFFFFFFF

# "expand 32-byte k"
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


class BoxError(ValueError):
    pass


def _rotl(v: int, s: int) -> int:
    return ((v << s) | (v >> (32 - s))) & _M32


def _quarterround(y0, y1, y2, y3):
    y1 ^= _rotl((y0 + y3) & _M32, 7)
    y2 ^= _rotl((y1 + y0) & _M32, 9)
    y3 ^= _rotl((y2 + y1) & _M32, 13)
    y0 ^= _rotl((y3 + y2) & _M32, 18)
    return y0, y1, y2, y3


def _rounds(x: list, rounds: int):
    """In-place double-rounds over a 16-word state."""
    for _ in range(0, rounds, 2):
        # columnround
        x[0], x[4], x[8], x[12] = _quarterround(x[0], x[4], x[8], x[12])
        x[5], x[9], x[13], x[1] = _quarterround(x[5], x[9], x[13], x[1])
        x[10], x[14], x[2], x[6] = _quarterround(x[10], x[14], x[2],
                                                 x[6])
        x[15], x[3], x[7], x[11] = _quarterround(x[15], x[3], x[7],
                                                 x[11])
        # rowround
        x[0], x[1], x[2], x[3] = _quarterround(x[0], x[1], x[2], x[3])
        x[5], x[6], x[7], x[4] = _quarterround(x[5], x[6], x[7], x[4])
        x[10], x[11], x[8], x[9] = _quarterround(x[10], x[11], x[8],
                                                 x[9])
        x[15], x[12], x[13], x[14] = _quarterround(x[15], x[12], x[13],
                                                   x[14])


def salsa20_core(block64: bytes, rounds: int = 20) -> bytes:
    """The Salsa20 hash: 16 LE words -> rounds -> feedforward add."""
    inp = list(struct.unpack("<16I", block64))
    x = list(inp)
    _rounds(x, rounds)
    return struct.pack("<16I",
                       *((a + b) & _M32 for a, b in zip(x, inp)))


def _key_state(key32: bytes, in16: bytes) -> list:
    k = struct.unpack("<8I", key32)
    n = struct.unpack("<4I", in16)
    return [_SIGMA[0], k[0], k[1], k[2], k[3], _SIGMA[1],
            n[0], n[1], n[2], n[3], _SIGMA[2],
            k[4], k[5], k[6], k[7], _SIGMA[3]]


def hsalsa20(key32: bytes, in16: bytes) -> bytes:
    """HSalsa20: rounds WITHOUT feedforward; output words
    0,5,10,15,6,7,8,9 (the nonce-extension PRF of XSalsa20)."""
    x = _key_state(key32, in16)
    _rounds(x, 20)
    return struct.pack("<8I", x[0], x[5], x[10], x[15],
                       x[6], x[7], x[8], x[9])


def xsalsa20_xor(data: bytes, nonce24: bytes, key32: bytes,
                 counter: int = 0) -> bytes:
    """XSalsa20 stream XOR: HSalsa20 subkey, then Salsa20 with the
    trailing 8 nonce bytes and a 64-bit LE block counter."""
    if len(nonce24) != 24 or len(key32) != 32:
        raise BoxError("bad nonce/key length")
    subkey = hsalsa20(key32, nonce24[:16])
    out = bytearray()
    n8 = nonce24[16:24]
    for i in range((len(data) + 63) // 64):
        block_in = n8 + struct.pack("<Q", counter + i)
        state = _key_state(subkey, block_in)
        ks = salsa20_core(struct.pack("<16I", *state))
        chunk = data[64 * i:64 * (i + 1)]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


def poly1305(msg: bytes, key32: bytes) -> bytes:
    """Poly1305 one-time MAC (NaCl/RFC 8439 — same function)."""
    r = int.from_bytes(key32[:16], "little")
    r &= 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i:i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = ((acc + n) * r) % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def secretbox(m: bytes, nonce24: bytes, key32: bytes) -> bytes:
    """crypto_secretbox_xsalsa20poly1305 (detached layout folded to
    the combined tag||ciphertext wire form)."""
    first = xsalsa20_xor(b"\x00" * 32 + m, nonce24, key32)
    poly_key, c = first[:32], first[32:]
    return poly1305(c, poly_key) + c


def secretbox_open(boxed: bytes, nonce24: bytes, key32: bytes) -> bytes:
    if len(boxed) < 16:
        raise BoxError("box too short")
    tag, c = boxed[:16], boxed[16:]
    poly_key = xsalsa20_xor(b"\x00" * 32, nonce24, key32)
    if not _hmac.compare_digest(tag, poly1305(c, poly_key)):
        raise BoxError("bad box tag")
    return xsalsa20_xor(b"\x00" * 32 + c, nonce24, key32)[32:]


def box_beforenm(pk32: bytes, sk32: bytes) -> bytes:
    """crypto_box shared key: HSalsa20(X25519(sk, pk), 0^16)."""
    shared = c25519.scalarmult(sk32, pk32)
    return hsalsa20(shared, b"\x00" * 16)


def _seal_nonce(epk: bytes, rpk: bytes) -> bytes:
    return hashlib.blake2b(epk + rpk, digest_size=24).digest()


def seal(m: bytes, recipient_pk: bytes) -> bytes:
    """crypto_box_seal: anonymous sender, ephemeral key per message."""
    esk = c25519.random_secret()
    epk = c25519.public_from_secret(esk)
    k = box_beforenm(recipient_pk, esk)
    return epk + secretbox(m, _seal_nonce(epk, recipient_pk), k)


def seal_open(sealed: bytes, recipient_sk: bytes,
              recipient_pk: bytes) -> bytes:
    if len(sealed) < 48:
        raise BoxError("sealed box too short")
    epk = sealed[:32]
    k = box_beforenm(epk, recipient_sk)
    return secretbox_open(sealed[32:],
                          _seal_nonce(epk, recipient_pk), k)
