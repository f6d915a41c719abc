"""StrKey: Stellar's human-readable key encoding.

Base32 (RFC 4648, no padding on decode-check) over
``version byte || payload || CRC16-XModem (little-endian)`` — the format
implemented by the reference's ``src/crypto/StrKey.cpp`` /
``SecretKey::getStrKeyPublic`` (G... accounts, S... seeds, T/X for
pre-auth-tx & hash-x signers, P... signed payloads, C... contracts).

The port's copy of ``stellar_tpu/crypto/strkey.py``, with the port's
imports.
"""

from __future__ import annotations

import base64

__all__ = [
    "VER_ACCOUNT", "VER_SEED", "VER_PRE_AUTH_TX", "VER_HASH_X",
    "VER_SIGNED_PAYLOAD", "VER_MUXED_ACCOUNT", "VER_CONTRACT",
    "encode", "decode", "encode_account", "decode_account",
    "encode_seed", "decode_seed", "encode_contract", "decode_contract",
]

# version bytes = base32 leading character, per the public strkey spec
VER_ACCOUNT = 6 << 3          # 'G'
VER_MUXED_ACCOUNT = 12 << 3   # 'M'
VER_SEED = 18 << 3            # 'S'
VER_PRE_AUTH_TX = 19 << 3     # 'T'
VER_HASH_X = 23 << 3          # 'X'
VER_SIGNED_PAYLOAD = 15 << 3  # 'P'
VER_CONTRACT = 2 << 3         # 'C'


class StrKeyError(ValueError):
    pass


def _crc16_xmodem(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
    return crc


def encode(version: int, payload: bytes) -> str:
    body = bytes([version]) + payload
    crc = _crc16_xmodem(body)
    body += bytes([crc & 0xFF, crc >> 8])
    return base64.b32encode(body).decode().rstrip("=")


def decode(expected_version: int, s: str) -> bytes:
    if not s or s != s.upper():
        raise StrKeyError("strkey must be upper-case base32")
    pad = (-len(s)) % 8
    # valid strkeys never need >6 pad chars and must round-trip exactly
    try:
        raw = base64.b32decode(s + "=" * pad)
    except Exception as e:
        raise StrKeyError(f"bad base32: {e}") from e
    if base64.b32encode(raw).decode().rstrip("=") != s:
        raise StrKeyError("non-canonical base32")
    if len(raw) < 3:
        raise StrKeyError("strkey too short")
    body, crc_bytes = raw[:-2], raw[-2:]
    crc = _crc16_xmodem(body)
    if crc_bytes != bytes([crc & 0xFF, crc >> 8]):
        raise StrKeyError("strkey checksum mismatch")
    if body[0] != expected_version:
        raise StrKeyError(
            f"strkey version {body[0]} != expected {expected_version}")
    return body[1:]


def encode_account(ed25519: bytes) -> str:
    return encode(VER_ACCOUNT, ed25519)


def decode_account(s: str) -> bytes:
    out = decode(VER_ACCOUNT, s)
    if len(out) != 32:
        raise StrKeyError("account strkey must hold 32 bytes")
    return out


def encode_seed(seed: bytes) -> str:
    return encode(VER_SEED, seed)


def decode_seed(s: str) -> bytes:
    out = decode(VER_SEED, s)
    if len(out) != 32:
        raise StrKeyError("seed strkey must hold 32 bytes")
    return out


def encode_contract(h: bytes) -> str:
    return encode(VER_CONTRACT, h)


def decode_contract(s: str) -> bytes:
    out = decode(VER_CONTRACT, s)
    if len(out) != 32:
        raise StrKeyError("contract strkey must hold 32 bytes")
    return out
