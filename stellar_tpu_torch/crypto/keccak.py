"""Keccak-256 (original 0x01 padding, as used by Ethereum and by
soroban's ``compute_hash_keccak256`` host function — reference scope:
the env interface the vendored soroban-env-host exports to contracts;
this is the pre-NIST Keccak, NOT SHA3-256's 0x06 domain byte).

Pure-Python Keccak-f[1600] sponge. Contract-host use only (per-call
inputs are budget-capped); the device batch path for signatures stays
on the ed25519 kernels.
"""

from __future__ import annotations

__all__ = ["keccak256"]

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y] laid out by flat index x + 5*y
_ROTATIONS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

_M64 = (1 << 64) - 1

_RATE = 136  # 1088-bit rate for 256-bit output


def _rol(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & _M64


def _keccak_f(a: list) -> None:
    """In-place Keccak-f[1600] permutation over 25 lanes."""
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(0, 25, 5):
                a[x + y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(
                    a[x + 5 * y], _ROTATIONS[x + 5 * y])
        # chi
        for x in range(5):
            for y in range(0, 25, 5):
                a[x + y] = b[x + y] ^ ((~b[(x + 1) % 5 + y]) &
                                       b[(x + 2) % 5 + y] & _M64)
        # iota
        a[0] ^= rc


def keccak256(data: bytes) -> bytes:
    state = [0] * 25
    # absorb with multi-rate padding, domain byte 0x01
    padded = data + b"\x01" + b"\x00" * (_RATE - 1 - len(data) % _RATE)
    padded = padded[:len(padded) - 1] + bytes([padded[-1] | 0x80])
    for off in range(0, len(padded), _RATE):
        block = padded[off:off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        _keccak_f(state)
    # squeeze 32 bytes (single block: 32 < rate)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))
