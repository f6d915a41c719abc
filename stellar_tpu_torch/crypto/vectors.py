"""Seeded ed25519 test vectors for the port's tests and ``chip_smoke.py``.

Every vector comes from a ``numpy.random.Generator`` the caller seeds, so
a run can be repeated exactly. Signatures are made with the port's own
oracle (:mod:`stellar_tpu_torch.crypto.ed25519_ref`).

* :func:`edge_corpus` — (pk, msg, sig) triples aimed at every rejection
  rule of libsodium's verify: small-order and sign-flipped A and R,
  non-canonical y, undecompressable A, negative zero, non-canonical and
  extreme s, bad lengths, all-zero rows and single-bit flips;
* :func:`valid_items` — fresh signatures over random messages;
* :func:`matching_rows` — raw kernel rows (A, R, s, h) whose scalars are
  arbitrary 256-bit values, including s, h >= 2^255, with R set to
  encode(s*B + h*(-A)), so the device bit must be True although the host
  gate would reject most of them;
* :func:`hot_matching_rows` — the same for the hot kernel: rows (signer
  table, R, s, h) with R set to what the 128-entry tables reach, the top
  radix-256 digit of s and h often above 128 (where the select
  saturates);
* :func:`r16_matching_rows` — rows for the radix-16 kernel whose bit is
  True: s and h below :data:`R16_OVERFLOW`, where the top radix-16 digit
  fits the 8-entry table;
* :func:`r16_overflow_rows` — rows with s or h at or above
  :data:`R16_OVERFLOW` (every s >= 9 * 2^252 among them), where the top
  digit selects the zero point: R = 32 zero bytes (bit True) on even
  rows, R = encode(s*B + h*(-A)) (bit False) on odd ones.
"""

from __future__ import annotations

import numpy as np

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.parallel.signer_tables import build_signer_table

__all__ = ["keypair", "valid_items", "edge_corpus", "matching_rows",
           "random_rows", "hot_matching_rows", "r16_matching_rows",
           "r16_overflow_rows", "R16_OVERFLOW"]

# The least scalar whose signed radix-16 top digit exceeds the 8-entry
# table: 0x8777...78 (an 8, 62 sevens, an 8). Digits in [-8, 8) below
# the top reach at most 0x77...7 (63 nibbles), so the low 252 bits carry
# into the top window from 0x77...78 on; the top digit is 9 from here and
# 8 just below. Every scalar >= 9 * 2^252 overflows.
R16_OVERFLOW = 8 * 16**63 + 7 * (16**63 - 1) // 15 + 1


def keypair(rng: np.random.Generator):
    """(seed, public key) from 32 random bytes."""
    seed = rng.bytes(32)
    return seed, ref.secret_to_public(seed)


def valid_items(rng: np.random.Generator, n: int, msg_len=32) -> list:
    """``n`` good (pk, msg, sig) triples, each from its own signer.
    ``msg_len`` is an int or a function of the item's index."""
    items = []
    for i in range(n):
        seed, pk = keypair(rng)
        msg = rng.bytes(msg_len(i) if callable(msg_len) else msg_len)
        items.append((pk, msg, ref.sign(seed, msg)))
    return items


def edge_corpus(rng: np.random.Generator) -> list:
    """Structured adversarial (pk, msg, sig) triples; item 0 is a good
    control signature."""
    seed, pk = keypair(rng)
    msg = b"edge corpus"
    sig = ref.sign(seed, msg)
    r, s = sig[:32], sig[32:]
    items = [(pk, msg, sig)]
    # small-order A and R, canonical and sign-flipped encodings
    for enc in sorted(ref.SMALL_ORDER_ENCODINGS):
        items.append((enc, msg, sig))
        items.append((enc[:31] + bytes([enc[31] | 0x80]), msg, sig))
        items.append((pk, msg, enc + s))
    # non-canonical y: A with y = p + 3 (it has an x), R with y = p + 3
    items.append(((ref.P + 3).to_bytes(32, "little"), msg, sig))
    items.append((pk, msg, (ref.P + 3).to_bytes(32, "little") + s))
    # undecompressable A: the first three y with no square root
    y, found = 2, 0
    while found < 3:
        enc = y.to_bytes(32, "little")
        if ref.point_decompress(enc) is None:
            items.append((enc, msg, sig))
            found += 1
        y += 1
    # negative zero: y = 1 (x = 0) with the sign bit set
    nz = bytearray((1).to_bytes(32, "little"))
    nz[31] |= 0x80
    items.append((bytes(nz), msg, sig))
    # non-canonical and extreme s
    s_int = int.from_bytes(s, "little")
    for bad in (ref.L, s_int + ref.L, 2**256 - 1, 0, 9 * 2**252,
                15 * 2**252 + s_int % 2**252):
        items.append((pk, msg, r + (bad % 2**256).to_bytes(32, "little")))
    # bad lengths
    items += [(pk[:31], msg, sig), (pk + b"\x00", msg, sig),
              (pk, msg, sig[:63]), (pk, msg, sig + b"\x00"),
              (b"", msg, sig), (pk, msg, b"")]
    # all-zero rows
    items += [(bytes(32), msg, bytes(64)), (bytes(32), b"", bytes(64))]
    # tampered message, R and s
    items.append((pk, msg + b"x", sig))
    for pos, bit in ((5, 0x40), (40, 1)):
        flip = bytearray(sig)
        flip[pos] ^= bit
        items.append((pk, msg, bytes(flip)))
    return items


def _neg(pt):
    return ((ref.P - pt[0]) % ref.P, pt[1], pt[2], (ref.P - pt[3]) % ref.P)


def matching_rows(rng: np.random.Generator, n: int):
    """``n`` raw rows (a, r, s, h), each (n, 32) uint8, whose device bit is
    True: A a valid key, s and h arbitrary 256-bit scalars (the first rows
    take the extremes 0, 2^255 - 1, 2^255, 2^256 - 1), R = encode(s*B +
    h*(-A))."""
    return _rows_for(rng, n, [0, 2**255 - 1, 2**255, 2**256 - 1],
                     lambda: int.from_bytes(rng.bytes(32), "little"))


def r16_matching_rows(rng: np.random.Generator, n: int):
    """``n`` raw rows (a, r, s, h) whose radix-16 device bit is True: s
    and h below :data:`R16_OVERFLOW` (the first rows take 0, 8 * 2^252,
    ``R16_OVERFLOW - 1`` and 2^255 - 1, top digits 0 and 8), R =
    encode(s*B + h*(-A))."""
    return _rows_for(rng, n, [0, 8 * 2**252, R16_OVERFLOW - 1, 2**255 - 1],
                     lambda: int.from_bytes(rng.bytes(32), "little")
                     % R16_OVERFLOW)


def r16_overflow_rows(rng: np.random.Generator, n: int):
    """``n`` raw rows (a, r, s, h) with a valid A and s or h at or above
    :data:`R16_OVERFLOW`, where the radix-16 top digit (9 to 16) selects
    the zero point and the accumulator ends at (0, 0, 0): R = 32 zero
    bytes on even rows (bit True), R = encode(s*B + h*(-A)) on odd rows
    (bit False). The first rows take ``R16_OVERFLOW``, 9 * 2^252 and
    2^256 - 1."""
    a, r, s, h = _rows_for(rng, n, [R16_OVERFLOW, 9 * 2**252, 2**256 - 1],
                           lambda: R16_OVERFLOW + int.from_bytes(
                               rng.bytes(32), "little")
                           % (2**256 - R16_OVERFLOW))
    for i in range(n):
        if i % 4 == 1:  # only h overflows
            s[i] = np.frombuffer((int.from_bytes(s[i].tobytes(), "little")
                                  % R16_OVERFLOW).to_bytes(32, "little"),
                                 np.uint8)
        elif i % 4 == 3:  # only s overflows
            h[i] = np.frombuffer((int.from_bytes(h[i].tobytes(), "little")
                                  % R16_OVERFLOW).to_bytes(32, "little"),
                                 np.uint8)
    for i in range(n):
        sv, hv = (int.from_bytes(x[i].tobytes(), "little") for x in (s, h))
        pk = a[i].tobytes()
        point = ref.point_add(ref.scalarmult_base(sv), ref.point_mul(
            hv, _neg(ref.point_decompress(pk))))
        r[i] = np.frombuffer(bytes(32) if i % 2 == 0
                             else ref.point_compress(point), np.uint8)
    return a, r, s, h


def _rows_for(rng, n, extremes, draw):
    """``n`` rows (a, r, s, h) over fresh keys with R = encode(s*B +
    h*(-A)): s takes ``extremes`` in order and h in reverse order on the
    first rows, then both come from ``draw()``."""
    a = np.zeros((n, 32), np.uint8)
    r, s, h = np.zeros_like(a), np.zeros_like(a), np.zeros_like(a)
    for i in range(n):
        _, pk = keypair(rng)
        sv = extremes[i] if i < len(extremes) else draw()
        hv = extremes[-1 - i] if i < len(extremes) else draw()
        point = ref.point_add(ref.scalarmult_base(sv),
                              ref.point_mul(hv, _neg(ref.point_decompress(pk))))
        a[i] = np.frombuffer(pk, np.uint8)
        r[i] = np.frombuffer(ref.point_compress(point), np.uint8)
        s[i] = np.frombuffer(sv.to_bytes(32, "little"), np.uint8)
        h[i] = np.frombuffer(hv.to_bytes(32, "little"), np.uint8)
    return a, r, s, h


def random_rows(rng: np.random.Generator, n: int):
    """``n`` rows of uniformly random bytes for all four operands."""
    return tuple(rng.integers(0, 256, (n, 32), dtype=np.uint8)
                 for _ in range(4))


def _hot_scalar(v: int) -> int:
    """The multiple of B (or -A) that the hot kernel's 128-entry tables
    give for a 256-bit scalar ``v``: ``v`` itself, unless its top signed
    radix-256 digit (the top byte plus the carry into it) exceeds 128,
    which selects entry 128."""
    carry = 0
    for i in range(31):
        carry = int(((v >> (8 * i)) & 0xFF) + carry >= 128)
    top = (v >> 248) + carry
    return v - (max(top, 128) - 128) * 256 ** 31


def hot_matching_rows(rng: np.random.Generator, n: int):
    """``n`` raw hot rows (tables (n, 128, 3, 20) int16, r, s, h (n, 32)
    uint8) whose device bit is True: each table a valid key's signer
    table, s and h arbitrary 256-bit scalars, R = encode(s'*B + h'*(-A))
    with s' and h' from :func:`_hot_scalar`. The first rows take extremes
    (0, 2^255 - 129, 2^255 - 128, 2^256 - 1, top bytes 0x80 and 0x81);
    after them every other row draws s's and h's top bytes from
    [0x81, 0xff], so the top digit saturates."""
    extremes = [0, 2**255 - 129, 2**255 - 128, 2**256 - 1, 0x81 << 248,
                (0x80 << 248) | (0xFF << 240)]
    tables = np.zeros((n, 128, 3, 20), np.int16)
    r = np.zeros((n, 32), np.uint8)
    s, h = np.zeros_like(r), np.zeros_like(r)
    for i in range(n):
        _, pk = keypair(rng)
        if i < len(extremes):
            sv, hv = extremes[i], extremes[-1 - i]
        else:
            sv, hv = (int.from_bytes(rng.bytes(32), "little")
                      for _ in range(2))
            if i % 2:
                sv = sv % 2**248 + (int(rng.integers(0x81, 0x100)) << 248)
                hv = hv % 2**248 + (int(rng.integers(0x81, 0x100)) << 248)
        point = ref.point_add(
            ref.scalarmult_base(_hot_scalar(sv)),
            ref.point_mul(_hot_scalar(hv), _neg(ref.point_decompress(pk))))
        tables[i] = build_signer_table(pk)
        r[i] = np.frombuffer(ref.point_compress(point), np.uint8)
        s[i] = np.frombuffer(sv.to_bytes(32, "little"), np.uint8)
        h[i] = np.frombuffer(hv.to_bytes(32, "little"), np.uint8)
    return tables, r, s, h
