"""The port's plain group layer (stellar_tpu_torch.ops.edwards) and the
radix-32 recode against the JAX package's, limb for limb and digit for
digit: integer arithmetic, so tolerance zero. Inputs come from a numpy
seed and cross between the frameworks as numpy arrays."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stellar_tpu.ops import edwards as jed
from stellar_tpu.ops import verify as jvk
from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.ops import edwards as ted
from stellar_tpu_torch.ops import field25519 as tfe
from stellar_tpu_torch.ops import verify as tvk

B = 8


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def _encodings():
    """(16, 32) uint8 point encodings: valid keys, y = p + 3, small-order
    with and without the sign bit, undecompressable, negative zero, random
    bytes."""
    rng = np.random.default_rng(21)
    rows = [vectors.keypair(rng)[1] for _ in range(5)]
    rows.append((ref.P + 3).to_bytes(32, "little"))
    small = sorted(ref.SMALL_ORDER_ENCODINGS)
    rows += [small[1], small[2][:31] + bytes([small[2][31] | 0x80])]
    rows += [(2).to_bytes(32, "little"), (3).to_bytes(32, "little")]
    nz = bytearray((1).to_bytes(32, "little"))
    nz[31] |= 0x80
    rows.append(bytes(nz))
    rows.append(ref.point_compress(ref.BASE))
    while len(rows) < 16:
        rows.append(rng.bytes(32))
    return np.stack([np.frombuffer(r, np.uint8) for r in rows])


_jdecompress = jax.jit(jed.decompress)


@functools.lru_cache(maxsize=None)
def _points(n=B):
    """Decompressed valid keys on both sides: (torch point, jax point)."""
    rng = np.random.default_rng(22)
    enc = np.stack([np.frombuffer(vectors.keypair(rng)[1], np.uint8)
                    for _ in range(n)])
    _, tp = ted.decompress(torch.from_numpy(enc))
    _, jp = _jdecompress(jnp.asarray(enc))
    return tp, jp


def test_constants_and_base_table_match():
    np.testing.assert_array_equal(ted.D_LIMBS, jed.D_LIMBS)
    np.testing.assert_array_equal(ted.D2_LIMBS, jed.D2_LIMBS)
    np.testing.assert_array_equal(ted.SQRTM1_LIMBS, jed.SQRTM1_LIMBS)
    np.testing.assert_array_equal(ted._BASE_TABLE32, jed._BASE_TABLE32)
    assert ted.WINDOWS32 == jed.WINDOWS32
    assert ted.TABLE_ENTRIES32 == jed.TABLE_ENTRIES32


def test_unpack255_matches():
    enc = _encodings()
    _same(ted.unpack255(torch.from_numpy(enc)), jed.unpack255(
        jnp.asarray(enc)))


def test_decompress_limb_exact():
    enc = _encodings()
    ok, pt = ted.decompress(torch.from_numpy(enc))
    jok, jpt = _jdecompress(jnp.asarray(enc))
    _same(ok, jok)
    _same(pt, jpt)
    want = [ref.point_decompress(bytes(r)) is not None for r in enc]
    assert ok.tolist() == want
    assert sum(want) >= 8 and not all(want)


def _point_ops(ed, p):
    """The point operations under test, applied by module ``ed``."""
    q = ed.point_double(p)
    return (ed.negate(p), ed.to_cached(p), q,
            ed.point_double(p, need_t=False),
            ed.point_add_cached(q, ed.to_cached(p)),
            ed.point_add_cached(q, ed.to_cached(p), need_t=False,
                                z2_is_one=True))


def test_point_ops_limb_exact():
    tp, jp = _points()
    _same(_point_ops(ted, tp),
          jax.jit(functools.partial(_point_ops, jed))(jp))
    _same(ted.identity((B,), "cpu"), jed.identity((B,)))


def test_compress_equals_limb_exact():
    """encode(p) == R for a projective point with Z != 1 (a doubling),
    against R bytes that match, differ in the sign bit, and differ in y."""
    tp, jp = _points()
    q, jq = ted.point_double(tp, need_t=False), jed.point_double(jp,
                                                                 need_t=False)
    rows = []
    xs, ys, zs = (tfe.to_int(c) for c in q)
    for j in range(B):
        pt = (int(xs[j]), int(ys[j]), int(zs[j]), 0)
        enc = bytearray(ref.point_compress(pt))
        if j % 3 == 1:
            enc[31] ^= 0x80
        elif j % 3 == 2:
            enc[0] ^= 1
        rows.append(np.frombuffer(bytes(enc), np.uint8))
    r = np.stack(rows)
    got = ted.compress_equals(q, torch.from_numpy(r))
    _same(got, jax.jit(jed.compress_equals)(jq, jnp.asarray(r)))
    assert got.tolist() == [j % 3 == 0 for j in range(B)]


def test_build_point_table_affine_limb_exact():
    tp, jp = _points()
    got = ted.build_point_table_affine(ted.negate(tp))
    want = jax.jit(jed.build_point_table_affine)(jed.negate(jp))
    _same(got, want)
    # entry v is v*(-A) in affine cached form
    xs, ys = tfe.to_int(tp[0]), tfe.to_int(tp[1])
    nega = ((-int(xs[0])) % ref.P, int(ys[0]) % ref.P, 1,
            (-int(xs[0]) * int(ys[0])) % ref.P)
    rows = ref.affine_table_rows(nega, ted.TABLE_ENTRIES32)
    for v in range(ted.TABLE_ENTRIES32):
        for c in range(3):
            assert int(tfe.to_int(got[v, c])[0]) % ref.P == rows[v][c]


def test_table_select_affine_limb_exact():
    tp, jp = _points()
    table = ted.build_point_table_affine(tp)
    digits = np.array([-16, -9, -1, 0, 1, 7, 15, 16], dtype=np.int32)
    got = ted.table_select_affine(table, torch.from_numpy(digits))
    want = jed.table_select_affine(jnp.asarray(table.numpy()),
                                   jnp.asarray(digits))
    _same(got, want)
    _same(ted._extended_from_affine_cached(got),
          jed._extended_from_affine_cached(want))
    base = ted.base_table_affine((B,), "cpu")
    _same(ted.table_select_affine(base, torch.from_numpy(digits)),
          jed.table_select_affine(jed.base_table_affine((B,)),
                                  jnp.asarray(digits)))


def _scalars():
    rng = np.random.default_rng(23)
    s = rng.integers(0, 256, (12, 32), dtype=np.uint8)
    extremes = [0, 1, 15, 16, 2**255 - 1, 2**255, 2**256 - 1, ref.L,
                9 * 2**252]
    for i, v in enumerate(extremes):
        s[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return s


def test_recode32_matches_and_reconstructs():
    s = _scalars()
    got = tvk.signed_digits32(torch.from_numpy(s))
    _same(got, jvk.signed_digits32_dev(jnp.asarray(s)))
    d = got.numpy()
    assert d.shape == (52, len(s))
    assert d[1:].min() >= -16 and d[1:].max() < 16
    assert d[0].min() >= 0 and d[0].max() <= 2
    for j in range(len(s)):
        value = sum(int(d[51 - i, j]) << (5 * i) for i in range(52))
        assert value == int.from_bytes(bytes(s[j]), "little")


def test_signed_window_carry_chain_matches():
    """The loop form of the carry chain equals the reference's
    associative scan, at radix 16 and 256 as well as 32."""
    rng = np.random.default_rng(24)
    for bits, windows in ((4, 64), (5, 52), (8, 32)):
        e = rng.integers(0, 1 << bits, (windows, 10), dtype=np.int32)
        e[:, 0] = (1 << (bits - 1)) - 1  # a long propagate run
        e[0, 0] = 1 << (bits - 1)
        _same(tvk._signed_window_carry_chain(torch.from_numpy(e), bits),
              jvk._signed_window_carry_chain(jnp.asarray(e), bits))


def test_double_scalarmult_refuses_radix16():
    """64 digits are no longer refused: they run the radix-16 arm, as in
    the reference (52 digits run the radix-32 arm). Zero scalars give the
    identity on both arms."""
    tp, _ = _points()
    d64 = torch.zeros((64, B), dtype=torch.int32)
    got = ted.double_scalarmult(d64, d64, tp)
    for g, w in zip(got, ted._double_scalarmult16(d64, d64, tp)):
        assert torch.equal(g, w)
    ident = torch.from_numpy(np.frombuffer(
        ref.point_compress(ref.IDENTITY), np.uint8).copy()).expand(B, 32)
    d52 = torch.zeros((52, B), dtype=torch.int32)
    for p in (got, ted.double_scalarmult(d52, d52, tp)):
        assert ted.compress_equals(p, ident.contiguous()).all()
