"""Batched twisted-Edwards (ed25519) group operations in plain PyTorch —
the plain version of the cold subset of ``stellar_tpu/ops/edwards.py``,
op for op, so every limb compares bit for bit with the reference.

The hot-signer loop (:func:`double_scalarmult_hot`, radix 256 over a
cached 128-entry table of -A) is here too; its kernel is
``csrc/verify_hot.cu``. So is the radix-16 arm
(:func:`_double_scalarmult16`, 64 signed digits over 8-entry projective
cached tables, with :func:`table_select`, :func:`base_table` and
:func:`build_point_table`); its kernel is ``csrc/verify_r16.cu``.

Points are extended homogeneous ``(X, Y, Z, T)`` tuples (or projective
``(X, Y, Z)`` where T is never read); each coordinate is a limb tensor of
shape ``(20, *batch)`` (:mod:`stellar_tpu_torch.ops.field25519`). All
formulas are the complete unified ones, valid for every pair of curve
points, so there is no data-dependent control flow. The CUDA code that
replaces this layer is ``csrc/ge25519.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.ops import field25519 as fe

__all__ = [
    "identity", "negate", "to_cached", "point_add_cached", "point_double",
    "unpack255", "decompress", "compress_equals", "build_point_table_affine",
    "base_table_affine", "table_select_affine", "double_scalarmult",
    "base_table_affine_wide", "double_scalarmult_hot", "table_select",
    "base_table", "build_point_table",
    "D_LIMBS", "D2_LIMBS", "SQRTM1_LIMBS", "WINDOWS", "TABLE_ENTRIES",
    "WINDOWS32", "TABLE_ENTRIES32", "WINDOWS256", "TABLE_ENTRIES256",
]

WINDOWS = 64       # signed radix-16 digits per 256-bit scalar
TABLE_ENTRIES = 8  # entries of each radix-16 window table
CACHED_COORDS = 4  # projective cached entry: (Y+X, Y-X, Z, 2d*T)

WINDOWS32 = 52        # signed radix-32 digits per 256-bit scalar
TABLE_ENTRIES32 = 16  # entries of each window table
AFFINE_COORDS = 3     # affine cached entry: (Y+X, Y-X, 2d*T); Z == 1
WINDOWS256 = 32         # signed radix-256 digits per 256-bit scalar
TABLE_ENTRIES256 = 128  # entries of each hot window table

D_LIMBS = fe.from_int(ref.D)
D2_LIMBS = fe.from_int(2 * ref.D % ref.P)
SQRTM1_LIMBS = fe.from_int(ref.SQRT_M1)
_HALF_LIMBS = fe.from_int((fe.P + 1) // 2)


def _const(limbs: np.ndarray, like: torch.Tensor, batch_shape=None):
    shape = like.shape[1:] if batch_shape is None else batch_shape
    return fe._limbs(limbs, like, shape)


def identity(batch_shape, device):
    z = fe.zeros(batch_shape, device)
    one = fe.constant(1, z)
    return (z, one, one, z)


def negate(p):
    x, y, z, t = p
    return (fe.neg(x), y, z, fe.neg(t))


def _mulstack(ls, rs):
    """N field multiplies as ONE multiply over a (20, N, *batch) stack."""
    o = fe.mul(torch.stack(ls, dim=1), torch.stack(rs, dim=1))
    return tuple(o[:, i] for i in range(len(ls)))


def _stack_points(ps):
    return tuple(torch.stack(cs, dim=1) for cs in zip(*ps))


def _unstack_points(p, n):
    return [tuple(c[:, i] for c in p) for i in range(n)]


def to_cached(p):
    """Extended point -> cached form (Y+X, Y-X, Z, 2d*T)."""
    x, y, z, t = p
    return (fe.add(y, x), fe.sub(y, x), z, fe.mul(t, _const(D2_LIMBS, t)))


def point_add_cached(p, q_cached, need_t=True, z2_is_one=False):
    """p (extended) + q (cached, or AFFINE cached (Y+X, Y-X, 2d*T) with
    Z == 1 implied). ``need_t=False`` returns a projective triple."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    if len(q_cached) == AFFINE_COORDS:
        ypx2, ymx2, t2d2 = q_cached
        z2, z2_is_one = None, True
    else:
        ypx2, ymx2, z2, t2d2 = q_cached
    if z2_is_one:
        a, b, c = _mulstack((fe.sub(y1, x1), fe.add(y1, x1), t1),
                            (ymx2, ypx2, t2d2))
        dd = z1
    else:
        a, b, c, dd = _mulstack((fe.sub(y1, x1), fe.add(y1, x1), t1, z1),
                                (ymx2, ypx2, t2d2, z2))
    dd = fe.add(dd, dd)
    e = fe.sub(b, a)
    f = fe.sub(dd, c)
    g = fe.add(dd, c)
    h = fe.add(b, a)
    if need_t:
        return _mulstack((e, g, f, e), (f, h, g, h))
    return _mulstack((e, g, f), (f, h, g))


def point_double(p, need_t=True):
    """Dedicated doubling of an extended or projective point (T unread)."""
    x1, y1, z1 = p[0], p[1], p[2]
    s = fe.sqr(torch.stack([x1, y1, z1, fe.add(x1, y1)], dim=1))
    a, b, zz, xysq = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    c = fe.add(zz, zz)
    h = fe.add(a, b)
    e = fe.sub(h, xysq)
    g = fe.sub(a, b)
    f = fe.add(c, g)
    if need_t:
        return _mulstack((e, g, f, e), (f, h, g, h))
    return _mulstack((e, g, f), (f, h, g))


def unpack255(b):
    """(batch, 32) uint8 little-endian -> ((20, batch) strict 13-bit limbs
    of the low 255 bits, (batch,) int32 top bit)."""
    nbatch = b.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = ((b[:, :, None].to(torch.int32) >> shifts) & 1).reshape(nbatch,
                                                                     256)
    sign = bits[:, 255]
    bits = torch.cat([bits[:, :255], torch.zeros_like(bits[:, :5])], dim=1)
    weights = 1 << torch.arange(fe.BITS, dtype=torch.int32, device=b.device)
    limbs = (bits.reshape(nbatch, fe.NLIMBS, fe.BITS) * weights).sum(
        -1, dtype=torch.int32)
    return limbs.T.contiguous(), sign


def decompress(a_bytes):
    """Batched ge25519_frombytes: (batch, 32) uint8 -> (ok, point). y is
    taken mod p; the root comes from the (p-5)/8 exponent, corrected by
    sqrt(-1); "negative zero" (x == 0 with the sign bit set) is rejected."""
    y, sign = unpack255(a_bytes)
    one = fe.constant(1, y)
    y2 = fe.sqr(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(y2, _const(D_LIMBS, y)), one)
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))
    vxx = fe.canon(fe.mul(fe.sqr(x), v))
    ok_direct = (vxx == fe.canon(u)).all(dim=0)
    ok_twist = (vxx == fe.canon(fe.neg(u))).all(dim=0)
    x = fe.select(ok_twist, fe.mul(x, _const(SQRTM1_LIMBS, y)), x)
    ok = ok_direct | ok_twist
    x_c = fe.canon(x)
    x_zero = (x_c == 0).all(dim=0)
    ok = ok & ~(x_zero & (sign == 1))
    flip = (x_c[0] & 1) != sign
    x = fe.select(flip, fe.neg(x), x)
    return ok, (x, y, one, fe.mul(x, y))


def compress_equals(p, r_bytes):
    """encode(p) == r_bytes, batched, without materializing bytes:
    canonical affine y equal to R's 255-bit integer and x's parity equal to
    R's sign bit — exactly a bytewise compare, since encode is canonical."""
    x, y, z = p[0], p[1], p[2]
    zinv = fe.inv(z)
    xa = fe.canon(fe.mul(x, zinv))
    ya = fe.canon(fe.mul(y, zinv))
    ry, rsign = unpack255(r_bytes)
    return (ya == ry).all(dim=0) & ((xa[0] & 1) == rsign)


def table_select(table, digit):
    """table (8, 4, 20, *batch) cached multiples 1..8 of a point; digit
    (*batch,) int32 signed -> the cached point |digit|*P, negated for a
    negative digit. A one-hot multiply-accumulate over the 8 entries, as
    the reference computes it: digit 0 matches no entry and is patched to
    the cached identity (1, 1, 1, 0) by three limb-0 adds; a magnitude
    above 8 (the radix-16 recode's top digit for s >= 9 * 2^252) matches
    no entry and gets no patch, so it selects the all-zero point."""
    nb = digit.dim()
    mag = digit.abs()
    idx = torch.arange(1, TABLE_ENTRIES + 1, dtype=torch.int32,
                       device=digit.device).reshape((TABLE_ENTRIES,)
                                                    + (1,) * nb)
    onehot = (idx == mag[None]).to(torch.int32)
    sel = (table * onehot[:, None, None]).sum(dim=0, dtype=torch.int32)
    ypx, ymx, z, t2d = sel[0], sel[1], sel[2], sel[3]
    is0 = (digit == 0).to(torch.int32)
    ypx = ypx.clone()
    ymx = ymx.clone()
    z = z.clone()
    ypx[0] += is0
    ymx[0] += is0
    z[0] += is0
    neg = digit < 0
    return (fe.select(neg, ymx, ypx), fe.select(neg, ypx, ymx), z,
            fe.select(neg, fe.neg(t2d), t2d))


def _base_multiples() -> np.ndarray:
    """v*B for v = 1..8 in cached form (y+x, y-x, 1, 2d*x*y), canonical
    limbs, (8, 4, 20) int32: Z is exactly 1."""
    out = np.zeros((TABLE_ENTRIES, CACHED_COORDS, fe.NLIMBS), dtype=np.int32)
    for v, (ypx, ymx, t2d) in enumerate(
            ref.affine_table_rows(ref.BASE, TABLE_ENTRIES)):
        out[v] = np.stack([fe.from_int(ypx), fe.from_int(ymx),
                           fe.from_int(1), fe.from_int(t2d)])
    return out


_BASE_TABLE = _base_multiples()


def base_table(batch_shape, device):
    """(8, 4, 20, *batch) constant cached table of v*B, v = 1..8."""
    t = torch.as_tensor(_BASE_TABLE, device=device)
    return t.reshape(t.shape + (1,) * len(batch_shape)).expand(
        t.shape + tuple(batch_shape))


def build_point_table(p):
    """Cached table v*p, v = 1..8 -> (8, 4, 20, *batch), projective (no
    inversion), by the reference's seven group ops: 2 = dbl(1), 4 =
    dbl(2), {3, 5} = {2, 4} + 1, {6, 8} = dbl({3, 4}), 7 = 6 + 1, then one
    stacked ``to_cached`` of all eight."""
    c1 = to_cached(p)
    p2 = point_double(p)
    p4 = point_double(p2)
    p3, p5 = _unstack_points(point_add_cached(_stack_points([p2, p4]),
                                              _stack_points([c1, c1])), 2)
    p6, p8 = _unstack_points(point_double(_stack_points([p3, p4])), 2)
    p7 = point_add_cached(p6, c1)
    cached = to_cached(_stack_points([p, p2, p3, p4, p5, p6, p7, p8]))
    # (4, 20, 8, *batch) -> (8, 4, 20, *batch)
    return torch.stack(cached).movedim(2, 0)


def _extended_multiples(p, entries=TABLE_ENTRIES32):
    """[1*p .. entries*p] by the even/odd ladder: each round doubles every
    v whose 2v is missing (one stacked double) and adds p to every even v
    whose v+1 is missing (one stacked cached add)."""
    c1 = to_cached(p)
    pts = {1: p}
    have = {1}
    while len(have) < entries:
        dbl_src = [v for v in sorted(have)
                   if 2 * v <= entries and 2 * v not in have]
        if dbl_src:
            need_t = any(2 * v + 1 <= entries for v in dbl_src)
            doubled = _unstack_points(point_double(
                _stack_points([pts[v] for v in dbl_src]), need_t=need_t),
                len(dbl_src))
            for v, q in zip(dbl_src, doubled):
                pts[2 * v] = q
            have.update(2 * v for v in dbl_src)
        add_src = [v for v in sorted(have) if v % 2 == 0
                   and v + 1 <= entries and v + 1 not in have]
        if add_src:
            summed = _unstack_points(point_add_cached(
                _stack_points([pts[v] for v in add_src]),
                _stack_points([c1] * len(add_src)), need_t=False),
                len(add_src))
            for v, q in zip(add_src, summed):
                pts[v + 1] = q
            have.update(v + 1 for v in add_src)
    return [pts[v] for v in range(1, entries + 1)]


def build_point_table_affine(p, entries=TABLE_ENTRIES32):
    """AFFINE cached table v*p, v = 1..entries -> (entries, 3, 20, *batch)
    with coords (Y+X, Y-X, 2d*T), Z normalized to 1 by one
    :func:`fe.batch_inv`."""
    pts = _extended_multiples(p, entries)
    xs = torch.stack([q[0] for q in pts], dim=1)  # (20, E, *batch)
    ys = torch.stack([q[1] for q in pts], dim=1)
    zs = torch.stack([q[2] for q in pts], dim=1)
    zinv = fe.batch_inv(zs)
    uv = fe.mul(torch.stack([xs, ys], dim=1), torch.stack([zinv, zinv], dim=1))
    u, v = uv[:, 0], uv[:, 1]
    t2d = fe.mul(fe.mul(u, v), _const(D2_LIMBS, u))
    cached = torch.stack([fe.add(v, u), fe.sub(v, u), t2d])  # (3,20,E,..)
    return cached.movedim(2, 0)  # (E, 3, 20, *batch)


def _affine_multiples_host(entries=TABLE_ENTRIES32) -> np.ndarray:
    """v*B, v = 1..entries, affine cached canonical limbs (entries, 3, 20)
    int32; v*B by a full scalar mult each, as the reference builds it."""
    out = np.zeros((entries, AFFINE_COORDS, fe.NLIMBS), dtype=np.int32)
    for v in range(1, entries + 1):
        pt = ref.point_mul(v, ref.BASE)
        zinv = ref._inv(pt[2])
        x = pt[0] * zinv % ref.P
        y = pt[1] * zinv % ref.P
        out[v - 1] = np.stack([fe.from_int((y + x) % ref.P),
                               fe.from_int((y - x) % ref.P),
                               fe.from_int(2 * ref.D * x * y % ref.P)])
    return out


_BASE_TABLE32 = _affine_multiples_host(TABLE_ENTRIES32)


def base_table_affine(batch_shape, device):
    """(16, 3, 20, *batch) constant affine cached table of v*B, v = 1..16."""
    t = torch.as_tensor(_BASE_TABLE32, device=device)
    return t.reshape(t.shape + (1,) * len(batch_shape)).expand(
        t.shape + tuple(batch_shape))


# The hot loop's B-table: v*B for v = 1..128, affine cached, int16
# (canonical limbs are 13-bit), from the same host rows as a signer table.
_BASE_TABLE256 = np.array(
    [[fe.from_int(c) for c in row]
     for row in ref.affine_table_rows(ref.BASE, TABLE_ENTRIES256)],
    dtype=np.int16)


def base_table_affine_wide(batch_shape, device):
    """(128, 3, 20, *batch) int16 constant affine cached table of v*B,
    v = 1..128 (the hot loop's B-table)."""
    t = torch.as_tensor(_BASE_TABLE256, device=device)
    return t.reshape(t.shape + (1,) * len(batch_shape)).expand(
        t.shape + tuple(batch_shape))


def table_select_affine(table, digit):
    """table (entries, 3, 20, *batch) affine cached multiples 1..entries;
    digit (*batch,) int32 signed -> the affine cached triple |digit|*P,
    negated for a negative digit. A log-depth conditional-move tree on the
    magnitude's bits; a magnitude above ``entries`` saturates to the last
    entry, and digit 0 is patched to the affine cached identity
    (1, 1, 0). int16 tables widen to int32 at the tree's root."""
    nb = digit.dim()
    mag = digit.abs()
    m = torch.clamp(mag - 1, min=0)
    sel = table
    bit = table.shape[0]
    while bit > 1:
        bit //= 2
        top = m >= bit
        m = torch.where(top, m - bit, m)
        sel = torch.where(top[(None,) * (sel.dim() - nb)], sel[bit:],
                          sel[:bit])
    sel = sel[0].to(torch.int32)  # (3, 20, *batch)
    ident = torch.as_tensor(
        np.stack([fe.from_int(1), fe.from_int(1), fe.from_int(0)]),
        device=digit.device).reshape((AFFINE_COORDS, fe.NLIMBS) + (1,) * nb)
    sel = torch.where((digit == 0)[None, None], ident, sel)
    ypx, ymx, t2d = sel[0], sel[1], sel[2]
    neg = digit < 0
    return (fe.select(neg, ymx, ypx), fe.select(neg, ypx, ymx),
            fe.select(neg, fe.neg(t2d), t2d))


def _extended_from_affine_cached(c):
    """Affine cached (Y+X, Y-X, 2d*T) -> extended (X, Y, 1, T)."""
    ypx, ymx, _t2d = c
    half = _const(_HALF_LIMBS, ypx)
    xy = fe.mul(torch.stack([fe.sub(ypx, ymx), fe.add(ypx, ymx)], dim=1),
                torch.stack([half, half], dim=1))
    x, y = xy[:, 0], xy[:, 1]
    return (x, y, fe.constant(1, x), fe.mul(x, y))


def double_scalarmult(s_digits, h_digits, a_neg):
    """R' = s*B + h*a_neg, the radix read from the digit count as the
    reference does: (52, batch) signed digits run the radix-32 arm (K1's),
    (64, batch) the radix-16 arm (K5's). Returns a projective (X, Y, Z)
    triple."""
    if s_digits.shape[0] == WINDOWS32:
        return _double_scalarmult32(s_digits, h_digits, a_neg)
    return _double_scalarmult16(s_digits, h_digits, a_neg)


def _double_scalarmult16(s_digits, h_digits, a_neg):
    """Radix-16 Strauss-Shamir: (64, batch) signed digits in [-8, 8), most
    significant first, the top digit in [0, 16]. 64 windows of four
    doublings (the fourth keeps T for the adds), then a base add with
    Z == 1 and a projective cached A add, both entries from one fused
    one-hot select. A top digit above 8 selects the zero point and the
    accumulator ends at (0, 0, 0), as in the reference."""
    batch = tuple(a_neg[0].shape[1:])
    tab_a = build_point_table(a_neg)
    tab_b = base_table(batch, a_neg[0].device)
    tab = torch.stack([tab_b, tab_a], dim=3)  # (8, 4, 20, 2, *batch)
    acc = identity(batch, a_neg[0].device)[:3]
    for j in range(WINDOWS):
        for _ in range(3):
            acc = point_double(acc, need_t=False)
        acc = point_double(acc)  # the adds below read T
        sel = table_select(tab, torch.stack([s_digits[j], h_digits[j]]))
        acc = point_add_cached(acc, tuple(c[:, 0] for c in sel),
                               z2_is_one=True)
        acc = point_add_cached(acc, tuple(c[:, 1] for c in sel),
                               need_t=False)
    return acc


def _double_scalarmult32(s_digits, h_digits, a_neg):
    """Radix-32 batched-affine Strauss-Shamir: 255 shared doublings and
    103 affine cached adds; the top window seeds the accumulator from its
    B-entry plus one A-add. Returns a projective (X, Y, Z) triple."""
    batch = tuple(a_neg[0].shape[1:])
    tab_a = build_point_table_affine(a_neg, TABLE_ENTRIES32)
    tab_b = base_table_affine(batch, a_neg[0].device)
    tab = torch.stack([tab_b, tab_a], dim=3)  # (16, 3, 20, 2, *batch)

    def select_pair(j):
        sel = table_select_affine(tab, torch.stack([s_digits[j],
                                                    h_digits[j]]))
        return (tuple(c[:, 0] for c in sel), tuple(c[:, 1] for c in sel))

    bsel0, asel0 = select_pair(0)
    acc = _extended_from_affine_cached(bsel0)
    acc = point_add_cached(acc, asel0, need_t=False)
    for j in range(1, WINDOWS32):
        for _ in range(4):
            acc = point_double(acc, need_t=False)
        acc = point_double(acc)
        bsel, asel = select_pair(j)
        acc = point_add_cached(acc, bsel)
        acc = point_add_cached(acc, asel, need_t=False)
    return acc


def double_scalarmult_hot(s_digits, h_digits, a_table):
    """R' = s*B + h*(-A) for a hot signer from (32, batch) signed radix-256
    digits and ``a_table``, the (128, 3, 20, *batch) int16 affine cached
    multiples 1..128 of -A (the signer-table cache's rows, batch
    trailing). 248 shared doublings and 63 affine cached adds; the top
    window seeds the accumulator from its B-entry plus one A-add. A top
    digit above 128 (s or h with top byte >= 0x81) selects entry 128, as
    the reference's select does. Returns a projective (X, Y, Z) triple."""
    batch = tuple(s_digits.shape[1:])
    tab_b = base_table_affine_wide(batch, s_digits.device)
    tab = torch.stack([tab_b, a_table], dim=3)  # (128, 3, 20, 2, *batch)

    def select_pair(j):
        sel = table_select_affine(tab, torch.stack([s_digits[j],
                                                    h_digits[j]]))
        return (tuple(c[:, 0] for c in sel), tuple(c[:, 1] for c in sel))

    bsel0, asel0 = select_pair(0)
    acc = _extended_from_affine_cached(bsel0)
    acc = point_add_cached(acc, asel0, need_t=False)
    for j in range(1, WINDOWS256):
        for _ in range(7):
            acc = point_double(acc, need_t=False)
        acc = point_double(acc)
        bsel, asel = select_pair(j)
        acc = point_add_cached(acc, bsel)
        acc = point_add_cached(acc, asel, need_t=False)
    return acc
