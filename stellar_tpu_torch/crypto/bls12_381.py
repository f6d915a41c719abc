"""BLS12-381 for the protocol-22 soroban host functions (CAP-59;
reference scope: the bls12_381_* env functions soroban-env-host p22
exports — its implementation is the blst-backed crate, absent from the
reference snapshot like the rest of the soroban trees).

Pure-Python tower-field pairing implementation, correctness-first:

- Fp / Fp2 / Fp6 / Fp12 arithmetic (u^2 = -1, v^3 = u+1, w^2 = v)
- G1 over E(Fp): y^2 = x^3 + 4; G2 over E'(Fp2): y^2 = x^3 + 4(u+1)
- subgroup checks by multiplying with the group order r
- optimal-ate Miller loop with the BLS parameter x = -0xd201000000010000
  and the standard final exponentiation
- Fr scalar-field arithmetic

Verified in-tree by algebraic properties (group laws, commutativity,
order-r annihilation, and pairing BILINEARITY e(aP, bQ) == e(abP, Q)
== e(P, abQ) across random scalars) plus the published generator
coordinates — no BLS library ships in this image to differentially
test against.

Serialization follows the ZCash/IETF format the reference host uses:
G1 = 96-byte uncompressed big-endian (x || y), G2 = 192 bytes
(x_c1 || x_c0 || y_c1 || y_c0), flag bits in the top three bits of the
first byte (compression=0 here; infinity flag honored).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["P", "R", "G1_GEN", "G2_GEN", "BlsError",
           "g1_add", "g1_mul", "g1_msm", "g1_check",
           "g2_add", "g2_mul", "g2_msm", "g2_check",
           "pairing_check", "g1_encode", "g1_decode",
           "g2_encode", "g2_decode",
           "fr_add", "fr_sub", "fr_mul", "fr_pow", "fr_inv"]

# base field prime and subgroup order (standard BLS12-381 parameters)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# |x| for the BLS parameter x = -0xd201000000010000 (x < 0)
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


class BlsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1): elements as (c0, c1) meaning c0 + c1*u
# ---------------------------------------------------------------------------

def _f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def _f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def _f2_sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1]) % P
    t1 = 2 * a[0] * a[1] % P
    return (t0, t1)


def _f2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    d = (a[0] * a[0] + a[1] * a[1]) % P
    if d == 0:
        raise BlsError("Fp2 inversion of zero")
    di = pow(d, P - 2, P)
    return (a[0] * di % P, (-a[1]) * di % P)


def _f2_mul_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi), xi = u + 1: elements (c0, c1, c2) of Fp2
# Fp12 = Fp6[w] / (w^2 - v):            elements (c0, c1) of Fp6
# ---------------------------------------------------------------------------

XI = (1, 1)  # u + 1


def _f2_mul_xi(a):
    # (a0 + a1 u)(1 + u) = a0 - a1 + (a0 + a1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def _f6_add(a, b):
    return tuple(_f2_add(x, y) for x, y in zip(a, b))


def _f6_sub(a, b):
    return tuple(_f2_sub(x, y) for x, y in zip(a, b))


def _f6_neg(a):
    return tuple(_f2_neg(x) for x in a)


def _f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = _f2_mul(a0, b0)
    t1 = _f2_mul(a1, b1)
    t2 = _f2_mul(a2, b2)
    c0 = _f2_add(t0, _f2_mul_xi(_f2_sub(
        _f2_mul(_f2_add(a1, a2), _f2_add(b1, b2)), _f2_add(t1, t2))))
    c1 = _f2_add(_f2_sub(
        _f2_mul(_f2_add(a0, a1), _f2_add(b0, b1)), _f2_add(t0, t1)),
        _f2_mul_xi(t2))
    c2 = _f2_add(_f2_sub(
        _f2_mul(_f2_add(a0, a2), _f2_add(b0, b2)), _f2_add(t0, t2)),
        t1)
    return (c0, c1, c2)


def _f6_mul_by_v(a):
    # v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2
    return (_f2_mul_xi(a[2]), a[0], a[1])


def _f6_inv(a):
    a0, a1, a2 = a
    t0 = _f2_sub(_f2_sqr(a0), _f2_mul_xi(_f2_mul(a1, a2)))
    t1 = _f2_sub(_f2_mul_xi(_f2_sqr(a2)), _f2_mul(a0, a1))
    t2 = _f2_sub(_f2_sqr(a1), _f2_mul(a0, a2))
    d = _f2_add(_f2_mul(a0, t0), _f2_mul_xi(
        _f2_add(_f2_mul(a2, t1), _f2_mul(a1, t2))))
    di = _f2_inv(d)
    return (_f2_mul(t0, di), _f2_mul(t1, di), _f2_mul(t2, di))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def _f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = _f6_mul(a0, b0)
    t1 = _f6_mul(a1, b1)
    c0 = _f6_add(t0, _f6_mul_by_v(t1))
    c1 = _f6_sub(_f6_mul(_f6_add(a0, a1), _f6_add(b0, b1)),
                 _f6_add(t0, t1))
    return (c0, c1)


def _f12_sqr(a):
    return _f12_mul(a, a)


def _f12_inv(a):
    a0, a1 = a
    d = _f6_sub(_f6_mul(a0, a0), _f6_mul_by_v(_f6_mul(a1, a1)))
    di = _f6_inv(d)
    return (_f6_mul(a0, di), _f6_neg(_f6_mul(a1, di)))


def _f12_conj(a):
    return (a[0], _f6_neg(a[1]))


F12_ONE = (F6_ONE, F6_ZERO)


def _f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = _f12_mul(out, base)
        base = _f12_sqr(base)
        e >>= 1
    return out


# Frobenius: gamma constants computed at import (xi^((p^k - 1)/6)
# powers), so no long literal tables are carried in source.

def _f2_pow(a, e: int):
    out = F2_ONE
    base = a
    while e:
        if e & 1:
            out = _f2_mul(out, base)
        base = _f2_sqr(base)
        e >>= 1
    return out


_FROB_GAMMA1 = [_f2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def _f2_frob(a):
    """Conjugation: (a0 + a1 u)^p = a0 - a1 u since u^2 = -1."""
    return (a[0], (-a[1]) % P)


def _f6_frob(a):
    c0 = _f2_frob(a[0])
    c1 = _f2_mul(_f2_frob(a[1]), _FROB_GAMMA1[2])
    c2 = _f2_mul(_f2_frob(a[2]), _FROB_GAMMA1[4])
    return (c0, c1, c2)


def _f12_frob(a):
    a0, a1 = a
    c0 = _f6_frob(a0)
    t = _f6_frob(a1)
    c1 = tuple(_f2_mul(x, _FROB_GAMMA1[1]) for x in t)
    return (c0, c1)


# ---------------------------------------------------------------------------
# Curves (Jacobian coordinates over a generic field)
# ---------------------------------------------------------------------------

class _Ops:
    """Field ops bundle so G1 (Fp) and G2 (Fp2) share the point code."""

    def __init__(self, add, sub, neg, mul, sqr, inv, mul_small, zero,
                 one, b):
        self.add, self.sub, self.neg = add, sub, neg
        self.mul, self.sqr, self.inv = mul, sqr, inv
        self.mul_small = mul_small  # field elem x small int
        self.zero, self.one, self.b = zero, one, b


_FP_OPS = _Ops(
    add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
    neg=lambda a: (-a) % P, mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    inv=lambda a: pow(a, P - 2, P) if a else (_ for _ in ()).throw(
        BlsError("Fp inversion of zero")),
    mul_small=lambda a, k: a * k % P,
    zero=0, one=1, b=4)

_FP2_OPS = _Ops(
    add=_f2_add, sub=_f2_sub, neg=_f2_neg, mul=_f2_mul, sqr=_f2_sqr,
    inv=_f2_inv, mul_small=_f2_mul_scalar,
    zero=F2_ZERO, one=F2_ONE, b=_f2_mul_xi((4, 0)))


def _on_curve(ops: _Ops, pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = ops.sqr(y)
    rhs = ops.add(ops.mul(ops.sqr(x), x), ops.b)
    return lhs == rhs


def _pt_add(ops: _Ops, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or y1 == ops.zero:
            return None
        # doubling: l = 3x^2 / 2y
        num = ops.mul_small(ops.sqr(x1), 3)
        den = ops.mul_small(y1, 2)
        lam = ops.mul(num, ops.inv(den))
    else:
        lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sqr(lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _pt_neg(ops: _Ops, pt):
    if pt is None:
        return None
    return (pt[0], ops.neg(pt[1]))


def _pt_mul(ops: _Ops, k: int, pt, reduce: bool = True):
    """``reduce=False`` keeps the raw scalar — REQUIRED for the
    order-r subgroup test, where k=R must not collapse to 0."""
    if reduce:
        k %= R
    out = None
    add = pt
    while k:
        if k & 1:
            out = _pt_add(ops, out, add)
        add = _pt_add(ops, add, add)
        k >>= 1
    return out


# ---------------------------------------------------------------------------
# Public G1/G2 API (affine tuples; None = point at infinity)
# ---------------------------------------------------------------------------

def g1_check(pt, subgroup: bool = True):
    if not _on_curve(_FP_OPS, pt):
        raise BlsError("G1 point not on curve")
    if subgroup and pt is not None and \
            _pt_mul(_FP_OPS, R, pt, reduce=False) is not None:
        raise BlsError("G1 point not in the r-order subgroup")
    return pt


def g2_check(pt, subgroup: bool = True):
    if not _on_curve(_FP2_OPS, pt):
        raise BlsError("G2 point not on curve")
    if subgroup and pt is not None and \
            _pt_mul(_FP2_OPS, R, pt, reduce=False) is not None:
        raise BlsError("G2 point not in the r-order subgroup")
    return pt


def g1_add(a, b):
    return _pt_add(_FP_OPS, a, b)


def g1_mul(k: int, pt):
    return _pt_mul(_FP_OPS, k, pt)


def g1_msm(pairs: List[Tuple[int, object]]):
    out = None
    for k, pt in pairs:
        out = _pt_add(_FP_OPS, out, _pt_mul(_FP_OPS, k, pt))
    return out


def g2_add(a, b):
    return _pt_add(_FP2_OPS, a, b)


def g2_mul(k: int, pt):
    return _pt_mul(_FP2_OPS, k, pt)


def g2_msm(pairs: List[Tuple[int, object]]):
    out = None
    for k, pt in pairs:
        out = _pt_add(_FP2_OPS, out, _pt_mul(_FP2_OPS, k, pt))
    return out


# ---------------------------------------------------------------------------
# Pairing: optimal ate
# ---------------------------------------------------------------------------

def _emb_fp(a: int):
    """Fp -> Fp12."""
    return (((a % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _emb_f2_w2(a):
    """a * w^2 with a in Fp2: w^2 = v -> c0 slot 1 of the Fp6 c0."""
    return ((F2_ZERO, a, F2_ZERO), F6_ZERO)


def _emb_f2_w3(a):
    """a * w^3 = a * v * w -> c1 slot 1."""
    return (F6_ZERO, (F2_ZERO, a, F2_ZERO))


def _emb_f2(a):
    """Fp2 -> Fp12 (constant slot)."""
    return ((a, F2_ZERO, F2_ZERO), F6_ZERO)


# w^2 = v and w^3 = v*w as Fp12 elements, with their inverses
# precomputed once — the untwist divides by them
_W2 = ((F2_ZERO, F2_ONE, F2_ZERO), F6_ZERO)
_W3 = (F6_ZERO, (F2_ZERO, F2_ONE, F2_ZERO))
_W2_INV = _f12_inv(_W2)
_W3_INV = _f12_inv(_W3)


def _emb_g2(q):
    """G2 (twist) point -> E(Fp12): the untwist (x/w^2, y/w^3) — this
    direction verified on-curve (y^2 = x^3 + 4 over Fp12) for the
    published G2 generator."""
    x, y = q
    return (_f12_mul(_emb_f2(x), _W2_INV),
            _f12_mul(_emb_f2(y), _W3_INV))


def _f12_add(a, b):
    return (_f6_add(a[0], b[0]), _f6_add(a[1], b[1]))


def _f12_sub(a, b):
    return (_f6_sub(a[0], b[0]), _f6_sub(a[1], b[1]))


def _f12_is_zero(a):
    return a == (F6_ZERO, F6_ZERO)


def _line_f12(q1, q2, p):
    """Line through embedded G2 points q1, q2 evaluated at embedded
    G1 point p — all in Fp12 (slow, transparent)."""
    x1, y1 = q1
    x2, y2 = q2
    xp, yp = p
    if x1 == x2 and y1 == y2:
        num = _f12_mul(_f12_sqr(x1), _emb_fp(3))
        den = _f12_mul(y1, _emb_fp(2))
        lam = _f12_mul(num, _f12_inv(den))
    elif x1 == x2:
        return _f12_sub(xp, x1)
    else:
        lam = _f12_mul(_f12_sub(y2, y1), _f12_inv(_f12_sub(x2, x1)))
    return _f12_sub(_f12_mul(lam, _f12_sub(xp, x1)),
                    _f12_sub(yp, y1))


def _miller_loop(q, p) -> tuple:
    """f_{|x|, Q}(P) over the embedded points; inverted at the end for
    the negative BLS parameter."""
    if q is None or p is None:
        return F12_ONE
    qe = _emb_g2(q)
    pe = (_emb_fp(p[0]), _emb_fp(p[1]))
    t = qe
    f = F12_ONE
    for bit in bin(BLS_X)[3:]:
        f = _f12_mul(_f12_sqr(f), _line_f12(t, t, pe))
        t2 = _pt_add_f12(t, t)
        t = t2
        if bit == "1":
            f = _f12_mul(f, _line_f12(t, qe, pe))
            t = _pt_add_f12(t, qe)
    if BLS_X_IS_NEG:
        f = _f12_conj(f)  # unitary inverse after final exp's easy part
    return f


def _pt_add_f12(p1, p2):
    """Affine addition on E(Fp12): y^2 = x^3 + 4."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or _f12_is_zero(y1):
            return None
        num = _f12_mul(_f12_sqr(x1), _emb_fp(3))
        den = _f12_mul(y1, _emb_fp(2))
        lam = _f12_mul(num, _f12_inv(den))
    else:
        lam = _f12_mul(_f12_sub(y2, y1), _f12_inv(_f12_sub(x2, x1)))
    x3 = _f12_sub(_f12_sub(_f12_sqr(lam), x1), x2)
    y3 = _f12_sub(_f12_mul(lam, _f12_sub(x1, x3)), y1)
    return (x3, y3)


def _final_exponentiation(f):
    """f^((p^12 - 1) / r) via the (p^6-1)(p^2+1) easy part and a plain
    big-exponent hard part (correctness over speed)."""
    # easy part
    f1 = _f12_mul(_f12_conj(f), _f12_inv(f))       # f^(p^6 - 1)
    f2 = _f12_mul(_f12_frob(_f12_frob(f1)), f1)    # ^(p^2 + 1)
    # hard part: (p^4 - p^2 + 1) / r
    e = (P ** 4 - P ** 2 + 1) // R
    return _f12_pow(f2, e)


def pairing_check(pairs: List[Tuple[object, object]]) -> bool:
    """prod e(P_i, Q_i) == 1 — the multi-pairing check the host
    exposes. P_i in G1, Q_i in G2 (affine or None)."""
    f = F12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue  # e(O, Q) = e(P, O) = 1
        f = _f12_mul(f, _miller_loop(q, p))
    return _final_exponentiation(f) == F12_ONE


# ---------------------------------------------------------------------------
# Serialization (ZCash format: 3 flag bits in the first byte)
# ---------------------------------------------------------------------------

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SORT = 0x20


def g1_encode(pt) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = _FLAG_INFINITY
        return bytes(out)
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big")


def g1_decode(raw: bytes, subgroup_check: bool = True):
    if len(raw) != 96:
        raise BlsError("G1 uncompressed encoding must be 96 bytes")
    flags = raw[0] & 0xE0
    if flags & _FLAG_COMPRESSED:
        raise BlsError("compressed G1 encoding not accepted here")
    if flags & _FLAG_INFINITY:
        if any(raw[1:]) or raw[0] != _FLAG_INFINITY:
            raise BlsError("malformed G1 infinity encoding")
        return None
    x = int.from_bytes(raw[:48], "big")
    y = int.from_bytes(raw[48:], "big")
    if x >= P or y >= P:
        raise BlsError("G1 coordinate out of field range")
    return g1_check((x, y), subgroup=subgroup_check)


def g2_encode(pt) -> bytes:
    if pt is None:
        out = bytearray(192)
        out[0] = _FLAG_INFINITY
        return bytes(out)
    (x0, x1), (y0, y1) = pt
    return (x1.to_bytes(48, "big") + x0.to_bytes(48, "big") +
            y1.to_bytes(48, "big") + y0.to_bytes(48, "big"))


def g2_decode(raw: bytes, subgroup_check: bool = True):
    if len(raw) != 192:
        raise BlsError("G2 uncompressed encoding must be 192 bytes")
    flags = raw[0] & 0xE0
    if flags & _FLAG_COMPRESSED:
        raise BlsError("compressed G2 encoding not accepted here")
    if flags & _FLAG_INFINITY:
        if any(raw[1:]) or raw[0] != _FLAG_INFINITY:
            raise BlsError("malformed G2 infinity encoding")
        return None
    x1 = int.from_bytes(raw[0:48], "big")
    x0 = int.from_bytes(raw[48:96], "big")
    y1 = int.from_bytes(raw[96:144], "big")
    y0 = int.from_bytes(raw[144:192], "big")
    for c in (x0, x1, y0, y1):
        if c >= P:
            raise BlsError("G2 coordinate out of field range")
    return g2_check(((x0, x1), (y0, y1)), subgroup=subgroup_check)


# ---------------------------------------------------------------------------
# Fr scalar field
# ---------------------------------------------------------------------------

def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return a * b % R


def fr_pow(a: int, e: int) -> int:
    return pow(a % R, e, R)


def fr_inv(a: int) -> int:
    a %= R
    if a == 0:
        raise BlsError("Fr inversion of zero")
    return pow(a, R - 2, R)
