"""BLS12-381 hash-to-curve (RFC 9380 hash_to_curve / SSWU + isogeny).

The isogeny constants in ``_h2c_constants.py`` are DERIVED AND VERIFIED
from first principles by ``tools/derive_h2c.py`` (Velu quotient by the
rational order-11 subgroup for G1, the Galois-stable 3-kernel for G2,
dual isogeny by linear solve against the multiplication-by-ell map).
The derivation independently reproduced the RFC's own published
parameters — G1 E' A' = 0x144698a3..., Z = 11; G2 B' = 1012(1+i),
Z = -(2+i); G2 h_eff = 3(z^2-1)·h2 — and an external RFC-test-vector
cross-check pinned the one freedom Velu cannot see (the Aut(E)
representative on the j=0 codomain, carried as ``post_x_mul`` /
``post_y_mul``). G1 is byte-exact against the RFC vectors.

Suites: BLS12381G1_XMD:SHA-256_SSWU_RO_ and
BLS12381G2_XMD:SHA-256_SSWU_RO_ (the ciphersuites the soroban host's
``bls12_381_hash_to_g1``/``_g2`` use; the DST is caller-supplied).
Reference boundary: the p22 soroban host's CAP-59 exports
(the reference's ``src/rust/Cargo.toml:51-80``).
"""

import hashlib

from stellar_tpu_torch.crypto import _h2c_constants as C
from stellar_tpu_torch.crypto.bls12_381 import (
    _FP2_OPS, _FP_OPS, _f2_add, _f2_inv, _f2_mul, _f2_neg, _f2_sub,
    _pt_add, _pt_mul, P,
)

__all__ = ["hash_to_g1", "hash_to_g2", "map_fp_to_g1", "map_fp2_to_g2",
           "expand_message_xmd", "hash_to_field_fp", "hash_to_field_fp2"]

_L = 64  # ceil((381 + 128) / 8), both fields


# ---------------------------------------------------------------------------
# expand_message_xmd (RFC 9380 §5.3.1, SHA-256)
# ---------------------------------------------------------------------------

def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    h = hashlib.sha256
    b_in_bytes = 32
    s_in_bytes = 64
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter overflow")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(s_in_bytes)
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b1 = h(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    prev = b1
    for i in range(2, ell + 1):
        prev = h(bytes(x ^ y for x, y in zip(b0, prev)) +
                 bytes([i]) + dst_prime).digest()
        out.append(prev)
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fp(msg: bytes, dst: bytes, count: int):
    uniform = expand_message_xmd(msg, dst, count * _L)
    return [int.from_bytes(uniform[i * _L:(i + 1) * _L], "big") % P
            for i in range(count)]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int):
    uniform = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        off = i * 2 * _L
        c0 = int.from_bytes(uniform[off:off + _L], "big") % P
        c1 = int.from_bytes(uniform[off + _L:off + 2 * _L], "big") % P
        out.append((c0, c1))
    return out


# ---------------------------------------------------------------------------
# sqrt / sgn0 (not provided by bls12_381's op bundles)
# ---------------------------------------------------------------------------

def _fp_sqrt(a):
    s = pow(a, (P + 1) // 4, P)  # P % 4 == 3
    return s if s * s % P == a % P else None


def _fp_is_square(a):
    return a % P == 0 or pow(a, (P - 1) // 2, P) == 1


def _fp2_is_square(a):
    if a[0] % P == 0 and a[1] % P == 0:
        return True
    n = (a[0] * a[0] + a[1] * a[1]) % P
    return pow(n, (P - 1) // 2, P) == 1


def _fp2_sqrt(a):
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        s = _fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = _fp_sqrt((-a0) % P)
        return None if s is None else (0, s)
    n = (a0 * a0 + a1 * a1) % P
    s = _fp_sqrt(n)
    if s is None:
        return None
    inv2 = (P + 1) // 2
    for sg in (s, (-s) % P):
        x0 = _fp_sqrt((a0 + sg) * inv2 % P)
        if not x0:
            continue
        x1 = a1 * pow(2 * x0 % P, P - 2, P) % P
        if _f2_mul((x0, x1), (x0, x1)) == (a0, a1):
            return (x0, x1)
    return None


def _sgn0_fp(x):
    return x % 2


def _sgn0_fp2(x):
    # RFC 9380 §4.1 sgn0 for m=2
    return x[0] % 2 if x[0] % P != 0 else x[1] % 2


class _FpExt:
    """SSWU-side field bundle for Fp (bls12_381's _Ops lacks
    sqrt/is_square/sgn0, and its point code is pinned to A = 0 — the
    isogenous curve E' has A != 0, so the SSWU internals stay here)."""
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(lambda a, b: (a * b) % P)
    neg = staticmethod(lambda a: (-a) % P)
    inv = staticmethod(lambda a: pow(a, P - 2, P))
    is_zero = staticmethod(lambda a: a % P == 0)
    is_square = staticmethod(_fp_is_square)
    sqrt = staticmethod(_fp_sqrt)
    sgn0 = staticmethod(_sgn0_fp)
    one = 1


class _Fp2Ext:
    add = staticmethod(_f2_add)
    sub = staticmethod(_f2_sub)
    mul = staticmethod(_f2_mul)
    neg = staticmethod(_f2_neg)
    inv = staticmethod(_f2_inv)
    is_zero = staticmethod(lambda a: a[0] % P == 0 and a[1] % P == 0)
    is_square = staticmethod(_fp2_is_square)
    sqrt = staticmethod(_fp2_sqrt)
    sgn0 = staticmethod(_sgn0_fp2)
    one = (1, 0)


def _from_int(F, n):
    return n % P if F is _FpExt else (n % P, 0)


# ---------------------------------------------------------------------------
# simplified SWU + isogeny evaluation
# ---------------------------------------------------------------------------

def _sswu(F, A, B, Z, u, consts=None):
    """RFC 9380 §6.6.2 simplified SWU: u -> (x, y) on E': y^2 =
    x^3 + A x + B. ``consts`` optionally carries the precomputed
    per-curve inversions (-B/A and B/(Z*A))."""
    u2 = F.mul(u, u)
    zu2 = F.mul(Z, u2)
    tv = F.add(F.mul(zu2, zu2), zu2)          # Z^2 u^4 + Z u^2
    if consts is None:
        consts = (F.mul(F.neg(B), F.inv(A)),
                  F.mul(B, F.inv(F.mul(Z, A))))
    if F.is_zero(tv):
        x1 = consts[1]                        # exceptional case
    else:
        x1 = F.mul(consts[0], F.add(F.one, F.inv(tv)))

    def g(x):
        return F.add(F.add(F.mul(F.mul(x, x), x), F.mul(A, x)), B)

    gx1 = g(x1)
    if F.is_square(gx1):
        x, y = x1, F.sqrt(gx1)
    else:
        x2 = F.mul(zu2, x1)
        y = F.sqrt(g(x2))
        if y is None:  # cannot happen for valid Z; defensive
            raise ValueError("SSWU: neither branch square")
        x = x2
    if F.sgn0(u) != F.sgn0(y):
        y = F.neg(y)
    return x, y


def _iso_eval(F, cfg, x, y):
    """Evaluate the derived dual isogeny E' -> E at (x, y):
    X = N(x)/D(x), Y = y * (N'D - ND')(x) / (ell * D(x)^2), then the
    Aut(E) post-composition pinned by the RFC-vector cross-check."""
    num = cfg["iso_num"]
    den = cfg["iso_den"]

    def ev(poly, at):
        acc = None
        for c in reversed(poly):
            acc = c if acc is None else F.add(F.mul(acc, at), c)
        return acc

    def evd(poly, at):  # derivative eval
        acc = None
        for i in range(len(poly) - 1, 0, -1):
            term = F.mul(poly[i], _from_int(F, i))
            acc = term if acc is None else F.add(F.mul(acc, at), term)
        return acc

    d = ev(den, x)
    if F.is_zero(d):
        return None  # maps to infinity
    n_ = ev(num, x)
    dinv = F.inv(d)
    X = F.mul(n_, dinv)
    slope = F.sub(F.mul(evd(num, x), d), F.mul(n_, evd(den, x)))
    Y = F.mul(F.mul(y, F.mul(slope, F.mul(dinv, dinv))),
              cfg["_ell_inv"])
    return (F.mul(X, cfg["post_x_mul"]), F.mul(Y, cfg["post_y_mul"]))


def _prep_cfg(F, cfg):
    """Memoize the per-curve constant inversions on the config dict
    (they never change; inversions dominate the per-map field cost)."""
    if "_sswu_consts" not in cfg:
        A, B, Z = cfg["A2"], cfg["B2"], cfg["Z"]
        cfg["_sswu_consts"] = (F.mul(F.neg(B), F.inv(A)),
                              F.mul(B, F.inv(F.mul(Z, A))))
        cfg["_ell_inv"] = F.inv(_from_int(F, cfg["ell"]))
    return cfg


def _map_to_curve(F, cfg, u):
    """RFC 9380 map_to_curve: SSWU + isogeny, NO cofactor clearing —
    exactly the reference host's map_fp(2)_to_g1(2) semantics (arkworks
    WBMap); the output is on E but generally NOT in the r-subgroup."""
    _prep_cfg(F, cfg)
    x, y = _sswu(F, cfg["A2"], cfg["B2"], cfg["Z"], u,
                 cfg["_sswu_consts"])
    return _iso_eval(F, cfg, x, y)


# ---------------------------------------------------------------------------
# public maps (point arithmetic on E reuses bls12_381's shared code)
# ---------------------------------------------------------------------------

def map_fp_to_g1(u: int):
    """RFC 9380 map_to_curve for one Fp element: SSWU + isogeny, NO
    cofactor clearing (the reference host's map_fp_to_g1 returns the
    uncleared point — on-curve, generally outside the r-subgroup).
    Returns an affine (x, y) point on E or None (infinity)."""
    return _map_to_curve(_FpExt, C.G1, u % P)


def map_fp2_to_g2(u):
    return _map_to_curve(_Fp2Ext, C.G2, (u[0] % P, u[1] % P))


def hash_to_g1(msg: bytes, dst: bytes):
    """RFC 9380 hash_to_curve (random-oracle variant) into G1."""
    u0, u1 = hash_to_field_fp(msg, dst, 2)
    q0 = _map_to_curve(_FpExt, C.G1, u0)
    q1 = _map_to_curve(_FpExt, C.G1, u1)
    s = _pt_add(_FP_OPS, q0, q1)
    return _pt_mul(_FP_OPS, C.H_EFF_G1, s, reduce=False) \
        if s is not None else None


def hash_to_g2(msg: bytes, dst: bytes):
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    q0 = _map_to_curve(_Fp2Ext, C.G2, u0)
    q1 = _map_to_curve(_Fp2Ext, C.G2, u1)
    s = _pt_add(_FP2_OPS, q0, q1)
    return _pt_mul(_FP2_OPS, C.H_EFF_G2, s, reduce=False) \
        if s is not None else None
