"""Short-Weierstrass ECDSA for the soroban crypto host functions:
``recover_key_ecdsa_secp256k1`` and ``verify_sig_ecdsa_secp256r1``
(reference scope: the env interface soroban-env-host exposes; its
implementations are the k256/p256 RustCrypto crates).

Pure-Python Jacobian-coordinate scalar multiplication over the two
curves. Contract-host use only — per-call inputs are budget-capped and
these paths carry no ledger-close hot-loop traffic (that is ed25519,
which has the device batch kernels). Signatures are 64-byte ``r || s``
big-endian; public keys are 65-byte uncompressed SEC1 ``0x04 || X ||
Y`` exactly as the env functions take and return them.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["Curve", "SECP256K1", "SECP256R1", "EcdsaError",
           "verify_ecdsa", "recover_secp256k1"]


class EcdsaError(ValueError):
    pass


class Curve:
    """y^2 = x^3 + a*x + b over F_p, prime order n, generator G."""

    def __init__(self, name: str, p: int, a: int, b: int, n: int,
                 gx: int, gy: int):
        self.name = name
        self.p = p
        self.a = a
        self.b = b
        self.n = n
        self.g = (gx, gy)

    def on_curve(self, pt: Optional[Tuple[int, int]]) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    # ---- Jacobian arithmetic (None = point at infinity) ----

    def _double(self, pt):
        if pt is None:
            return None
        x, y, z = pt
        if y == 0:
            return None
        p = self.p
        ysq = y * y % p
        s = 4 * x * ysq % p
        m = (3 * x * x + self.a * z ** 4) % p
        nx = (m * m - 2 * s) % p
        ny = (m * (s - nx) - 8 * ysq * ysq) % p
        nz = 2 * y * z % p
        return (nx, ny, nz)

    def _add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        p = self.p
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        z1s, z2s = z1 * z1 % p, z2 * z2 % p
        u1 = x1 * z2s % p
        u2 = x2 * z1s % p
        s1 = y1 * z2s * z2 % p
        s2 = y2 * z1s * z1 % p
        if u1 == u2:
            if s1 != s2:
                return None
            return self._double(p1)
        h = (u2 - u1) % p
        r = (s2 - s1) % p
        hs = h * h % p
        hc = hs * h % p
        u1hs = u1 * hs % p
        nx = (r * r - hc - 2 * u1hs) % p
        ny = (r * (u1hs - nx) - s1 * hc) % p
        nz = h * z1 * z2 % p
        return (nx, ny, nz)

    def _to_affine(self, pt):
        if pt is None:
            return None
        x, y, z = pt
        zi = pow(z, self.p - 2, self.p)
        zis = zi * zi % self.p
        return (x * zis % self.p, y * zis * zi % self.p)

    def mul(self, k: int, pt: Optional[Tuple[int, int]]):
        """k * pt in affine coordinates (None = infinity)."""
        if pt is None or k % self.n == 0:
            return None
        acc = None
        add = (pt[0], pt[1], 1)
        k %= self.n
        while k:
            if k & 1:
                acc = self._add(acc, add)
            add = self._double(add)
            k >>= 1
        return self._to_affine(acc)

    def mul_add(self, k1: int, p1, k2: int, p2):
        """k1*p1 + k2*p2 (affine in/out) — ECDSA's hot combination."""
        j1 = self.mul(k1, p1)
        j2 = self.mul(k2, p2)
        if j1 is None:
            return j2
        if j2 is None:
            return j1
        r = self._add((j1[0], j1[1], 1), (j2[0], j2[1], 1))
        return self._to_affine(r)

    def lift_x(self, x: int, odd_y: bool) -> Tuple[int, int]:
        """Point with abscissa ``x`` and chosen y parity, or raise."""
        p = self.p
        rhs = (x * x * x + self.a * x + self.b) % p
        # both supported curves have p % 4 == 3
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p != rhs:
            raise EcdsaError("x is not on the curve")
        if (y & 1) != odd_y:
            y = p - y
        return (x, y)


SECP256K1 = Curve(
    "secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

SECP256R1 = Curve(
    "secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)


def _decode_point(curve: Curve, pk: bytes) -> Tuple[int, int]:
    if len(pk) != 65 or pk[0] != 0x04:
        raise EcdsaError("public key must be 65-byte uncompressed SEC1")
    x = int.from_bytes(pk[1:33], "big")
    y = int.from_bytes(pk[33:65], "big")
    if x >= curve.p or y >= curve.p:
        raise EcdsaError("public key coordinate out of range")
    pt = (x, y)
    if not curve.on_curve(pt):
        raise EcdsaError("public key not on curve")
    return pt


def _decode_sig(curve: Curve, sig: bytes) -> Tuple[int, int]:
    if len(sig) != 64:
        raise EcdsaError("signature must be 64 bytes r||s")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < curve.n) or not (1 <= s < curve.n):
        raise EcdsaError("signature scalar out of range")
    return r, s


def verify_ecdsa(curve: Curve, pk: bytes, digest: bytes,
                 sig: bytes) -> bool:
    """ECDSA verify over a 32-byte message digest. Enforces low-S
    (s <= n/2), matching the soroban host's malleability rule."""
    q = _decode_point(curve, pk)
    r, s = _decode_sig(curve, sig)
    if s > curve.n // 2:
        raise EcdsaError("signature s is not normalized (high-S)")
    if len(digest) != 32:
        raise EcdsaError("digest must be 32 bytes")
    e = int.from_bytes(digest, "big") % curve.n
    si = pow(s, curve.n - 2, curve.n)
    u1 = e * si % curve.n
    u2 = r * si % curve.n
    pt = curve.mul_add(u1, curve.g, u2, q)
    if pt is None:
        return False
    return pt[0] % curve.n == r


def recover_secp256k1(digest: bytes, sig: bytes,
                      recovery_id: int) -> bytes:
    """Recover the uncompressed SEC1 public key from an ECDSA
    signature over secp256k1 (the soroban/Ethereum ecrecover shape:
    64-byte r||s plus recovery id 0-3)."""
    curve = SECP256K1
    if recovery_id not in (0, 1, 2, 3):
        raise EcdsaError("recovery id must be 0..3")
    if len(digest) != 32:
        raise EcdsaError("digest must be 32 bytes")
    r, s = _decode_sig(curve, sig)
    if s > curve.n // 2:
        raise EcdsaError("signature s is not normalized (high-S)")
    x = r
    if recovery_id >= 2:
        x += curve.n
        if x >= curve.p:
            raise EcdsaError("recovery x out of field range")
    rp = curve.lift_x(x, odd_y=bool(recovery_id & 1))
    e = int.from_bytes(digest, "big") % curve.n
    ri = pow(r, curve.n - 2, curve.n)
    # Q = r^-1 (s*R - e*G)
    neg_e = (-e) % curve.n
    sr = curve.mul_add(s, rp, neg_e, curve.g)
    if sr is None:
        raise EcdsaError("degenerate recovery")
    q = curve.mul(ri, sr)
    if q is None:
        raise EcdsaError("degenerate recovery")
    return b"\x04" + q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
