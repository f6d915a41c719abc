"""The port's signing identity against the reference's: StrKey
(``crypto/strkey.py``), the hashing helpers (``crypto/sha.py``), the
identity half of ``crypto/keys.py`` (``PublicKey``, ``SecretKey``) and
the hint helpers of ``tx/signature_utils.py``.

The reference signs through OpenSSL where ``cryptography`` is installed;
the port signs in pure Python. RFC 8032 signing is deterministic, so the
signatures are held byte for byte.
"""

import random

import numpy as np
import pytest

from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.crypto import sha as jsha
from stellar_tpu.crypto import strkey as jstr
from stellar_tpu.tx import signature_utils as jsu
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.crypto import sha as psha
from stellar_tpu_torch.crypto import strkey as pstr
from stellar_tpu_torch.tx import signature_utils as psu
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx
from stellar_tpu_torch.xdr import types as ptypes


def _seeds(n=64, seed=1210):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


@pytest.mark.parametrize("kind", ["account", "seed", "contract"])
def test_strkey_round_trip_equals_reference(kind):
    enc_p, dec_p = getattr(pstr, f"encode_{kind}"), \
        getattr(pstr, f"decode_{kind}")
    enc_j, dec_j = getattr(jstr, f"encode_{kind}"), \
        getattr(jstr, f"decode_{kind}")
    for raw in _seeds(32):
        s = enc_p(raw)
        assert s == enc_j(raw)
        assert s[0] == {"account": "G", "seed": "S", "contract": "C"}[kind]
        assert dec_p(s) == dec_j(s) == raw


@pytest.mark.parametrize("version", [
    "VER_ACCOUNT", "VER_MUXED_ACCOUNT", "VER_SEED", "VER_PRE_AUTH_TX",
    "VER_HASH_X", "VER_SIGNED_PAYLOAD", "VER_CONTRACT"])
def test_strkey_versions_equal_reference(version):
    v = getattr(pstr, version)
    assert v == getattr(jstr, version)
    rng = np.random.default_rng(1211)
    for n in (0, 1, 32, 40, 68):
        raw = rng.bytes(n)
        s = pstr.encode(v, raw)
        assert s == jstr.encode(v, raw)
        assert pstr.decode(v, s) == jstr.decode(v, s) == raw


def _bad_strkeys():
    good = pstr.encode_account(bytes(range(32)))
    flipped = good[:10] + ("A" if good[10] != "A" else "B") + good[11:]
    return {
        "checksum": (pstr.decode_account, jstr.decode_account, flipped),
        "version": (pstr.decode_account, jstr.decode_account,
                    pstr.encode_seed(bytes(32))),
        "case": (pstr.decode_account, jstr.decode_account, good.lower()),
        "padding": (pstr.decode_account, jstr.decode_account, good + "="),
        "non-canonical": (pstr.decode_account, jstr.decode_account,
                          good[:-1] + "R"),
        "length": (pstr.decode_account, jstr.decode_account,
                   pstr.encode(pstr.VER_ACCOUNT, bytes(31))),
        "seed length": (pstr.decode_seed, jstr.decode_seed,
                        pstr.encode(pstr.VER_SEED, bytes(33))),
        "contract length": (pstr.decode_contract, jstr.decode_contract,
                            pstr.encode(pstr.VER_CONTRACT, bytes(16))),
        "too short": (pstr.decode_account, jstr.decode_account, "GA"),
        "empty": (pstr.decode_account, jstr.decode_account, ""),
        "base32": (pstr.decode_account, jstr.decode_account, "G1" * 28),
    }


@pytest.mark.parametrize("case", sorted(_bad_strkeys()))
def test_strkey_errors_equal_reference(case):
    dec_p, dec_j, s = _bad_strkeys()[case]
    with pytest.raises(pstr.StrKeyError) as pe:
        dec_p(s)
    with pytest.raises(jstr.StrKeyError) as je:
        dec_j(s)
    assert str(pe.value) == str(je.value)
    assert isinstance(pe.value, ValueError)


def test_sha_helpers_equal_reference():
    rng = np.random.default_rng(1212)
    for n in (0, 1, 55, 56, 64, 200, 1000):
        data, key = rng.bytes(n), rng.bytes(32)
        assert psha.sha256(data) == jsha.sha256(data)
        assert psha.sha512(data) == jsha.sha512(data)
        mac = psha.hmac_sha256(key, data)
        assert mac == jsha.hmac_sha256(key, data)
        assert psha.hmac_sha256_verify(mac, key, data)
        assert not psha.hmac_sha256_verify(mac[:-1] + b"\0", key, data)
        assert psha.hkdf_extract(data) == jsha.hkdf_extract(data)
        assert psha.hkdf_expand(key, data) == jsha.hkdf_expand(key, data)
        hp, hj = psha.SHA256(), jsha.SHA256()
        for k in range(0, n, 17):
            hp.add(data[k:k + 17])
            hj.add(data[k:k + 17])
        assert hp.finish() == hj.finish() == jsha.sha256(data)
    h = psha.SHA256()
    h.finish()
    with pytest.raises(RuntimeError, match="finish twice"):
        h.finish()
    with pytest.raises(RuntimeError, match="add after finish"):
        h.add(b"x")
    h.reset()
    assert h.add(b"abc").finish() == jsha.sha256(b"abc")


def test_secret_keys_sign_byte_for_byte_as_reference():
    """64 seeds: the same public keys, StrKeys, signatures and decorated
    signatures (compared as XDR) as the reference's."""
    rng = np.random.default_rng(1213)
    for seed in _seeds():
        p, j = pkeys.SecretKey(seed), jkeys.SecretKey(seed)
        assert p.public_key.raw == j.public_key.raw
        assert p.to_strkey_seed() == j.to_strkey_seed()
        assert p.public_key.to_strkey() == j.public_key.to_strkey()
        msg = rng.bytes(int(rng.integers(0, 300)))
        sig = p.sign(msg)
        assert sig == j.sign(msg)
        assert pkeys.verify_sig(p.public_key, msg, sig)
        dp, dj = p.sign_decorated(msg), j.sign_decorated(msg)
        assert prt.to_bytes(ptx.DecoratedSignature, dp) == \
            jrt.to_bytes(jtx.DecoratedSignature, dj)
        assert dp.hint == p.public_key.hint() == psu.get_hint(
            p.public_key.raw)
        dp2 = psu.sign_decorated(p, msg)
        assert (dp2.hint, dp2.signature) == (dp.hint, dp.signature)


def test_public_key_conveniences_equal_reference():
    for seed in _seeds(8, 1214):
        p = pkeys.SecretKey(seed).public_key
        j = jkeys.SecretKey(seed).public_key
        s = p.to_strkey()
        assert pkeys.PublicKey.from_strkey(s) == p
        assert hash(pkeys.PublicKey.from_strkey(s)) == hash(p)
        assert repr(p) == repr(j)
        assert prt.to_bytes(ptypes.PublicKey, p.to_xdr()) == \
            jrt.to_bytes(jtypes.PublicKey, j.to_xdr())
        assert pkeys.PublicKey.from_xdr(p.to_xdr()) == p
        assert p.hint() == j.hint()
        sk = pkeys.SecretKey.from_strkey_seed(
            pkeys.SecretKey(seed).to_strkey_seed())
        assert sk == pkeys.SecretKey(seed) and sk.get_public_key() == p
        assert repr(sk) == repr(jkeys.SecretKey(seed))
    with pytest.raises(ValueError, match="32 bytes"):
        pkeys.PublicKey(bytes(31))
    with pytest.raises(ValueError, match="32 bytes"):
        pkeys.SecretKey(bytes(33))


def test_derived_keys_equal_reference():
    for name in ("root", "alice", "bob", "a" * 100):
        assert pkeys.SecretKey.from_seed_str(name).seed == \
            jkeys.SecretKey.from_seed_str(name).seed
    state = random.getstate()
    try:
        random.seed(1215)
        p = pkeys.SecretKey.pseudo_random_for_testing()
        random.seed(1215)
        j = jkeys.SecretKey.pseudo_random_for_testing()
    finally:
        random.setstate(state)
    assert p.seed == j.seed
    a, b = pkeys.SecretKey.random(), pkeys.SecretKey.random()
    assert a != b and len(a.seed) == 32


def test_hint_helpers_equal_reference():
    rng = np.random.default_rng(1216)
    for n in (0, 1, 3, 4, 32, 64):
        bs = rng.bytes(n)
        assert psu.get_hint(bs) == jsu.get_hint(bs)
        hint = rng.bytes(4) if n < 4 else bs[-4:]
        assert psu.does_hint_match(bs, hint) == \
            jsu.does_hint_match(bs, hint)
    pre = rng.bytes(32)
    dp, dj = psu.sign_hash_x(pre), jsu.sign_hash_x(pre)
    assert (dp.hint, dp.signature) == (dj.hint, dj.signature)
    assert psu.verify_hash_x(dp, psha.sha256(pre))
    assert not psu.verify_hash_x(dp, psha.sha256(pre + b"!"))
    sp = ptypes.SignerKeyEd25519SignedPayload(ed25519=rng.bytes(32),
                                              payload=rng.bytes(20))
    spj = jtypes.SignerKeyEd25519SignedPayload(ed25519=sp.ed25519,
                                               payload=sp.payload)
    assert psu.signed_payload_hint(sp) == jsu.signed_payload_hint(spj)


def test_verify_sig_takes_a_public_key():
    """As the reference's, the port's ``verify_sig`` and
    ``cached_verify_sig`` take a ``PublicKey`` or its raw bytes."""
    sk = pkeys.SecretKey(_seeds(1, 1217)[0])
    sig = sk.sign(b"m")
    pkeys.flush_verify_cache()
    try:
        assert pkeys.cached_verify_sig(sk.public_key, b"m", sig) is None
        assert pkeys.verify_sig(sk.public_key, b"m", sig)
        assert pkeys.cached_verify_sig(sk.public_key.raw, b"m", sig)
        assert pkeys.cached_verify_sig(sk.public_key, b"m", sig)
        assert not pkeys.verify_sig(sk.public_key, b"n", sig)
        assert pkeys.get_verify_cache_stats()["size"] == 2
    finally:
        pkeys.flush_verify_cache()


def test_all_names_equal_reference():
    assert set(pkeys.__all__) >= set(jkeys.__all__)
    assert psha.__all__ == jsha.__all__
    assert pstr.__all__ == jstr.__all__
    assert psu.__all__ == jsu.__all__
    assert pkeys.sign_ops_per_second(3) > 0
    assert pkeys.verify_ops_per_second(3) > 0
