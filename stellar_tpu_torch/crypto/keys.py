"""The node's signing identity, verify cache and backend seam — the
port's copy of ``stellar_tpu/crypto/keys.py``.

``verify_sig`` is the ``PubKeyUtils::verifySig`` equivalent: every
single-signature verification funnels through it, with a 0xffff-entry
random-eviction result cache (``crypto/SecretKey.cpp:44-48,435-468``) in
front of a pluggable backend. The cache key is SHA-256 of
``pk + sig + msg``.

Backends:

* the pure-Python libsodium-exact oracle
  (:func:`stellar_tpu_torch.crypto.ed25519_ref.verify`; the default);
* a card :class:`~stellar_tpu_torch.crypto.batch_verifier.BatchVerifier`,
  installed with :meth:`~stellar_tpu_torch.crypto.batch_verifier.
  BatchVerifier.install` (optionally behind a
  :class:`~stellar_tpu_torch.crypto.batch_verifier.TrickleBatcher`), or
  any ``(pk, msg, sig) -> bool`` through :func:`set_verifier_backend`.

Bulk paths prefetch with :func:`batch_verify_into_cache` and then call
``verify_sig`` row by row. With no backend installed and at least
``MIN_DEVICE_BATCH`` rows to verify, the prefetch runs on the port's
:func:`~stellar_tpu_torch.crypto.batch_verifier.default_verifier`, on the
card; with no card it raises, where the reference verifies on the host
(the port has no host failover: ROADMAP.md, divergences). Below
``MIN_DEVICE_BATCH`` it uses what ``verify_sig`` would: the installed
backend or the oracle.

The identity half is the reference's: :class:`PublicKey` (32 bytes with
StrKey, XDR and the signature hint) and :class:`SecretKey` (a 32-byte
seed; signing through the port's pure-Python
:func:`~stellar_tpu_torch.crypto.ed25519_ref.sign`, RFC 8032, so its
signatures are byte for byte the reference's). ``verify_sig`` takes a
:class:`PublicKey` or 32 raw bytes.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from stellar_tpu_torch.crypto import ed25519_ref as _ref
from stellar_tpu_torch.crypto import strkey as _strkey
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.utils.cache import RandomEvictionCache

__all__ = [
    "SecretKey", "PublicKey", "verify_sig", "cached_verify_sig",
    "seed_verify_cache", "set_verifier_backend",
    "get_verifier_backend_name",
    "get_verify_cache_stats", "flush_verify_cache",
    "sign_ops_per_second", "verify_ops_per_second",
    "VERIFY_CACHE_SIZE", "MIN_DEVICE_BATCH", "batch_verify_into_cache",
    "seed_cache_assume_valid", "accelerated_verify_available",
    "cache_keyable",
]

VERIFY_CACHE_SIZE = 0xFFFF
# below this, batch_verify_into_cache uses the installed backend or the
# oracle row by row
MIN_DEVICE_BATCH = 32

_cache_lock = threading.Lock()
_verify_cache: RandomEvictionCache = RandomEvictionCache(VERIFY_CACHE_SIZE)
_backend: Optional[Callable[[bytes, bytes, bytes], bool]] = None


class PublicKey:
    """32-byte ed25519 public key with StrKey and XDR conveniences."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("public key must be 32 bytes")
        self.raw = bytes(raw)

    @classmethod
    def from_strkey(cls, s: str) -> "PublicKey":
        return cls(_strkey.decode_account(s))

    def to_strkey(self) -> str:
        return _strkey.encode_account(self.raw)

    def to_xdr(self):
        from stellar_tpu_torch.xdr.types import account_id
        return account_id(self.raw)

    @classmethod
    def from_xdr(cls, v) -> "PublicKey":
        return cls(v.value)

    def hint(self) -> bytes:
        """Signature hint: the key's last 4 bytes (reference
        ``SignatureUtils::getHint``)."""
        return self.raw[-4:]

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.raw == other.raw

    def __hash__(self):
        return hash(self.raw)

    def __repr__(self):
        return f"PublicKey({self.to_strkey()})"


class SecretKey:
    """Seed-based ed25519 secret key (reference ``SecretKey.h:22``)."""

    __slots__ = ("seed", "_pk")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.seed = bytes(seed)
        self._pk: Optional[PublicKey] = None

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(os.urandom(32))

    @classmethod
    def from_strkey_seed(cls, s: str) -> "SecretKey":
        return cls(_strkey.decode_seed(s))

    @classmethod
    def pseudo_random_for_testing(cls) -> "SecretKey":
        """A key from the process ``random`` stream, not a CSPRNG
        (reference ``SecretKey.h:66-77``)."""
        import random
        return cls(bytes(random.getrandbits(8) for _ in range(32)))

    @classmethod
    def from_seed_str(cls, s: str) -> "SecretKey":
        """A key from any string: seed = SHA-256(s) (the reference tests'
        getAccount pattern)."""
        return cls(sha256(s.encode() if isinstance(s, str) else s))

    def to_strkey_seed(self) -> str:
        return _strkey.encode_seed(self.seed)

    @property
    def public_key(self) -> PublicKey:
        if self._pk is None:
            self._pk = PublicKey(_ref.secret_to_public(self.seed))
        return self._pk

    def get_public_key(self) -> PublicKey:
        return self.public_key

    def sign(self, msg: bytes) -> bytes:
        return _ref.sign(self.seed, msg)

    def sign_decorated(self, msg: bytes):
        from stellar_tpu_torch.xdr.tx import DecoratedSignature
        return DecoratedSignature(hint=self.public_key.hint(),
                                  signature=self.sign(msg))

    def __eq__(self, other):
        return isinstance(other, SecretKey) and self.seed == other.seed

    def __hash__(self):
        return hash(self.seed)

    def __repr__(self):
        return f"SecretKey({self.public_key.to_strkey()})"


def set_verifier_backend(fn: Optional[Callable[[bytes, bytes, bytes], bool]]):
    """Install a verify backend ``(pk, msg, sig) -> bool``; None restores
    the pure-Python oracle. The result cache stays in front either
    way."""
    global _backend
    with _cache_lock:
        _backend = fn


def accelerated_verify_available() -> bool:
    """True when bulk verification is worth collecting for: a backend is
    installed, or the device probe says a card answers (asked without
    waiting)."""
    if _backend is not None:
        return True
    from stellar_tpu_torch.crypto import batch_verifier
    return batch_verifier.device_available(block=False)


def get_verifier_backend_name() -> str:
    """Which backend serves verification now, for attributing a
    benchmark's numbers."""
    if _backend is None:
        from stellar_tpu_torch.parallel import batch_engine
        state = batch_engine._device_state  # no probe side effect
        return f"auto(host<{MIN_DEVICE_BATCH},device-batch>=" \
            f"{MIN_DEVICE_BATCH},device={state or 'unprobed'})"
    self_obj = getattr(_backend, "__self__", None)
    if self_obj is not None:
        name = type(self_obj).__name__
        if name == "TrickleBatcher":
            return "device-batch+trickle"
        if hasattr(self_obj, "verify_batch"):
            return "device-batch"
        return name
    mod = getattr(_backend, "__module__", "")
    if "ed25519_ref" in mod:
        return "host-oracle"
    return getattr(_backend, "__qualname__", "custom")


def cache_keyable(pk: bytes, sig: bytes) -> bool:
    """Whether the verify cache keys a triple with this key and
    signature: a 32-byte key and a 64-byte signature. Any other triple is
    answered ``False`` without a lookup and never enters the cache."""
    return len(pk) == 32 and len(sig) == 64


def _cache_key(pk: bytes, msg: bytes, sig: bytes) -> bytes:
    # pk and sig pass cache_keyable before this is called, so the
    # concatenation's field boundaries are unambiguous
    return sha256(pk + sig + msg)


def verify_sig(pk, msg: bytes, sig: bytes) -> bool:
    """The ``PubKeyUtils::verifySig`` equivalent: the cache, then the
    backend (the oracle when none is installed)."""
    raw = pk.raw if isinstance(pk, PublicKey) else bytes(pk)
    if not cache_keyable(raw, sig):
        return False
    key = _cache_key(raw, msg, sig)
    with _cache_lock:
        got = _verify_cache.maybe_get(key)
    if got is not None:
        return got
    fn = _backend or _ref.verify
    ok = bool(fn(raw, msg, sig))
    with _cache_lock:
        _verify_cache.put(key, ok)
    return ok


def cached_verify_sig(pk, msg: bytes, sig: bytes) -> Optional[bool]:
    """Cache-only lookup of an earlier ``verify_sig`` answer (``None`` on
    a miss). Malformed lengths answer ``False``, as ``verify_sig``
    does."""
    raw = pk.raw if isinstance(pk, PublicKey) else bytes(pk)
    if not cache_keyable(raw, sig):
        return False
    with _cache_lock:
        return _verify_cache.maybe_get(_cache_key(raw, msg, sig))


def seed_verify_cache(results) -> None:
    """Seed the result cache with decided ``(pk, msg, sig, ok)``
    quadruples: how the verify service's verdicts keep the cache
    consistent with the direct path."""
    keyed = [(_cache_key(pk, msg, sig), bool(ok))
             for pk, msg, sig, ok in results
             if cache_keyable(pk, sig)]
    with _cache_lock:
        for k, ok in keyed:
            _verify_cache.put(k, ok)


def batch_verify_into_cache(items) -> None:
    """Verify ``(pk, msg, sig)`` triples in one batch and seed the result
    cache, so later ``verify_sig`` calls for them are lookups: how bulk
    validation (TxSet checkValid, SCP envelope floods, catchup replay)
    rides the card. Triples already cached are skipped. At least
    ``MIN_DEVICE_BATCH`` to verify go to the installed backend's
    ``verify_batch`` (a scalar backend row by row), or with none to
    :func:`~stellar_tpu_torch.crypto.batch_verifier.default_verifier`,
    which raises when there is no card."""
    keyed = [(_cache_key(pk, msg, sig), pk, msg, sig)
             for pk, msg, sig in items
             if cache_keyable(pk, sig)]
    with _cache_lock:
        todo = [(k, pk, msg, sig) for k, pk, msg, sig in keyed
                if _verify_cache.maybe_get(k) is None]
    if not todo:
        return
    if len(todo) < MIN_DEVICE_BATCH:
        # not worth a dispatch: exactly what verify_sig would use, so
        # both paths cache the same answers
        fn = _backend or _ref.verify
        results = [fn(pk, msg, sig) for _, pk, msg, sig in todo]
    elif _backend is not None:
        if hasattr(_backend, "__self__") and \
                hasattr(_backend.__self__, "verify_batch"):
            results = _backend.__self__.verify_batch(
                [(pk, msg, sig) for _, pk, msg, sig in todo])
        else:
            # a scalar backend: stay consistent with verify_sig
            results = [_backend(pk, msg, sig) for _, pk, msg, sig in todo]
    else:
        from stellar_tpu_torch.crypto import batch_verifier
        results = batch_verifier.default_verifier().verify_batch(
            [(pk, msg, sig) for _, pk, msg, sig in todo])
    with _cache_lock:
        for (k, _, _, _), ok in zip(todo, results):
            _verify_cache.put(k, bool(ok))


def seed_cache_assume_valid(items) -> int:
    """Mark ``(pk, msg, sig)`` triples valid in the cache without
    verifying them. Only for replaying history whose results are already
    trusted (the reference's ``CATCHUP_SKIP_KNOWN_RESULTS_FOR_TESTING``).
    Returns how many were marked."""
    keyed = [_cache_key(pk, msg, sig) for pk, msg, sig in items
             if cache_keyable(pk, sig)]
    with _cache_lock:
        for k in keyed:
            _verify_cache.put(k, True)
    return len(keyed)


def flush_verify_cache():
    with _cache_lock:
        _verify_cache.clear()
        _verify_cache.hits = 0
        _verify_cache.misses = 0


def get_verify_cache_stats() -> dict:
    with _cache_lock:
        return {"hits": _verify_cache.hits, "misses": _verify_cache.misses,
                "size": len(_verify_cache)}


def sign_ops_per_second(iterations: int = 200) -> float:
    """Reference ``SecretKey::benchmarkOpsPerSecond`` (sign half)."""
    import time
    sk = SecretKey.random()
    msg = b"benchmark-payload" * 4
    t0 = time.perf_counter()
    for _ in range(iterations):
        sk.sign(msg)
    return iterations / (time.perf_counter() - t0)


def verify_ops_per_second(iterations: int = 200) -> float:
    """The verify half: one ``verify_sig`` a flushed cache."""
    import time
    sk = SecretKey.random()
    msg = b"benchmark-payload" * 4
    sig = sk.sign(msg)
    pk = sk.public_key
    t0 = time.perf_counter()
    for _ in range(iterations):
        flush_verify_cache()
        verify_sig(pk, msg, sig)
    return iterations / (time.perf_counter() - t0)
