"""Decorated-signature creation and per-signer-type verification
(reference ``src/transactions/SignatureUtils.cpp``).

Four signer kinds (``SignerKey``): ed25519 keys, pre-auth-tx hashes
(matched against the contents hash, no signature bytes), hashX preimages
(signature bytes are the preimage), and ed25519-signed-payloads. All
ed25519 verification funnels through
``stellar_tpu_torch.crypto.keys.verify_sig`` — the cached, card-backed
boundary.

The port's copy of ``stellar_tpu/tx/signature_utils.py``, with the port's
imports.
"""

from __future__ import annotations

from stellar_tpu_torch.crypto.keys import verify_sig
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.xdr.tx import DecoratedSignature
from stellar_tpu_torch.xdr.types import SignerKeyType

__all__ = [
    "get_hint", "does_hint_match", "sign_decorated", "sign_hash_x",
    "verify_ed25519", "verify_hash_x", "verify_signed_payload",
    "signed_payload_hint",
]


def get_hint(bs: bytes) -> bytes:
    """Last 4 bytes (reference ``SignatureUtils::getHint``)."""
    if not bs:
        return b"\x00\x00\x00\x00"
    if len(bs) < 4:
        return bs + b"\x00" * (4 - len(bs))
    return bs[-4:]


def does_hint_match(bs: bytes, hint: bytes) -> bool:
    if len(bs) < 4:
        return False
    return bs[-4:] == hint


def sign_decorated(secret_key, h: bytes) -> DecoratedSignature:
    return DecoratedSignature(
        hint=get_hint(secret_key.public_key.raw),
        signature=secret_key.sign(h))


def sign_hash_x(preimage: bytes) -> DecoratedSignature:
    """HashX 'signature' is the preimage itself; hint from its hash."""
    return DecoratedSignature(hint=get_hint(sha256(preimage)),
                              signature=bytes(preimage))


def verify_ed25519(sig: DecoratedSignature, ed25519: bytes,
                   h: bytes) -> bool:
    if not does_hint_match(ed25519, sig.hint):
        return False
    return verify_sig(ed25519, h, sig.signature)


def verify_hash_x(sig: DecoratedSignature, hash_x: bytes) -> bool:
    if not does_hint_match(hash_x, sig.hint):
        return False
    return hash_x == sha256(sig.signature)


def signed_payload_hint(payload_signer) -> bytes:
    """XOR of key hint and payload hint (reference
    ``getSignedPayloadHint``)."""
    a = get_hint(payload_signer.ed25519)
    b = get_hint(payload_signer.payload)
    return bytes(x ^ y for x, y in zip(a, b))


def verify_signed_payload(sig: DecoratedSignature, payload_signer) -> bool:
    if sig.hint != signed_payload_hint(payload_signer):
        return False
    return verify_sig(payload_signer.ed25519, payload_signer.payload,
                      sig.signature)
