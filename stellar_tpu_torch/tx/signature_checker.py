"""SignatureChecker: match a transaction's decorated signatures against
account signers and accumulate weight (reference
``src/transactions/SignatureChecker.cpp`` — the algorithm here follows
its semantics exactly: pre-auth-tx signers count without signatures;
then hashX, ed25519, signed-payload signers are matched against unused
signatures in signature order, each signer usable once, weights clamped
to 255).

``check_all_signatures_used`` backs the txBAD_AUTH_EXTRA check.

The port's copy of ``stellar_tpu/tx/signature_checker.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import List, Sequence

from stellar_tpu_torch.tx import signature_utils as su
from stellar_tpu_torch.xdr.types import Signer, SignerKeyType

__all__ = ["SignatureChecker", "AlwaysValidSignatureChecker"]

UINT8_MAX = 255


class SignatureChecker:
    def __init__(self, protocol_version: int, contents_hash: bytes,
                 signatures: Sequence):
        self.protocol_version = protocol_version
        self.contents_hash = contents_hash
        self.signatures = list(signatures)
        self.used = [False] * len(self.signatures)

    def _weight(self, signer: Signer) -> int:
        return min(signer.weight, UINT8_MAX)

    def check_signature(self, signers: Sequence[Signer],
                        needed_weight: int) -> bool:
        by_type: dict = {}
        for s in signers:
            by_type.setdefault(s.key.arm, []).append(s)

        total = 0

        # pre-auth-tx signers: the tx hash itself authorizes, no
        # signature bytes consumed
        for s in by_type.get(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX, []):
            if s.key.value == self.contents_hash:
                total += self._weight(s)
                if total >= needed_weight:
                    return True

        def verify_all(pool: List[Signer], verify) -> bool:
            nonlocal total
            for i, sig in enumerate(self.signatures):
                for j, signer in enumerate(pool):
                    if verify(sig, signer):
                        self.used[i] = True
                        total += self._weight(signer)
                        if total >= needed_weight:
                            return True
                        del pool[j]
                        break
            return False

        if verify_all(
                by_type.get(SignerKeyType.SIGNER_KEY_TYPE_HASH_X, []),
                lambda sig, s: su.verify_hash_x(sig, s.key.value)):
            return True
        if verify_all(
                by_type.get(SignerKeyType.SIGNER_KEY_TYPE_ED25519, []),
                lambda sig, s: su.verify_ed25519(
                    sig, s.key.value, self.contents_hash)):
            return True
        if verify_all(
                by_type.get(
                    SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD,
                    []),
                lambda sig, s: su.verify_signed_payload(sig, s.key.value)):
            return True
        return False

    def check_all_signatures_used(self) -> bool:
        return all(self.used)


class AlwaysValidSignatureChecker(SignatureChecker):
    """Skips verification — test/replay fixture (reference
    ``SignatureChecker.h:42-62`` under BUILD_TESTS)."""

    def check_signature(self, signers, needed_weight) -> bool:
        return True

    def check_all_signatures_used(self) -> bool:
        return True
