"""SCPDriver: the callback boundary between the abstract SCP kernel and
the application (reference ``src/scp/SCPDriver.h:66`` /
``SCPDriver.cpp``).

The kernel never touches I/O, crypto, or application values directly —
everything goes through a driver: value validation/combination, envelope
signing/emission, quorum-set retrieval, timers, and the deterministic
hash/weight functions used for nomination leader election.
"""

from __future__ import annotations

import struct
from typing import Callable, Iterable, Optional, Set

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.xdr.runtime import to_bytes
from stellar_tpu_torch.xdr.scp import SCPEnvelope, SCPQuorumSet, SCPStatement
from stellar_tpu_torch.scp.quorum import node_key

__all__ = ["ValidationLevel", "SCPDriver"]

# reference SCPDriver.cpp hash domain tags
_HASH_N = 1
_HASH_P = 2
_HASH_K = 3

MAX_TIMEOUT_SECONDS = 30 * 60


class ValidationLevel:
    INVALID = 0          # kInvalidValue
    MAYBE_VALID = 1      # kMaybeValidValue (e.g. can't check closeTime yet)
    FULLY_VALIDATED = 2  # kFullyValidatedValue

    # voting-only level used by herder (values valid for nomination only)
    VOTE_TO_NOMINATE = 1


class SCPDriver:
    """Subclass and implement the abstract methods; override the
    notification hooks as needed."""

    # ---------------- abstract: values ----------------

    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> int:
        """-> ValidationLevel."""
        raise NotImplementedError

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        """Salvage a valid variation of an almost-valid value (reference
        returns nullptr by default)."""
        return None

    def combine_candidates(self, slot_index: int,
                           candidates: Set[bytes]) -> Optional[bytes]:
        """Deterministically merge candidate values into the composite
        the ballot protocol will run on."""
        raise NotImplementedError

    # ---------------- abstract: plumbing ----------------

    def sign_envelope(self, statement: SCPStatement) -> SCPEnvelope:
        """Wrap + sign a statement from the local node."""
        raise NotImplementedError

    def emit_envelope(self, envelope: SCPEnvelope) -> None:
        """Broadcast a (newly signed) envelope to the network."""
        raise NotImplementedError

    def get_qset(self, qset_hash: bytes) -> Optional[SCPQuorumSet]:
        """Resolve a quorum-set hash heard on the wire."""
        raise NotImplementedError

    def setup_timer(self, slot_index: int, timer_id: int, timeout_ms: int,
                    callback: Optional[Callable[[], None]]) -> None:
        """Arm (or with callback=None cancel) a per-slot timer."""
        raise NotImplementedError

    # ---------------- notification hooks (default no-op) ----------------

    def value_externalized(self, slot_index: int, value: bytes) -> None:
        pass

    def nominating_value(self, slot_index: int, value: bytes) -> None:
        pass

    def updated_candidate_value(self, slot_index: int,
                                value: bytes) -> None:
        pass

    def started_ballot_protocol(self, slot_index: int, ballot) -> None:
        pass

    def accepted_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def confirmed_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def accepted_commit(self, slot_index: int, ballot) -> None:
        pass

    def ballot_did_hear_from_quorum(self, slot_index: int,
                                    ballot) -> None:
        pass

    def stop_timer(self, slot_index: int, timer_id: int) -> None:
        self.setup_timer(slot_index, timer_id, 0, None)

    # ---------------- deterministic protocol functions ----------------

    def get_hash_of(self, vals: Iterable[bytes]) -> bytes:
        """SHA-256 over the concatenated values (what the herder driver
        uses; override to change the hash family)."""
        import hashlib
        h = hashlib.sha256()
        for v in vals:
            h.update(v)
        return h.digest()

    def _hash_helper(self, slot_index: int, prev: bytes,
                     extra: Iterable[bytes]) -> int:
        """First 8 bytes (BE) of getHashOf(slot, prev, *extra)
        (reference ``hashHelper``)."""
        from stellar_tpu_torch.xdr.runtime import Packer
        p = Packer()
        p.pack_uhyper(slot_index)
        p.pack_opaque(prev, 0xFFFFFFFF)
        vals = [bytes(p.buf)] + list(extra)
        t = self.get_hash_of(vals)
        return int.from_bytes(t[:8], "big")

    def compute_hash_node(self, slot_index: int, prev: bytes,
                          is_priority: bool, round_number: int,
                          node_id: bytes) -> int:
        """Gi(isPriority?P:N, roundNumber, nodeID) (reference
        ``computeHashNode``)."""
        tag = struct.pack(">I", _HASH_P if is_priority else _HASH_N)
        rn = struct.pack(">i", round_number)
        nid = struct.pack(">I", 0) + node_key(node_id)
        return self._hash_helper(slot_index, prev, [tag, rn, nid])

    def compute_value_hash(self, slot_index: int, prev: bytes,
                           round_number: int, value: bytes) -> int:
        tag = struct.pack(">I", _HASH_K)
        rn = struct.pack(">i", round_number)
        from stellar_tpu_torch.xdr.runtime import Packer
        p = Packer()
        p.pack_opaque(value, 0xFFFFFFFF)
        return self._hash_helper(slot_index, prev, [tag, rn, bytes(p.buf)])

    def get_node_weight(self, node_id: bytes, qset: SCPQuorumSet,
                        is_local: bool) -> int:
        """Fraction of UINT64_MAX this node holds in the qset tree
        (reference ``getNodeWeight``)."""
        U = 0xFFFFFFFFFFFFFFFF
        if is_local:
            return U
        n = qset.threshold
        d = len(qset.innerSets) + len(qset.validators)
        for v in qset.validators:
            if node_key(v) == node_key(node_id):
                return _compute_weight(U, d, n)
        for inner in qset.innerSets:
            leaf = self.get_node_weight(node_id, inner, False)
            if leaf:
                return _compute_weight(leaf, d, n)
        return 0

    def compute_timeout(self, round_number: int) -> int:
        """Linear timeout in ms, capped (reference ``computeTimeout``)."""
        secs = min(round_number, MAX_TIMEOUT_SECONDS)
        return secs * 1000


def _compute_weight(m: int, total: int, threshold: int) -> int:
    """ceil(m * threshold / total) (reference ``computeWeight`` via
    bigDivide ROUND_UP)."""
    return (m * threshold + total - 1) // total
