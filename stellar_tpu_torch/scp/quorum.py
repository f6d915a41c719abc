"""Federated quorum mathematics (reference ``src/scp/LocalNode.cpp``
and ``QuorumSetUtils.cpp``).

Node identities are raw 32-byte ed25519 keys (the payload of the NodeID
XDR union). Quorum sets are ``SCPQuorumSet`` XDR structs: a threshold
over validators + recursive inner sets.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Set

from stellar_tpu_torch.xdr.scp import SCPQuorumSet
from stellar_tpu_torch.xdr.types import PublicKey, PublicKeyType

__all__ = [
    "node_key", "make_node_id", "is_quorum_slice", "is_v_blocking",
    "is_v_blocking_filtered", "is_quorum", "for_all_nodes",
    "normalize_qset", "is_quorum_set_sane", "singleton_qset",
]

MAX_NODES_IN_QSET = 1000
MAX_QSET_DEPTH = 4


def node_key(node_id) -> bytes:
    """Raw 32-byte identity from a NodeID XDR value (or passthrough)."""
    if isinstance(node_id, (bytes, bytearray)):
        return bytes(node_id)
    return node_id.value


def make_node_id(raw: bytes):
    return PublicKey.make(PublicKeyType.PUBLIC_KEY_TYPE_ED25519, raw)


def singleton_qset(raw: bytes) -> SCPQuorumSet:
    return SCPQuorumSet(threshold=1, validators=[make_node_id(raw)],
                        innerSets=[])


def is_quorum_slice(qset: SCPQuorumSet, nodes: Set[bytes]) -> bool:
    """True if ``nodes`` contains a slice of ``qset`` (reference
    ``isQuorumSliceInternal``)."""
    left = qset.threshold
    for v in qset.validators:
        # validators are NodeID union values: .value IS the raw key
        # (node_key()'s passthrough branch never applies here, and
        # this loop dominates quorum math in consensus storms)
        if v.value in nodes:
            left -= 1
            if left <= 0:
                return True
    for inner in qset.innerSets:
        if is_quorum_slice(inner, nodes):
            left -= 1
            if left <= 0:
                return True
    return False


def is_v_blocking(qset: SCPQuorumSet, nodes: Set[bytes]) -> bool:
    """True if ``nodes`` intersects every slice of ``qset`` (reference
    ``isVBlockingInternal``)."""
    if qset.threshold == 0:
        return False
    left = 1 + len(qset.validators) + len(qset.innerSets) - qset.threshold
    for v in qset.validators:
        if node_key(v) in nodes:
            left -= 1
            if left <= 0:
                return True
    for inner in qset.innerSets:
        if is_v_blocking(inner, nodes):
            left -= 1
            if left <= 0:
                return True
    return False


def is_v_blocking_filtered(qset: SCPQuorumSet, envs: Dict[bytes, object],
                           predicate: Callable[[object], bool]) -> bool:
    """v-blocking over the nodes whose latest statement satisfies the
    predicate (reference ``isVBlocking(qSet, map, filter)``)."""
    nodes = {nid for nid, st in envs.items() if predicate(st)}
    return is_v_blocking(qset, nodes)


def is_quorum(qset: SCPQuorumSet, envs: Dict[bytes, object],
              qfun: Callable[[object], Optional[SCPQuorumSet]],
              predicate: Callable[[object], bool]) -> bool:
    """True if the statement-satisfying nodes contain a quorum: a set
    where every member's own qset has a slice inside the set, and which
    contains a slice of the local qset (reference ``isQuorum``)."""
    nodes = {nid for nid, st in envs.items() if predicate(st)}
    while True:
        before = len(nodes)
        kept = set()
        for nid in nodes:
            nq = qfun(envs[nid])
            if nq is not None and is_quorum_slice(nq, nodes):
                kept.add(nid)
        nodes = kept
        if len(nodes) == before:
            break
    return is_quorum_slice(qset, nodes)


def for_all_nodes(qset: SCPQuorumSet) -> Set[bytes]:
    """All node ids in the tree (deduplicated)."""
    out: Set[bytes] = set()
    for v in qset.validators:
        out.add(node_key(v))
    for inner in qset.innerSets:
        out |= for_all_nodes(inner)
    return out


def normalize_qset(qset: SCPQuorumSet,
                   remove: Optional[bytes] = None) -> SCPQuorumSet:
    """Simplify: drop ``remove``, collapse single-element inner sets,
    lift degenerate nesting (reference ``normalizeQSet``)."""
    validators = [v for v in qset.validators
                  if remove is None or node_key(v) != remove]
    threshold = qset.threshold
    if remove is not None and len(validators) != len(qset.validators):
        threshold = max(0, threshold - 1)
    inner = []
    for i in qset.innerSets:
        n = normalize_qset(i, remove)
        # collapse {threshold 1, single validator} into parent
        if n.threshold == 1 and len(n.validators) == 1 and \
                not n.innerSets:
            validators.append(n.validators[0])
        elif n.threshold > 0 and (n.validators or n.innerSets):
            inner.append(n)
        # an inner set emptied by removal simply disappears
    out = SCPQuorumSet(threshold=threshold, validators=validators,
                       innerSets=inner)
    # lift {threshold 1, no validators, single inner} to the inner set
    if out.threshold == 1 and not out.validators and \
            len(out.innerSets) == 1:
        return out.innerSets[0]
    return out


def _qset_sane(qset: SCPQuorumSet, depth: int, extra_checks: bool,
               seen: Set[bytes], count: list) -> bool:
    if depth > MAX_QSET_DEPTH:
        return False
    size = len(qset.validators) + len(qset.innerSets)
    if qset.threshold < 1 or qset.threshold > size:
        return False
    if extra_checks and qset.threshold < size - qset.threshold + 1:
        # not a byzantine-safe majority (reference extraChecks)
        return False
    for v in qset.validators:
        k = node_key(v)
        if k in seen:
            return False
        seen.add(k)
        count[0] += 1
        if count[0] > MAX_NODES_IN_QSET:
            return False
    for inner in qset.innerSets:
        if not _qset_sane(inner, depth + 1, extra_checks, seen, count):
            return False
    return True


def is_quorum_set_sane(qset: SCPQuorumSet,
                       extra_checks: bool = False) -> bool:
    """Structural sanity (reference ``isQuorumSetSane``): thresholds in
    range, no duplicate nodes, bounded depth/size."""
    return _qset_sane(qset, 1, extra_checks, set(), [0])
