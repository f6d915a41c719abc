"""Transitive-quorum tracking (reference ``src/herder/QuorumTracker``
+ the SCC / quorum-health analytics behind the ``quorum`` admin
endpoint): expand the local quorum set through every quorum set learned
from SCP traffic, then analyze the resulting known subnetwork —
node count, closure completeness, quorum intersection, and
single-node criticality."""

from __future__ import annotations

from typing import Dict, Optional, Set

from stellar_tpu_torch.scp.quorum import for_all_nodes, make_node_id
from stellar_tpu_torch.xdr.scp import SCPQuorumSet

__all__ = ["QuorumTracker"]

# criticality analysis is combinatorial; cap the subnetwork size AND
# the checker's branch-and-bound work so a hostile learned topology
# can't stall the main thread (the analysis runs on it)
MAX_NODES_FOR_ANALYSIS = 20
MAX_CHECKER_CALLS = 200_000


def _fickle_qset(group: Set[bytes],
                 qmap: Dict[bytes, SCPQuorumSet]) -> SCPQuorumSet:
    """The reference's 'fickle' reconfiguration
    (``getIntersectionCriticalGroups``): the group goes along with
    anyone — threshold 2 of {the whole group, any one node that
    depends on a group member}."""
    pointers = sorted(
        n for n, q in qmap.items()
        if n not in group and q is not None and
        (for_all_nodes(q) & group))
    return SCPQuorumSet(
        threshold=2,
        validators=[],
        innerSets=[
            SCPQuorumSet(threshold=len(group),
                         validators=[make_node_id(n)
                                     for n in sorted(group)],
                         innerSets=[]),
            SCPQuorumSet(threshold=1,
                         validators=[make_node_id(n) for n in pointers],
                         innerSets=[]),
        ])


class QuorumTracker:
    """Rebuilds the transitive closure of the local quorum from the
    herder's learned quorum sets (reference ``QuorumTracker::rebuild``
    driven by PendingEnvelopes' qset fetches)."""

    def __init__(self, herder):
        self.herder = herder

    def node_qset_map(self) -> Dict[bytes, Optional[SCPQuorumSet]]:
        """node id -> its quorum set (None when not yet learned),
        starting from the local node and expanding through every
        learned qset reachable from it."""
        h = self.herder
        learned: Dict[bytes, SCPQuorumSet] = {}
        # nodes pledge their qset hash inside SCP statements; map
        # node -> latest pledged hash from the retained slots
        pledged: Dict[bytes, bytes] = {}
        for idx in sorted(h.scp.known_slots):
            slot = h.scp.known_slots[idx]
            for st, _ in slot.statements_history:
                pledged[st.nodeID.value] = h._statement_qset_hash(st)
        for node, qh in pledged.items():
            if qh in h.qsets:
                learned[node] = h.qsets[qh]
        local_id = h.scp.local_node_id
        learned[local_id] = h.scp.local_qset

        out: Dict[bytes, Optional[SCPQuorumSet]] = {}
        frontier = [local_id]
        while frontier:
            node = frontier.pop()
            if node in out:
                continue
            qs = learned.get(node)
            out[node] = qs
            if qs is not None:
                for dep in for_all_nodes(qs):
                    if dep not in out:
                        frontier.append(dep)
        return out

    def analyze(self, qmap=None) -> dict:
        """The ``quorum`` endpoint's transitive section (reference
        ``HerderImpl::getJsonTransitiveQuorumInfo``). Node ids use the
        same 16-hex-char short form as the endpoint's validator list.
        ``intersection`` is None when the closure is incomplete, too
        large, or the bounded search ran out of budget; ``split`` gives
        a counterexample when intersection is False. Pass a
        pre-snapshotted ``qmap`` to analyze off the main thread (the
        live herder state must only be read on the crank)."""
        if qmap is None:
            qmap = self.node_qset_map()
        unknown = [n for n, q in qmap.items() if q is None]
        out = {
            "node_count": len(qmap),
            "unknown_count": len(unknown),
            "fully_known": not unknown,
        }
        known = {n: q for n, q in qmap.items() if q is not None}
        if unknown or len(known) > MAX_NODES_FOR_ANALYSIS or not known:
            out["intersection"] = None  # not decidable yet / too big
            return out
        from stellar_tpu_torch.herder.quorum_intersection import (
            QuorumIntersectionChecker,
        )
        checker = QuorumIntersectionChecker(known)
        checker.max_calls = MAX_CHECKER_CALLS
        try:
            out["intersection"] = \
                checker.network_enjoys_quorum_intersection()
        except TimeoutError:
            out["intersection"] = None  # budget exhausted: undecided
            return out
        if out["intersection"]:
            out["critical_nodes"] = [
                n.hex()[:16] for n in known
                if self._is_critical(known, {n})]
        else:
            out["split"] = [[n.hex()[:16] for n in side]
                            for side in checker.last_split]
        return out

    @staticmethod
    def _is_critical(known: Dict[bytes, SCPQuorumSet],
                     group: Set[bytes]) -> bool:
        """True when reconfiguring ``group`` as fickle (it will join
        anyone's quorum) lets the network split — the reference's
        intersection-criticality test, here run per singleton node
        (the reference also examines leaf inner-set groups). Undecided
        within the work budget counts as not-critical."""
        from stellar_tpu_torch.herder.quorum_intersection import (
            QuorumIntersectionChecker,
        )
        fickle = _fickle_qset(group, known)
        test = dict(known)
        for n in group:
            test[n] = fickle
        checker = QuorumIntersectionChecker(test)
        checker.max_calls = MAX_CHECKER_CALLS
        try:
            return not checker.network_enjoys_quorum_intersection()
        except TimeoutError:
            return False
