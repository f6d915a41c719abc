"""Quorum-intersection checker (reference
``src/herder/QuorumIntersectionCheckerImpl.cpp`` — the Lachowski
branch-and-bound over minimal quorums, with the same early exits).

Given every node's quorum set, decide whether ANY two quorums of the
network must intersect. The search enumerates *minimal* quorums inside
the scan SCC; for each one found it checks whether the complement still
contains a quorum — if so, the pair is a concrete safety
counterexample (two quorums that can externalize different values).

Bitsets are plain Python ints (arbitrary-width, C-speed bitops), the
idiomatic stand-in for the reference's BitSet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["QuorumIntersectionChecker"]


class QuorumIntersectionChecker:
    def __init__(self, qmap: Dict[bytes, "SCPQuorumSet"]):
        """qmap: node id (raw 32B) -> SCPQuorumSet. Nodes with missing
        qsets are treated as their own singleton qset (reference treats
        missing as unknown and excludes; singleton is the conservative
        local stance for fixtures)."""
        self.nodes: List[bytes] = sorted(qmap)
        self.index = {n: i for i, n in enumerate(self.nodes)}
        self.qsets = [qmap[n] for n in self.nodes]
        self.n = len(self.nodes)
        # per-node dependency mask (validators reachable through the
        # qset tree) for SCC construction and the split heuristic
        self._deps = [self._qset_mask(qs) for qs in self.qsets]
        self.last_split: Optional[Tuple[List[bytes], List[bytes]]] = None
        self.quorum_found = False
        self._calls = 0
        self.max_calls: Optional[int] = None  # interrupt knob

    # ---------------- qset evaluation ----------------

    def _qset_mask(self, qs) -> int:
        m = 0
        for v in qs.validators:
            i = self.index.get(v.value)
            if i is not None:
                m |= 1 << i
        for inner in qs.innerSets:
            m |= self._qset_mask(inner)
        return m

    def _sat(self, qs, mask: int) -> bool:
        """Does `mask` satisfy the qset? (reference isSatisfiedBy)."""
        hits = 0
        for v in qs.validators:
            i = self.index.get(v.value)
            if i is not None and (mask >> i) & 1:
                hits += 1
        for inner in qs.innerSets:
            if self._sat(inner, mask):
                hits += 1
        return hits >= qs.threshold

    def contract_to_maximal_quorum(self, mask: int) -> int:
        """Strip unsatisfied nodes to a fixpoint; the result (possibly
        0) is the unique maximal quorum inside ``mask``."""
        while True:
            out = 0
            m = mask
            while m:
                i = (m & -m).bit_length() - 1
                m &= m - 1
                if self._sat(self.qsets[i], mask):
                    out |= 1 << i
            if out == mask:
                return out
            mask = out

    def is_minimal_quorum(self, q: int) -> bool:
        m = q
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            if self.contract_to_maximal_quorum(q & ~(1 << i)):
                return False
        return True

    # ---------------- SCCs (Tarjan) ----------------

    def _sccs(self) -> List[int]:
        index_of = [-1] * self.n
        low = [0] * self.n
        on_stack = [False] * self.n
        stack: List[int] = []
        sccs: List[int] = []
        counter = [0]

        def strongconnect(v):
            # iterative Tarjan to dodge recursion limits
            work = [(v, 0)]
            while work:
                node, pi = work[-1]
                if pi == 0:
                    index_of[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack[node] = True
                advanced = False
                deps = self._deps[node] & ~(1 << node)
                ds = []
                m = deps
                while m:
                    w = (m & -m).bit_length() - 1
                    m &= m - 1
                    ds.append(w)
                for idx in range(pi, len(ds)):
                    w = ds[idx]
                    if index_of[w] == -1:
                        work[-1] = (node, idx + 1)
                        work.append((w, 0))
                        advanced = True
                        break
                    if on_stack[w]:
                        low[node] = min(low[node], index_of[w])
                if advanced:
                    continue
                if low[node] == index_of[node]:
                    scc = 0
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        scc |= 1 << w
                        if w == node:
                            break
                    sccs.append(scc)
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for v in range(self.n):
            if index_of[v] == -1:
                strongconnect(v)
        return sccs

    # ---------------- the search ----------------

    def _mask_to_nodes(self, mask: int) -> List[bytes]:
        out = []
        m = mask
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            out.append(self.nodes[i])
        return out

    def _note_split(self, a: int, b: int):
        self.last_split = (self._mask_to_nodes(a), self._mask_to_nodes(b))

    def _pick_split_node(self, remaining: int) -> int:
        """Most-depended-on node in remaining (the reference's
        in-degree heuristic)."""
        best, best_deg = None, -1
        m = remaining
        while m:
            i = (m & -m).bit_length() - 1
            m &= m - 1
            deg = sum(1 for d in self._deps if (d >> i) & 1)
            if deg > best_deg:
                best, best_deg = i, deg
        return best

    def _any_min_quorum_has_disjoint(self, committed: int, remaining: int,
                                     scan_scc: int) -> bool:
        self._calls += 1
        if self.max_calls is not None and self._calls > self.max_calls:
            raise TimeoutError("quorum intersection scan interrupted")
        # early exit 1: committed beyond half the SCC — the other branch
        # will find the min-quorum inside the complement
        if bin(committed).count("1") > \
                bin(scan_scc).count("1") // 2 + 1:
            return False
        # early exit 3: committed contains a quorum — terminal either way
        committed_q = self.contract_to_maximal_quorum(committed)
        if committed_q:
            if self.is_minimal_quorum(committed_q):
                disj = self.contract_to_maximal_quorum(
                    scan_scc & ~committed_q)
                if disj:
                    self._note_split(committed_q, disj)
                    return True
            return False
        # early exit 2: the perimeter must still contain a quorum
        # extending committed
        perimeter = committed | remaining
        ext_q = self.contract_to_maximal_quorum(perimeter)
        if not ext_q or (committed & ~ext_q):
            return False
        if not remaining:
            return False
        split = self._pick_split_node(remaining)
        remaining &= ~(1 << split)
        if self._any_min_quorum_has_disjoint(committed, remaining,
                                             scan_scc):
            return True
        return self._any_min_quorum_has_disjoint(committed | (1 << split),
                                                 remaining, scan_scc)

    def network_enjoys_quorum_intersection(self) -> bool:
        """False iff two disjoint quorums exist (split recorded in
        ``last_split``) — reference
        ``networkEnjoysQuorumIntersection``."""
        self.last_split = None
        self._calls = 0
        quorum_sccs = []
        for scc in self._sccs():
            q = self.contract_to_maximal_quorum(scc)
            if q:
                quorum_sccs.append(q)
        if not quorum_sccs:
            self.quorum_found = False
            return True  # vacuous: no quorums at all (reference warns)
        self.quorum_found = True
        if len(quorum_sccs) > 1:
            self._note_split(quorum_sccs[0], quorum_sccs[1])
            return False
        scan = quorum_sccs[0]
        return not self._any_min_quorum_has_disjoint(0, scan, scan)
