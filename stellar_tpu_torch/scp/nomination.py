"""Nomination protocol (reference ``src/scp/NominationProtocol.cpp``):
leader-based value nomination with federated accept/ratify, producing
candidate values that are combined and handed to the ballot protocol.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from stellar_tpu_torch.scp.driver import ValidationLevel
from stellar_tpu_torch.scp.quorum import for_all_nodes, node_key, normalize_qset
from stellar_tpu_torch.xdr.scp import (
    SCPNomination, SCPStatement, SCPStatementPledges, SCPStatementType,
)

__all__ = ["NominationProtocol"]


class NominationProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.round_number = 0
        self.votes: Set[bytes] = set()
        self.accepted: Set[bytes] = set()
        self.candidates: Set[bytes] = set()
        # node key -> latest SCPEnvelope (nominate statements)
        self.latest_nominations: Dict[bytes, object] = {}
        self.latest_composite: Optional[bytes] = None
        self.nomination_started = False
        self.round_leaders: Set[bytes] = set()
        self.previous_value: bytes = b""
        self.last_statement: Optional[SCPNomination] = None
        self.timer_exp_count = 0

    # ---------------- statement ordering / sanity ----------------

    @staticmethod
    def _is_subset(p: List[bytes], v: List[bytes]):
        """(is_subset, grew) (reference ``isSubsetHelper``)."""
        if len(p) <= len(v):
            vs = set(v)
            if all(x in vs for x in p):
                return True, len(p) != len(v)
            return False, True
        return False, True

    def is_newer_statement(self, node: bytes, nom: SCPNomination) -> bool:
        old = self.latest_nominations.get(node)
        if old is None:
            return True
        return self._newer(old.statement.pledges.value, nom)

    @classmethod
    def _newer(cls, old: SCPNomination, new: SCPNomination) -> bool:
        ok_v, grew_v = cls._is_subset(old.votes, new.votes)
        if not ok_v:
            return False
        ok_a, grew_a = cls._is_subset(old.accepted, new.accepted)
        if not ok_a:
            return False
        return grew_v or grew_a

    @staticmethod
    def is_sane(nom: SCPNomination) -> bool:
        """Non-empty, strictly-sorted votes/accepted (reference
        ``isSane``)."""
        if not nom.votes and not nom.accepted:
            return False
        for arr in (nom.votes, nom.accepted):
            for a, b in zip(arr, arr[1:]):
                if not a < b:
                    return False
        return True

    # ---------------- leader election ----------------

    def _hash_node(self, is_priority: bool, node: bytes) -> int:
        return self.slot.driver.compute_hash_node(
            self.slot.slot_index, self.previous_value, is_priority,
            self.round_number, node)

    def _hash_value(self, value: bytes) -> int:
        return self.slot.driver.compute_value_hash(
            self.slot.slot_index, self.previous_value, self.round_number,
            value)

    def _node_priority(self, node: bytes, qset) -> int:
        w = self.slot.driver.get_node_weight(
            node, qset, node == self.slot.local_node_id)
        if w > 0 and self._hash_node(False, node) <= w:
            return self._hash_node(True, node)
        return 0

    def update_round_leaders(self):
        """Reference ``updateRoundLeaders``: grow the leader set each
        round; fast-forward rounds that would add nobody."""
        local = self.slot.local_node_id
        my_qset = normalize_qset(self.slot.local_qset, remove=local)
        max_leaders = 1 + len(for_all_nodes(my_qset))
        while len(self.round_leaders) < max_leaders:
            new_leaders = {local}
            top = self._node_priority(local, my_qset)
            for cur in for_all_nodes(my_qset):
                w = self._node_priority(cur, my_qset)
                if w > top:
                    top = w
                    new_leaders = set()
                if w == top and w > 0:
                    new_leaders.add(cur)
            if top == 0:
                new_leaders = set()
            before = len(self.round_leaders)
            self.round_leaders |= new_leaders
            if len(self.round_leaders) != before:
                return
            self.round_number += 1

    # ---------------- emission ----------------

    def _emit_nomination(self):
        nom = SCPNomination(
            quorumSetHash=self.slot.local_qset_hash,
            votes=sorted(self.votes),
            accepted=sorted(self.accepted))
        st = SCPStatement(
            nodeID=self.slot.local_node_xdr,
            slotIndex=self.slot.slot_index,
            pledges=SCPStatementPledges.make(
                SCPStatementType.SCP_ST_NOMINATE, nom))
        env = self.slot.driver.sign_envelope(st)
        from stellar_tpu_torch.scp.scp import EnvelopeState
        if self.slot.process_envelope(env, self_env=True) != \
                EnvelopeState.VALID:
            raise RuntimeError("moved to a bad state (nomination)")
        if self.last_statement is None or \
                self._newer(self.last_statement, nom):
            self.last_statement = nom
            if self.slot.fully_validated:
                self.slot.driver.emit_envelope(env)

    # ---------------- value promotion ----------------

    @staticmethod
    def _accept_predicate(v: bytes):
        def pred(st: SCPStatement) -> bool:
            return v in st.pledges.value.accepted
        return pred

    def _validate(self, v: bytes) -> int:
        return self.slot.driver.validate_value(
            self.slot.slot_index, v, True)

    def _new_value_from_nomination(self, nom: SCPNomination
                                   ) -> Optional[bytes]:
        """Highest-hashed valid value we don't vote for yet (reference
        ``getNewValueFromNomination``)."""
        new_vote = None
        new_hash = 0
        found_valid = False

        def pick(value: bytes):
            nonlocal new_vote, new_hash, found_valid
            lv = self._validate(value)
            if lv == ValidationLevel.FULLY_VALIDATED:
                candidate = value
            else:
                candidate = self.slot.driver.extract_valid_value(
                    self.slot.slot_index, value)
            if candidate is not None:
                found_valid = True
                if candidate not in self.votes:
                    h = self._hash_value(candidate)
                    if h >= new_hash:
                        new_hash = h
                        new_vote = candidate

        for val in nom.accepted:
            pick(val)
        if not found_valid:
            for val in nom.votes:
                pick(val)
        return new_vote

    # ---------------- envelope processing ----------------

    def process_envelope(self, env) -> int:
        from stellar_tpu_torch.scp.scp import EnvelopeState
        st = env.statement
        nom: SCPNomination = st.pledges.value
        node = node_key(st.nodeID)

        if not self.is_newer_statement(node, nom):
            return EnvelopeState.INVALID
        if not self.is_sane(nom):
            return EnvelopeState.INVALID

        self.latest_nominations[node] = env
        self.slot.record_statement(st)

        if not self.nomination_started:
            return EnvelopeState.VALID

        modified = False
        new_candidates = False

        # promote votes -> accepted
        for v in nom.votes:
            if v in self.accepted:
                continue

            def voted_pred(stmt, _v=v):
                return _v in stmt.pledges.value.votes

            if self.slot.federated_accept(
                    voted_pred, self._accept_predicate(v),
                    self.latest_nominations):
                lv = self._validate(v)
                if lv == ValidationLevel.FULLY_VALIDATED:
                    self.accepted.add(v)
                    self.votes.add(v)
                    modified = True
                else:
                    alt = self.slot.driver.extract_valid_value(
                        self.slot.slot_index, v)
                    if alt is not None and alt not in self.votes:
                        self.votes.add(alt)
                        modified = True

        # promote accepted -> candidates
        for a in list(self.accepted):
            if a in self.candidates:
                continue
            if self.slot.federated_ratify(
                    self._accept_predicate(a), self.latest_nominations):
                self.candidates.add(a)
                new_candidates = True
                from stellar_tpu_torch.scp.slot import NOMINATION_TIMER
                self.slot.driver.stop_timer(
                    self.slot.slot_index, NOMINATION_TIMER)

        # echo round-leader votes while still candidate-less
        if not self.candidates and node in self.round_leaders:
            new_vote = self._new_value_from_nomination(nom)
            if new_vote is not None:
                self.votes.add(new_vote)
                modified = True
                self.slot.driver.nominating_value(
                    self.slot.slot_index, new_vote)

        if modified:
            self._emit_nomination()

        if new_candidates:
            self.latest_composite = self.slot.driver.combine_candidates(
                self.slot.slot_index, set(self.candidates))
            if self.latest_composite is not None:
                self.slot.driver.updated_candidate_value(
                    self.slot.slot_index, self.latest_composite)
                self.slot.bump_state(self.latest_composite, force=False)

        return EnvelopeState.VALID

    # ---------------- entry point ----------------

    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool) -> bool:
        """Reference ``nominate``: start/continue nomination rounds."""
        if self.candidates:
            return False
        if timed_out:
            self.timer_exp_count += 1
            if not self.nomination_started:
                return False
        self.nomination_started = True
        self.previous_value = previous_value
        self.round_number += 1
        self.update_round_leaders()

        updated = False
        timeout_ms = self.slot.driver.compute_timeout(self.round_number)

        for leader in self.round_leaders:
            env = self.latest_nominations.get(leader)
            if env is not None:
                nv = self._new_value_from_nomination(
                    env.statement.pledges.value)
                if nv is not None:
                    self.votes.add(nv)
                    updated = True
                    self.slot.driver.nominating_value(
                        self.slot.slot_index, nv)

        # A round leader always nominates its own value, even when it has
        # already echoed another leader's (reference
        # NominationProtocol::nominate: leaders insert their value
        # unconditionally; copying from other leaders is the non-leader
        # path). Gating on empty votes starved the local value.
        if self.slot.local_node_id in self.round_leaders and \
                value not in self.votes:
            self.votes.add(value)
            updated = True
            self.slot.driver.nominating_value(self.slot.slot_index, value)

        from stellar_tpu_torch.scp.slot import NOMINATION_TIMER
        self.slot.driver.setup_timer(
            self.slot.slot_index, NOMINATION_TIMER, timeout_ms,
            lambda: self.slot.nominate(value, previous_value,
                                       timed_out=True))

        if updated:
            self._emit_nomination()
        return updated

    def stop_nomination(self):
        self.nomination_started = False

    def get_latest_composite(self) -> Optional[bytes]:
        return self.latest_composite
