"""Slot: one consensus round = nomination + ballot protocol over a slot
index (reference ``src/scp/Slot.cpp``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from stellar_tpu_torch.scp.ballot import BallotProtocol
from stellar_tpu_torch.scp.nomination import NominationProtocol
from stellar_tpu_torch.scp.quorum import (
    is_quorum, is_v_blocking_filtered, node_key,
)
from stellar_tpu_torch.xdr.scp import (
    SCPEnvelope, SCPQuorumSet, SCPStatement, SCPStatementType,
    quorum_set_hash,
)

__all__ = ["Slot", "NOMINATION_TIMER", "BALLOT_PROTOCOL_TIMER"]

NOMINATION_TIMER = 0
BALLOT_PROTOCOL_TIMER = 1

ST = SCPStatementType


class Slot:
    def __init__(self, slot_index: int, scp):
        self.slot_index = slot_index
        self.scp = scp
        self.driver = scp.driver
        self.nomination = NominationProtocol(self)
        self.ballot = BallotProtocol(self)
        self.fully_validated = scp.local_is_validator
        self.got_v_blocking = False
        # historical statements for debugging: (statement, validated)
        self.statements_history: List[Tuple[SCPStatement, bool]] = []

    # ---------------- local node accessors ----------------

    @property
    def local_node_id(self) -> bytes:
        return self.scp.local_node_id

    @property
    def local_node_xdr(self):
        return self.scp.local_node_xdr

    @property
    def local_qset(self) -> SCPQuorumSet:
        return self.scp.local_qset

    @property
    def local_qset_hash(self) -> bytes:
        return self.scp.local_qset_hash

    # ---------------- statement plumbing ----------------

    def record_statement(self, st: SCPStatement):
        self.statements_history.append((st, self.fully_validated))

    def get_qset_from_statement(self, st: SCPStatement
                                ) -> Optional[SCPQuorumSet]:
        """Resolve the quorum set a statement pledges under (reference
        ``Slot::getQuorumSetFromStatement``)."""
        t = st.pledges.arm
        if t == ST.SCP_ST_NOMINATE:
            h = st.pledges.value.quorumSetHash
        elif t == ST.SCP_ST_PREPARE:
            h = st.pledges.value.quorumSetHash
        elif t == ST.SCP_ST_CONFIRM:
            h = st.pledges.value.quorumSetHash
        else:
            h = st.pledges.value.commitQuorumSetHash
        return self.driver.get_qset(h)

    # ---------------- federated voting ----------------

    def _as_statements(self, envs: Dict[bytes, object]
                       ) -> Dict[bytes, SCPStatement]:
        return {k: e.statement for k, e in envs.items()}

    def federated_accept(self, voted_pred, accepted_pred,
                         envs: Dict[bytes, object]) -> bool:
        """v-blocking accepted, or quorum (voted ∨ accepted)
        (reference ``Slot::federatedAccept``). Predicates take
        statements."""
        sts = self._as_statements(envs)
        if is_v_blocking_filtered(self.local_qset, sts, accepted_pred):
            return True
        return is_quorum(
            self.local_qset, sts, self.get_qset_from_statement,
            lambda st: accepted_pred(st) or voted_pred(st))

    def federated_ratify(self, voted_pred,
                         envs: Dict[bytes, object]) -> bool:
        sts = self._as_statements(envs)
        return is_quorum(self.local_qset, sts,
                         self.get_qset_from_statement, voted_pred)

    # ---------------- envelope entry ----------------

    def process_envelope(self, env: SCPEnvelope, self_env: bool) -> int:
        from stellar_tpu_torch.scp.scp import EnvelopeState
        if env.statement.slotIndex != self.slot_index:
            return EnvelopeState.INVALID
        if env.statement.pledges.arm == ST.SCP_ST_NOMINATE:
            res = self.nomination.process_envelope(env)
        else:
            res = self.ballot.process_envelope(env, self_env)
        if res == EnvelopeState.VALID and not self_env:
            self._maybe_set_got_v_blocking()
        return res

    def _maybe_set_got_v_blocking(self):
        """Track whether a v-blocking set has sent us messages for this
        slot (used by herder for out-of-sync detection)."""
        if self.got_v_blocking:
            return
        nodes = set(self.nomination.latest_nominations) | \
            set(self.ballot.latest_envelopes)
        nodes.discard(self.local_node_id)
        from stellar_tpu_torch.scp.quorum import is_v_blocking
        if is_v_blocking(self.local_qset, nodes):
            self.got_v_blocking = True

    # ---------------- nomination / ballot entry points ----------------

    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool = False) -> bool:
        return self.nomination.nominate(value, previous_value, timed_out)

    def stop_nomination(self):
        self.nomination.stop_nomination()

    def bump_state(self, value: bytes, force: bool) -> bool:
        return self.ballot.bump_state(value, force)

    def abandon_ballot(self, n: int = 0) -> bool:
        return self.ballot.abandon_ballot(n)

    # ---------------- state exchange ----------------

    def get_latest_messages_send(self) -> List[SCPEnvelope]:
        """Messages to (re)send peers (reference
        ``getLatestMessagesSend``)."""
        out = []
        if not self.fully_validated:
            return out
        if self.nomination.last_statement is not None:
            env = self.nomination.latest_nominations.get(
                self.local_node_id)
            if env is not None:
                out.append(env)
        if self.ballot.last_envelope_emitted is not None:
            out.append(self.ballot.last_envelope_emitted)
        return out

    def get_current_state(self) -> List[SCPEnvelope]:
        """All latest envelopes (self only when fully validated)."""
        out = []
        for envs in (self.nomination.latest_nominations,
                     self.ballot.latest_envelopes):
            for node, env in envs.items():
                if node != self.local_node_id or self.fully_validated:
                    out.append(env)
        return out

    def get_externalizing_state(self) -> List[SCPEnvelope]:
        return self.ballot.get_externalizing_state()

    def set_state_from_envelope(self, env: SCPEnvelope):
        st = env.statement
        if node_key(st.nodeID) == self.local_node_id and \
                st.slotIndex == self.slot_index:
            if st.pledges.arm == ST.SCP_ST_NOMINATE:
                self.nomination.latest_nominations[
                    self.local_node_id] = env
                self.nomination.last_statement = st.pledges.value
                self.record_statement(st)
            else:
                self.ballot.set_state_from_envelope(env)
        else:
            raise ValueError("envelope is not from local node/slot")

    @property
    def externalized_value(self) -> Optional[bytes]:
        from stellar_tpu_torch.scp.ballot import PH_EXTERNALIZE
        if self.ballot.phase == PH_EXTERNALIZE:
            return self.ballot.commit.value
        return None
