"""Ballot protocol (reference ``src/scp/BallotProtocol.cpp``): the
prepare → confirm → externalize federated-voting state machine.

State per slot: current ballot ``b``, highest prepared ``p`` and
next-highest incompatible ``p'``, commit ``c``, high ``h``, phase.
Statements from peers drive monotone transitions via federated accept
(v-blocking accepted ∨ quorum voted+accepted) and ratify (quorum voted).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from stellar_tpu_torch.scp.quorum import is_v_blocking_filtered, node_key
from stellar_tpu_torch.xdr.scp import (
    SCPBallot, SCPStatement, SCPStatementConfirm, SCPStatementExternalize,
    SCPStatementPledges, SCPStatementPrepare, SCPStatementType,
)

__all__ = ["BallotProtocol", "compare_ballots", "ballots_compatible"]

UINT32_MAX = 0xFFFFFFFF
MAX_ADVANCE_SLOT_RECURSION = 50

PH_PREPARE = 0
PH_CONFIRM = 1
PH_EXTERNALIZE = 2

ST = SCPStatementType


def compare_ballots(b1: Optional[SCPBallot],
                    b2: Optional[SCPBallot]) -> int:
    if b1 is not None and b2 is None:
        return 1
    if b1 is None and b2 is not None:
        return -1
    if b1 is None and b2 is None:
        return 0
    if b1.counter != b2.counter:
        return -1 if b1.counter < b2.counter else 1
    if b1.value != b2.value:
        return -1 if b1.value < b2.value else 1
    return 0


def ballots_compatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return b1.value == b2.value


def less_and_compatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return compare_ballots(b1, b2) <= 0 and ballots_compatible(b1, b2)


def less_and_incompatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return compare_ballots(b1, b2) <= 0 and not ballots_compatible(b1, b2)


def _ballot(counter: int, value: bytes) -> SCPBallot:
    return SCPBallot(counter=counter, value=value)


def _copy(b: SCPBallot) -> SCPBallot:
    return SCPBallot(counter=b.counter, value=b.value)


def _ballot_key(b: SCPBallot) -> Tuple[int, bytes]:
    return (b.counter, b.value)


def statement_ballot_counter(st: SCPStatement) -> int:
    t = st.pledges.arm
    if t == ST.SCP_ST_PREPARE:
        return st.pledges.value.ballot.counter
    if t == ST.SCP_ST_CONFIRM:
        return st.pledges.value.ballot.counter
    return UINT32_MAX  # EXTERNALIZE


def has_prepared_ballot(ballot: SCPBallot, st: SCPStatement) -> bool:
    """Does the statement claim accept prepare(ballot)? (reference
    ``hasPreparedBallot``)."""
    t = st.pledges.arm
    p = st.pledges.value
    if t == ST.SCP_ST_PREPARE:
        return ((p.prepared is not None and
                 less_and_compatible(ballot, p.prepared)) or
                (p.preparedPrime is not None and
                 less_and_compatible(ballot, p.preparedPrime)))
    if t == ST.SCP_ST_CONFIRM:
        return less_and_compatible(
            ballot, _ballot(p.nPrepared, p.ballot.value))
    if t == ST.SCP_ST_EXTERNALIZE:
        return ballots_compatible(ballot, p.commit)
    return False


def get_working_ballot(st: SCPStatement) -> SCPBallot:
    t = st.pledges.arm
    p = st.pledges.value
    if t == ST.SCP_ST_PREPARE:
        return p.ballot
    if t == ST.SCP_ST_CONFIRM:
        return _ballot(p.nCommit, p.ballot.value)
    return p.commit


class BallotProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.phase = PH_PREPARE
        self.current: Optional[SCPBallot] = None          # b
        self.prepared: Optional[SCPBallot] = None         # p
        self.prepared_prime: Optional[SCPBallot] = None   # p'
        self.high: Optional[SCPBallot] = None             # h
        self.commit: Optional[SCPBallot] = None           # c
        self.latest_envelopes: Dict[bytes, object] = {}
        self.value_override: Optional[bytes] = None
        self.heard_from_quorum = False
        self.last_envelope = None          # latest self envelope
        self.last_envelope_emitted = None
        self.message_level = 0
        self.timer_exp_count = 0

    # ---------------- statement ordering ----------------

    def _is_newer(self, node: bytes, st: SCPStatement) -> bool:
        old = self.latest_envelopes.get(node)
        if old is None:
            return True
        return self._newer_statement(old.statement, st)

    @staticmethod
    def _newer_statement(oldst: SCPStatement, st: SCPStatement) -> bool:
        t = st.pledges.arm
        if oldst.pledges.arm != t:
            return oldst.pledges.arm < t
        if t == ST.SCP_ST_EXTERNALIZE:
            return False
        if t == ST.SCP_ST_CONFIRM:
            o, n = oldst.pledges.value, st.pledges.value
            cmp = compare_ballots(o.ballot, n.ballot)
            if cmp != 0:
                return cmp < 0
            if o.nPrepared != n.nPrepared:
                return o.nPrepared < n.nPrepared
            return o.nH < n.nH
        o, n = oldst.pledges.value, st.pledges.value
        cmp = compare_ballots(o.ballot, n.ballot)
        if cmp != 0:
            return cmp < 0
        cmp = compare_ballots(o.prepared, n.prepared)
        if cmp != 0:
            return cmp < 0
        cmp = compare_ballots(o.preparedPrime, n.preparedPrime)
        if cmp != 0:
            return cmp < 0
        return o.nH < n.nH

    # ---------------- sanity ----------------

    def _is_statement_sane(self, st: SCPStatement, self_st: bool) -> bool:
        from stellar_tpu_torch.scp.quorum import is_quorum_set_sane
        qset = self.slot.get_qset_from_statement(st)
        if qset is None or not is_quorum_set_sane(qset):
            return False
        t = st.pledges.arm
        p = st.pledges.value
        if t == ST.SCP_ST_PREPARE:
            ok = self_st or p.ballot.counter > 0
            ok = ok and ((p.preparedPrime is None or p.prepared is None) or
                         less_and_incompatible(p.preparedPrime, p.prepared))
            ok = ok and (p.nH == 0 or
                         (p.prepared is not None and
                          p.nH <= p.prepared.counter))
            ok = ok and (p.nC == 0 or
                         (p.nH != 0 and p.ballot.counter >= p.nH and
                          p.nH >= p.nC))
            return ok
        if t == ST.SCP_ST_CONFIRM:
            return (p.ballot.counter > 0 and p.nH <= p.ballot.counter
                    and p.nCommit <= p.nH)
        if t == ST.SCP_ST_EXTERNALIZE:
            return p.commit.counter > 0 and p.nH >= p.commit.counter
        return False

    # ---------------- value validation ----------------

    def _statement_values(self, st: SCPStatement) -> Set[bytes]:
        t = st.pledges.arm
        p = st.pledges.value
        vals: Set[bytes] = set()
        if t == ST.SCP_ST_PREPARE:
            if p.ballot.counter != 0:
                vals.add(p.ballot.value)
            if p.prepared is not None:
                vals.add(p.prepared.value)
            if p.preparedPrime is not None:
                vals.add(p.preparedPrime.value)
        elif t == ST.SCP_ST_CONFIRM:
            vals.add(p.ballot.value)
        else:
            vals.add(p.commit.value)
        return vals

    def _validate_values(self, st: SCPStatement) -> int:
        from stellar_tpu_torch.scp.driver import ValidationLevel
        vals = self._statement_values(st)
        if not vals:
            return ValidationLevel.INVALID
        level = ValidationLevel.FULLY_VALIDATED
        for v in vals:
            if level > ValidationLevel.INVALID:
                level = min(level, self.slot.driver.validate_value(
                    self.slot.slot_index, v, False))
        return level

    # ---------------- envelope processing ----------------

    def process_envelope(self, env, self_env: bool) -> int:
        from stellar_tpu_torch.scp.driver import ValidationLevel
        from stellar_tpu_torch.scp.scp import EnvelopeState
        st = env.statement
        assert st.slotIndex == self.slot.slot_index
        node = node_key(st.nodeID)

        if not self._is_statement_sane(st, self_env):
            return EnvelopeState.INVALID
        if not self._is_newer(node, st):
            return EnvelopeState.INVALID

        lv = self._validate_values(st)
        if lv == ValidationLevel.INVALID:
            return EnvelopeState.INVALID

        if self.phase != PH_EXTERNALIZE:
            if lv == ValidationLevel.MAYBE_VALID:
                self.slot.fully_validated = False
            self._record_envelope(env)
            self.advance_slot(st)
            return EnvelopeState.VALID

        # externalize phase: only accept compatible statements
        if self.commit.value == get_working_ballot(st).value:
            self._record_envelope(env)
            return EnvelopeState.VALID
        return EnvelopeState.INVALID

    def _record_envelope(self, env):
        self.latest_envelopes[node_key(env.statement.nodeID)] = env
        self.slot.record_statement(env.statement)

    # ---------------- bumping ----------------

    def abandon_ballot(self, n: int) -> bool:
        v = self.slot.nomination.get_latest_composite()
        if not v and self.current is not None:
            v = self.current.value
        if not v:
            return False
        if n == 0:
            return self.bump_state(v, force=True)
        return self.bump_state_to(v, n)

    def bump_state(self, value: bytes, force: bool) -> bool:
        if not force and self.current is not None:
            return False
        n = self.current.counter + 1 if self.current is not None else 1
        return self.bump_state_to(value, n)

    def bump_state_to(self, value: bytes, n: int) -> bool:
        if self.phase not in (PH_PREPARE, PH_CONFIRM):
            return False
        newb = _ballot(n, self.value_override
                       if self.value_override is not None else value)
        updated = self._update_current_value(newb)
        if updated:
            self._emit_current_state()
            self._check_heard_from_quorum()
        return updated

    def _update_current_value(self, ballot: SCPBallot) -> bool:
        if self.phase not in (PH_PREPARE, PH_CONFIRM):
            return False
        if self.current is None:
            self._bump_to_ballot(ballot, True)
            return True
        if self.commit is not None and \
                not ballots_compatible(self.commit, ballot):
            return False
        cmp = compare_ballots(self.current, ballot)
        if cmp < 0:
            self._bump_to_ballot(ballot, True)
            return True
        return False

    def _bump_to_ballot(self, ballot: SCPBallot, check: bool):
        assert self.phase != PH_EXTERNALIZE
        if check:
            assert self.current is None or \
                compare_ballots(ballot, self.current) >= 0
        got_bumped = self.current is None or \
            self.current.counter != ballot.counter
        if self.current is None:
            self.slot.driver.started_ballot_protocol(
                self.slot.slot_index, ballot)
        self.current = _copy(ballot)
        if self.high is not None and \
                not ballots_compatible(self.current, self.high):
            self.high = None
            self.commit = None
        if got_bumped:
            self.heard_from_quorum = False

    # ---------------- statement creation / emission ----------------

    def _create_statement(self, t: int) -> SCPStatement:
        self._check_invariants()
        if t == ST.SCP_ST_PREPARE:
            p = SCPStatementPrepare(
                quorumSetHash=self.slot.local_qset_hash,
                ballot=_copy(self.current) if self.current is not None
                else _ballot(0, b""),
                prepared=_copy(self.prepared)
                if self.prepared is not None else None,
                preparedPrime=_copy(self.prepared_prime)
                if self.prepared_prime is not None else None,
                nC=self.commit.counter if self.commit is not None else 0,
                nH=self.high.counter if self.high is not None else 0)
            pledges = SCPStatementPledges.make(ST.SCP_ST_PREPARE, p)
        elif t == ST.SCP_ST_CONFIRM:
            p = SCPStatementConfirm(
                ballot=_copy(self.current),
                nPrepared=self.prepared.counter,
                nCommit=self.commit.counter,
                nH=self.high.counter,
                quorumSetHash=self.slot.local_qset_hash)
            pledges = SCPStatementPledges.make(ST.SCP_ST_CONFIRM, p)
        else:
            p = SCPStatementExternalize(
                commit=_copy(self.commit),
                nH=self.high.counter,
                commitQuorumSetHash=self.slot.local_qset_hash)
            pledges = SCPStatementPledges.make(ST.SCP_ST_EXTERNALIZE, p)
        return SCPStatement(nodeID=self.slot.local_node_xdr,
                            slotIndex=self.slot.slot_index,
                            pledges=pledges)

    def _emit_current_state(self):
        from stellar_tpu_torch.scp.scp import EnvelopeState
        t = (ST.SCP_ST_PREPARE, ST.SCP_ST_CONFIRM,
             ST.SCP_ST_EXTERNALIZE)[self.phase]
        st = self._create_statement(t)
        env = self.slot.driver.sign_envelope(st)
        can_emit = self.current is not None

        last = self.latest_envelopes.get(self.slot.local_node_id)
        from stellar_tpu_torch.xdr.runtime import to_bytes
        from stellar_tpu_torch.xdr.scp import SCPEnvelope
        if last is not None and to_bytes(SCPEnvelope, last) == \
                to_bytes(SCPEnvelope, env):
            return
        if self.slot.process_envelope(env, self_env=True) != \
                EnvelopeState.VALID:
            raise RuntimeError("moved to a bad state (ballot protocol)")
        if can_emit and (self.last_envelope is None or
                         self._newer_statement(
                             self.last_envelope.statement, st)):
            self.last_envelope = env
            self._send_latest_envelope()

    def _send_latest_envelope(self):
        if self.message_level == 0 and self.last_envelope is not None \
                and self.slot.fully_validated:
            if self.last_envelope_emitted is not self.last_envelope:
                self.last_envelope_emitted = self.last_envelope
                self.slot.driver.emit_envelope(self.last_envelope)

    def _check_invariants(self):
        if self.phase in (PH_CONFIRM, PH_EXTERNALIZE):
            assert self.current is not None and self.prepared is not None
            assert self.commit is not None and self.high is not None
        if self.current is not None:
            assert self.current.counter != 0
        if self.prepared is not None and self.prepared_prime is not None:
            assert less_and_incompatible(self.prepared_prime, self.prepared)
        if self.high is not None:
            assert less_and_compatible(self.high, self.current)
        if self.commit is not None:
            assert less_and_compatible(self.commit, self.high)
            assert less_and_compatible(self.high, self.current)

    # ---------------- prepare candidates ----------------

    def _get_prepare_candidates(self, hint: SCPStatement
                                ) -> List[SCPBallot]:
        """Descending-sorted candidate ballots (reference
        ``getPrepareCandidates``)."""
        hint_ballots: Set[Tuple[int, bytes]] = set()
        t = hint.pledges.arm
        p = hint.pledges.value
        if t == ST.SCP_ST_PREPARE:
            hint_ballots.add(_ballot_key(p.ballot))
            if p.prepared is not None:
                hint_ballots.add(_ballot_key(p.prepared))
            if p.preparedPrime is not None:
                hint_ballots.add(_ballot_key(p.preparedPrime))
        elif t == ST.SCP_ST_CONFIRM:
            hint_ballots.add((p.nPrepared, p.ballot.value))
            hint_ballots.add((UINT32_MAX, p.ballot.value))
        else:
            hint_ballots.add((UINT32_MAX, p.commit.value))

        candidates: Set[Tuple[int, bytes]] = set()
        for counter, val in sorted(hint_ballots, reverse=True):
            top = _ballot(counter, val)
            for env in self.latest_envelopes.values():
                st = env.statement
                et = st.pledges.arm
                ep = st.pledges.value
                if et == ST.SCP_ST_PREPARE:
                    if less_and_compatible(ep.ballot, top):
                        candidates.add(_ballot_key(ep.ballot))
                    if ep.prepared is not None and \
                            less_and_compatible(ep.prepared, top):
                        candidates.add(_ballot_key(ep.prepared))
                    if ep.preparedPrime is not None and \
                            less_and_compatible(ep.preparedPrime, top):
                        candidates.add(_ballot_key(ep.preparedPrime))
                elif et == ST.SCP_ST_CONFIRM:
                    if ballots_compatible(top, ep.ballot):
                        candidates.add(_ballot_key(top))
                        if ep.nPrepared < top.counter:
                            candidates.add((ep.nPrepared, val))
                else:
                    if ballots_compatible(top, ep.commit):
                        candidates.add(_ballot_key(top))
        return [_ballot(c, v)
                for c, v in sorted(candidates, reverse=True)]

    # ---------------- accept prepared ----------------

    def _attempt_accept_prepared(self, hint: SCPStatement) -> bool:
        if self.phase not in (PH_PREPARE, PH_CONFIRM):
            return False
        for ballot in self._get_prepare_candidates(hint):
            if self.phase == PH_CONFIRM:
                if not less_and_compatible(self.prepared, ballot):
                    continue
                assert ballots_compatible(self.commit, ballot)
            if self.prepared_prime is not None and \
                    compare_ballots(ballot, self.prepared_prime) <= 0:
                continue
            if self.prepared is not None and \
                    less_and_compatible(ballot, self.prepared):
                continue

            def voted(st, _b=ballot):
                t = st.pledges.arm
                p = st.pledges.value
                if t == ST.SCP_ST_PREPARE:
                    return less_and_compatible(_b, p.ballot)
                if t == ST.SCP_ST_CONFIRM:
                    return ballots_compatible(_b, p.ballot)
                return ballots_compatible(_b, p.commit)

            if self.slot.federated_accept(
                    voted, lambda st, _b=ballot: has_prepared_ballot(_b, st),
                    self.latest_envelopes):
                return self._set_accept_prepared(ballot)
        return False

    def _set_accept_prepared(self, ballot: SCPBallot) -> bool:
        did_work = self._set_prepared(ballot)
        if self.commit is not None and self.high is not None:
            if ((self.prepared is not None and
                 less_and_incompatible(self.high, self.prepared)) or
                    (self.prepared_prime is not None and
                     less_and_incompatible(self.high,
                                           self.prepared_prime))):
                assert self.phase == PH_PREPARE
                self.commit = None
                did_work = True
        if did_work:
            self.slot.driver.accepted_ballot_prepared(
                self.slot.slot_index, ballot)
            self._emit_current_state()
        return did_work

    def _set_prepared(self, ballot: SCPBallot) -> bool:
        did_work = False
        if self.prepared is not None:
            cmp = compare_ballots(self.prepared, ballot)
            if cmp < 0:
                if not ballots_compatible(self.prepared, ballot):
                    self.prepared_prime = _copy(self.prepared)
                self.prepared = _copy(ballot)
                did_work = True
            elif cmp > 0:
                if self.prepared_prime is None or \
                        (compare_ballots(self.prepared_prime, ballot) < 0
                         and not ballots_compatible(self.prepared, ballot)):
                    self.prepared_prime = _copy(ballot)
                    did_work = True
        else:
            self.prepared = _copy(ballot)
            did_work = True
        return did_work

    # ---------------- confirm prepared ----------------

    def _attempt_confirm_prepared(self, hint: SCPStatement) -> bool:
        if self.phase != PH_PREPARE or self.prepared is None:
            return False
        candidates = self._get_prepare_candidates(hint)
        new_h = None
        idx = 0
        for i, ballot in enumerate(candidates):
            if self.high is not None and \
                    compare_ballots(self.high, ballot) >= 0:
                break
            if self.slot.federated_ratify(
                    lambda st, _b=ballot: has_prepared_ballot(_b, st),
                    self.latest_envelopes):
                new_h = ballot
                idx = i
                break
        if new_h is None:
            return False

        new_c = _ballot(0, b"")
        b = self.current if self.current is not None else _ballot(0, b"")
        if self.commit is None and \
                (self.prepared is None or
                 not less_and_incompatible(new_h, self.prepared)) and \
                (self.prepared_prime is None or
                 not less_and_incompatible(new_h, self.prepared_prime)):
            for ballot in candidates[idx:]:
                if compare_ballots(ballot, b) < 0:
                    break
                if not less_and_compatible(ballot, new_h):
                    continue
                if self.slot.federated_ratify(
                        lambda st, _b=ballot: has_prepared_ballot(_b, st),
                        self.latest_envelopes):
                    new_c = ballot
                else:
                    break
        return self._set_confirm_prepared(new_c, new_h)

    def _set_confirm_prepared(self, new_c: SCPBallot,
                              new_h: SCPBallot) -> bool:
        self.value_override = new_h.value
        did_work = False
        if self.current is None or \
                ballots_compatible(self.current, new_h):
            if self.high is None or \
                    compare_ballots(new_h, self.high) > 0:
                did_work = True
                self.high = _copy(new_h)
            if new_c.counter != 0:
                assert self.commit is None
                self.commit = _copy(new_c)
                did_work = True
            if did_work:
                self.slot.driver.confirmed_ballot_prepared(
                    self.slot.slot_index, new_h)
        did_work = self._update_current_if_needed(new_h) or did_work
        if did_work:
            self._emit_current_state()
        return did_work

    def _update_current_if_needed(self, h: SCPBallot) -> bool:
        if self.current is None or compare_ballots(self.current, h) < 0:
            self._bump_to_ballot(h, True)
            return True
        return False

    # ---------------- commit ----------------

    @staticmethod
    def _commit_predicate(ballot: SCPBallot, interval, st: SCPStatement
                          ) -> bool:
        t = st.pledges.arm
        p = st.pledges.value
        if t == ST.SCP_ST_PREPARE:
            return False
        if t == ST.SCP_ST_CONFIRM:
            if ballots_compatible(ballot, p.ballot):
                return p.nCommit <= interval[0] and \
                    interval[1] <= p.nH
            return False
        if ballots_compatible(ballot, p.commit):
            return p.commit.counter <= interval[0]
        return False

    def _commit_boundaries(self, ballot: SCPBallot) -> List[int]:
        res: Set[int] = set()
        for env in self.latest_envelopes.values():
            st = env.statement
            t = st.pledges.arm
            p = st.pledges.value
            if t == ST.SCP_ST_PREPARE:
                if ballots_compatible(ballot, p.ballot) and p.nC:
                    res.add(p.nC)
                    res.add(p.nH)
            elif t == ST.SCP_ST_CONFIRM:
                if ballots_compatible(ballot, p.ballot):
                    res.add(p.nCommit)
                    res.add(p.nH)
            else:
                if ballots_compatible(ballot, p.commit):
                    res.add(p.commit.counter)
                    res.add(p.nH)
                    res.add(UINT32_MAX)
        return sorted(res)

    @staticmethod
    def _find_extended_interval(boundaries: List[int], pred):
        """Widest [lo, hi] interval satisfying pred, scanning from the
        top (reference ``findExtendedInterval``)."""
        candidate = (0, 0)
        for b in reversed(boundaries):
            if candidate[0] == 0:
                cur = (b, b)
            elif b > candidate[1]:
                continue
            else:
                cur = (b, candidate[1])
            if pred(cur):
                candidate = cur
            elif candidate[0] != 0:
                break
        return candidate

    def _attempt_accept_commit(self, hint: SCPStatement) -> bool:
        if self.phase not in (PH_PREPARE, PH_CONFIRM):
            return False
        t = hint.pledges.arm
        p = hint.pledges.value
        if t == ST.SCP_ST_PREPARE:
            if p.nC == 0:
                return False
            ballot = _ballot(p.nH, p.ballot.value)
        elif t == ST.SCP_ST_CONFIRM:
            ballot = _ballot(p.nH, p.ballot.value)
        else:
            ballot = _ballot(p.nH, p.commit.value)

        if self.phase == PH_CONFIRM and \
                not ballots_compatible(ballot, self.high):
            return False

        def pred(interval):
            def voted(st):
                et = st.pledges.arm
                ep = st.pledges.value
                if et == ST.SCP_ST_PREPARE:
                    if ballots_compatible(ballot, ep.ballot) and ep.nC:
                        return ep.nC <= interval[0] and \
                            interval[1] <= ep.nH
                    return False
                if et == ST.SCP_ST_CONFIRM:
                    return ballots_compatible(ballot, ep.ballot) and \
                        ep.nCommit <= interval[0]
                return ballots_compatible(ballot, ep.commit) and \
                    ep.commit.counter <= interval[0]
            return self.slot.federated_accept(
                voted,
                lambda st: self._commit_predicate(ballot, interval, st),
                self.latest_envelopes)

        boundaries = self._commit_boundaries(ballot)
        if not boundaries:
            return False
        candidate = self._find_extended_interval(boundaries, pred)
        if candidate[0] != 0:
            if self.phase != PH_CONFIRM or \
                    candidate[1] > self.high.counter:
                return self._set_accept_commit(
                    _ballot(candidate[0], ballot.value),
                    _ballot(candidate[1], ballot.value))
        return False

    def _set_accept_commit(self, c: SCPBallot, h: SCPBallot) -> bool:
        did_work = False
        self.value_override = h.value
        if self.high is None or self.commit is None or \
                compare_ballots(self.high, h) != 0 or \
                compare_ballots(self.commit, c) != 0:
            self.commit = _copy(c)
            self.high = _copy(h)
            did_work = True
        if self.phase == PH_PREPARE:
            self.phase = PH_CONFIRM
            if self.current is not None and \
                    not less_and_compatible(h, self.current):
                self._bump_to_ballot(h, False)
            self.prepared_prime = None
            did_work = True
        if did_work:
            self._update_current_if_needed(self.high)
            self.slot.driver.accepted_commit(self.slot.slot_index, h)
            self._emit_current_state()
        return did_work

    def _attempt_confirm_commit(self, hint: SCPStatement) -> bool:
        if self.phase != PH_CONFIRM or self.high is None or \
                self.commit is None:
            return False
        t = hint.pledges.arm
        p = hint.pledges.value
        if t == ST.SCP_ST_PREPARE:
            return False
        if t == ST.SCP_ST_CONFIRM:
            ballot = _ballot(p.nH, p.ballot.value)
        else:
            ballot = _ballot(p.nH, p.commit.value)
        if not ballots_compatible(ballot, self.commit):
            return False

        boundaries = self._commit_boundaries(ballot)
        candidate = self._find_extended_interval(
            boundaries,
            lambda interval: self.slot.federated_ratify(
                lambda st: self._commit_predicate(ballot, interval, st),
                self.latest_envelopes))
        if candidate[0] == 0:
            return False
        return self._set_confirm_commit(
            _ballot(candidate[0], ballot.value),
            _ballot(candidate[1], ballot.value))

    def _set_confirm_commit(self, c: SCPBallot, h: SCPBallot) -> bool:
        self.commit = _copy(c)
        self.high = _copy(h)
        self._update_current_if_needed(self.high)
        self.phase = PH_EXTERNALIZE
        self._emit_current_state()
        self.slot.stop_nomination()
        self.slot.driver.value_externalized(
            self.slot.slot_index, self.commit.value)
        return True

    # ---------------- counter bumping (step 9) ----------------

    def _has_v_blocking_ahead_of(self, n: int) -> bool:
        return is_v_blocking_filtered(
            self.slot.local_qset,
            {k: e.statement for k, e in self.latest_envelopes.items()},
            lambda st: statement_ballot_counter(st) > n)

    def _attempt_bump(self) -> bool:
        if self.phase not in (PH_PREPARE, PH_CONFIRM):
            return False
        local_counter = self.current.counter \
            if self.current is not None else 0
        if not self._has_v_blocking_ahead_of(local_counter):
            return False
        all_counters = sorted(
            c for c in (statement_ballot_counter(e.statement)
                        for e in self.latest_envelopes.values())
            if c > local_counter)
        for n in all_counters:
            if not self._has_v_blocking_ahead_of(n):
                return self.abandon_ballot(n)
        return False

    # ---------------- quorum heartbeat / timer ----------------

    def _check_heard_from_quorum(self):
        from stellar_tpu_torch.scp.quorum import is_quorum
        from stellar_tpu_torch.scp.slot import BALLOT_PROTOCOL_TIMER
        if self.current is None:
            return

        def pred(env):
            st = env.statement
            if st.pledges.arm == ST.SCP_ST_PREPARE:
                return self.current.counter <= \
                    st.pledges.value.ballot.counter
            return True

        if is_quorum(self.slot.local_qset, self.latest_envelopes,
                     lambda e: self.slot.get_qset_from_statement(
                         e.statement), pred):
            old = self.heard_from_quorum
            self.heard_from_quorum = True
            if not old:
                self.slot.driver.ballot_did_hear_from_quorum(
                    self.slot.slot_index, self.current)
                if self.phase != PH_EXTERNALIZE:
                    self._start_timer()
            if self.phase == PH_EXTERNALIZE:
                self._stop_timer()
        else:
            self.heard_from_quorum = False
            self._stop_timer()

    def _start_timer(self):
        from stellar_tpu_torch.scp.slot import BALLOT_PROTOCOL_TIMER
        timeout = self.slot.driver.compute_timeout(self.current.counter)
        self.slot.driver.setup_timer(
            self.slot.slot_index, BALLOT_PROTOCOL_TIMER, timeout,
            self._timer_expired)

    def _stop_timer(self):
        from stellar_tpu_torch.scp.slot import BALLOT_PROTOCOL_TIMER
        self.slot.driver.stop_timer(self.slot.slot_index,
                                    BALLOT_PROTOCOL_TIMER)

    def _timer_expired(self):
        self.timer_exp_count += 1
        self.abandon_ballot(0)

    # ---------------- the advance loop ----------------

    def advance_slot(self, hint: SCPStatement):
        self.message_level += 1
        if self.message_level >= MAX_ADVANCE_SLOT_RECURSION:
            self.message_level -= 1
            raise RuntimeError("max advanceSlot recursion")
        did_work = False
        did_work = self._attempt_accept_prepared(hint) or did_work
        did_work = self._attempt_confirm_prepared(hint) or did_work
        did_work = self._attempt_accept_commit(hint) or did_work
        did_work = self._attempt_confirm_commit(hint) or did_work
        if self.message_level == 1:
            while True:
                did_bump = self._attempt_bump()
                did_work = did_bump or did_work
                if not did_bump:
                    break
            self._check_heard_from_quorum()
        self.message_level -= 1
        if did_work:
            self._send_latest_envelope()

    # ---------------- external state ----------------

    def get_externalizing_state(self) -> List:
        out = []
        if self.phase != PH_EXTERNALIZE:
            return out
        for node, env in self.latest_envelopes.items():
            if node != self.slot.local_node_id:
                if ballots_compatible(get_working_ballot(env.statement),
                                      self.commit):
                    out.append(env)
            elif self.slot.fully_validated:
                out.append(env)
        return out

    def set_state_from_envelope(self, env):
        """Restore ballot state from a persisted self-envelope
        (reference ``setStateFromEnvelope``)."""
        if self.current is not None:
            raise RuntimeError("cannot restore after starting")
        self._record_envelope(env)
        self.last_envelope = env
        self.last_envelope_emitted = env
        st = env.statement
        t = st.pledges.arm
        p = st.pledges.value
        if t == ST.SCP_ST_PREPARE:
            self._bump_to_ballot(p.ballot, True)
            if p.prepared is not None:
                self.prepared = _copy(p.prepared)
            if p.preparedPrime is not None:
                self.prepared_prime = _copy(p.preparedPrime)
            if p.nH:
                self.high = _ballot(p.nH, p.ballot.value)
            if p.nC:
                self.commit = _ballot(p.nC, p.ballot.value)
            self.phase = PH_PREPARE
        elif t == ST.SCP_ST_CONFIRM:
            v = p.ballot.value
            self._bump_to_ballot(p.ballot, True)
            self.prepared = _ballot(p.nPrepared, v)
            self.high = _ballot(p.nH, v)
            self.commit = _ballot(p.nCommit, v)
            self.phase = PH_CONFIRM
        else:
            v = p.commit.value
            self._bump_to_ballot(_ballot(UINT32_MAX, v), True)
            self.prepared = _ballot(UINT32_MAX, v)
            self.high = _ballot(p.nH, v)
            self.commit = _copy(p.commit)
            self.phase = PH_EXTERNALIZE
