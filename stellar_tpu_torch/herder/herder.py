"""Herder: the concrete SCP driver — slot = ledger sequence, value =
``StellarValue{txSetHash, closeTime, upgrades}`` — plus the glue between
the tx queue, tx sets, SCP, and the ledger close (reference
``src/herder/HerderImpl.cpp`` / ``HerderSCPDriver.cpp``).

Pipeline per ledger (reference call stack §3.3 of SURVEY.md):

  trigger_next_ledger: queue -> makeTxSetFromTransactions -> nominate
  recv_scp_envelope:   verify sig -> (txset known?) -> SCP
  value_externalized:  StellarValue -> LedgerCloseData -> closeLedger
                       -> queue shift/ban -> re-trigger after the
                       remainder of EXP_LEDGER_TIMESPAN

Envelope signatures are over (networkID ‖ ENVELOPE_TYPE_SCP ‖ statement)
— sig hot path #2 (``HerderImpl.cpp:2413-2431``); bulk floods should go
through ``prefetch_envelope_signatures`` to ride the card's batch verifier.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from stellar_tpu_torch.crypto.keys import (
    SecretKey, batch_verify_into_cache, cached_verify_sig,
    verify_sig,
)
from stellar_tpu_torch.crypto.tenant import peer_tenant
from stellar_tpu_torch.crypto.verify_service import service_verified
from stellar_tpu_torch.herder.transaction_queue import AddResult, TransactionQueue
from stellar_tpu_torch.herder.tx_set import (
    ApplicableTxSetFrame, TxSetXDRFrame, make_tx_set_from_transactions,
)
from stellar_tpu_torch.ledger.ledger_manager import LedgerCloseData, LedgerManager
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_tpu_torch.scp import SCP, EnvelopeState, SCPDriver, ValidationLevel
from stellar_tpu_torch.scp.slot import BALLOT_PROTOCOL_TIMER, NOMINATION_TIMER
from stellar_tpu_torch.utils.timer import VirtualClock, VirtualTimer
from stellar_tpu_torch.xdr.ledger import StellarValue, basic_stellar_value
from stellar_tpu_torch.xdr.runtime import Packer, from_bytes, to_bytes
from stellar_tpu_torch.xdr.scp import SCPEnvelope, SCPQuorumSet, SCPStatement
from stellar_tpu_torch.xdr.types import EnvelopeType

__all__ = ["Herder", "HERDER_STATE"]

# reference src/herder/Herder.cpp:7-22
EXP_LEDGER_TIMESPAN_SECONDS = 5
MAX_SCP_TIMEOUT_SECONDS = 240
CONSENSUS_STUCK_TIMEOUT_SECONDS = 35
MAX_TIME_SLIP_SECONDS = 60
LEDGER_VALIDITY_BRACKET = 100  # max slots ahead we accept
SCP_EXTRA_LOOKBACK_LEDGERS = 3


class HERDER_STATE:
    BOOTING = 0
    TRACKING = 1
    OUT_OF_SYNC = 2


def scp_envelope_sign_payload(network_id: bytes,
                              statement: SCPStatement) -> bytes:
    """(networkID ‖ ENVELOPE_TYPE_SCP ‖ statement) — what validators
    sign (reference ``HerderImpl::signEnvelope``)."""
    p = Packer()
    p.pack_fopaque(32, network_id)
    p.pack_int(EnvelopeType.ENVELOPE_TYPE_SCP)
    SCPStatement.pack(p, statement)
    return p.bytes()


class _HerderSCPDriver(SCPDriver):
    """SCP callbacks bound to a Herder (reference HerderSCPDriver)."""

    def __init__(self, herder: "Herder"):
        self.herder = herder

    # -- values --

    def get_node_weight(self, node_id, qset, is_local: bool) -> int:
        """Application-specific nomination weights from protocol 22
        (reference ``HerderSCPDriver::getNodeWeight``,
        HerderSCPDriver.cpp:1287-1352): a validator's weight is its
        quality level's weight divided by its home-domain size; falls
        back to the qset-structural weight below p22, under
        FORCE_OLD_STYLE_LEADER_ELECTION, with a manual QUORUM_SET, or
        for nodes outside the declared validator list."""
        h = self.herder
        cfg = h.node_config
        if cfg is None or \
                getattr(cfg, "FORCE_OLD_STYLE_LEADER_ELECTION", False) \
                or h.lm.last_closed_header.ledgerVersion < 22:
            return super().get_node_weight(node_id, qset, is_local)
        vwc = cfg.validator_weight_config() \
            if hasattr(cfg, "validator_weight_config") else None
        if vwc is None:
            return super().get_node_weight(node_id, qset, is_local)
        from stellar_tpu_torch.scp.quorum import node_key
        entry = vwc["entries"].get(node_key(node_id))
        if entry is None:
            return super().get_node_weight(node_id, qset, is_local)
        domain, quality = entry
        return vwc["quality_weights"][quality] // \
            vwc["domain_sizes"][domain]

    def validate_value(self, slot_index, value, nomination):
        return self.herder._validate_value(slot_index, value, nomination)

    def extract_valid_value(self, slot_index, value):
        return self.herder._extract_valid_value(slot_index, value)

    def combine_candidates(self, slot_index, candidates):
        return self.herder._combine_candidates(slot_index, candidates)

    # -- plumbing --

    def sign_envelope(self, statement):
        sig = self.herder.secret_key.sign(
            scp_envelope_sign_payload(self.herder.network_id, statement))
        return SCPEnvelope(statement=statement, signature=sig)

    def emit_envelope(self, envelope):
        self.herder._emit_envelope(envelope)

    def get_qset(self, qset_hash):
        return self.herder.qsets.get(qset_hash)

    def setup_timer(self, slot_index, timer_id, timeout_ms, callback):
        self.herder._setup_timer(slot_index, timer_id, timeout_ms,
                                 callback)

    def compute_timeout(self, round_number):
        secs = min(round_number, MAX_SCP_TIMEOUT_SECONDS)
        return secs * 1000

    # -- notifications --

    def value_externalized(self, slot_index, value):
        self.herder._value_externalized(slot_index, value)


def _excluded_op_types(names) -> frozenset:
    """OperationType values for configured names (reference
    EXCLUDE_TRANSACTIONS_CONTAINING_OPERATION_TYPE); unknown names are
    a config error."""
    if not names:
        return frozenset()
    from stellar_tpu_torch.xdr.tx import OperationType
    out = set()
    for name in names:
        t = getattr(OperationType, name, None)
        if t is None:
            raise ValueError(f"unknown operation type {name!r} in "
                             "EXCLUDE_TRANSACTIONS_CONTAINING_"
                             "OPERATION_TYPE")
        out.add(t)
    return frozenset(out)


class Herder:
    def __init__(self, secret_key: SecretKey, network_id: bytes,
                 ledger_manager: LedgerManager, clock: VirtualClock,
                 qset: SCPQuorumSet, is_validator: bool = True,
                 target_close_seconds: int = EXP_LEDGER_TIMESPAN_SECONDS,
                 max_slots_to_remember: int = 12,
                 node_config=None):
        self.secret_key = secret_key
        self.network_id = network_id
        self.lm = ledger_manager
        self.clock = clock
        self.target_close_seconds = target_close_seconds
        # operational knobs (reference Config.h); node_config is the
        # main Config when running inside an Application
        self.node_config = node_config
        # externalized-slot retention (reference MAX_SLOTS_TO_REMEMBER)
        self.max_slots_to_remember = max(max_slots_to_remember,
                                         SCP_EXTRA_LOOKBACK_LEDGERS)
        self.driver = _HerderSCPDriver(self)
        self.scp = SCP(self.driver, secret_key.public_key.raw,
                       is_validator, qset)
        from stellar_tpu_torch.xdr.scp import quorum_set_hash
        self.qsets: Dict[bytes, SCPQuorumSet] = {
            quorum_set_hash(qset): qset}
        from stellar_tpu_torch.herder.upgrades import Upgrades
        self.upgrades = Upgrades()
        # txset hash -> ApplicableTxSetFrame (PendingEnvelopes role)
        self.tx_sets: Dict[bytes, ApplicableTxSetFrame] = {}
        # envelopes waiting for their txset: txset hash -> [envelope]
        self.waiting_envelopes: Dict[bytes, List[SCPEnvelope]] = {}
        # envelopes waiting for an unknown quorum set
        self.waiting_for_qset: Dict[bytes, List[SCPEnvelope]] = {}
        # background quorum-intersection analysis state (reference
        # mLastQuorumMapIntersectionState)
        self._qic_last_hash: bytes = b""
        self._qic_inflight = None
        self.latest_quorum_intersection: Optional[dict] = None
        # fetch hooks (wired by the overlay): ask peers for missing items
        self.request_tx_set: Callable = lambda h: None
        self.request_quorum_set: Callable = lambda h: None
        # queue capacities scale the ledger limits by the configured
        # multipliers (reference TRANSACTION_QUEUE_SIZE_MULTIPLIER /
        # SOROBAN_TRANSACTION_QUEUE_SIZE_MULTIPLIER); excluded op types
        # and the ban depth ride the same Config
        _mult = getattr(node_config,
                        "TRANSACTION_QUEUE_SIZE_MULTIPLIER", 2)
        _smult = getattr(node_config,
                         "SOROBAN_TRANSACTION_QUEUE_SIZE_MULTIPLIER", 2)
        _ban = getattr(node_config, "TRANSACTION_QUEUE_BAN_LEDGERS", 10)
        _excluded = _excluded_op_types(getattr(
            node_config,
            "EXCLUDE_TRANSACTIONS_CONTAINING_OPERATION_TYPE", ()))
        self.tx_queue = TransactionQueue(
            max_ops=_mult * self.lm.last_closed_header.maxTxSetSize,
            check_valid=self._check_tx_valid, ban_ledgers=_ban,
            excluded_op_types=_excluded)
        # Soroban txs queue separately with their own (tx-count) limits
        # (reference SorobanTransactionQueue); pull-mode relay and set
        # building see both through the facade methods below
        _scfg = getattr(ledger_manager, "soroban_config", None)
        if _scfg is None:
            from stellar_tpu_torch.tx.ops.soroban_ops import (
                default_soroban_config,
            )
            _scfg = default_soroban_config()
        self.soroban_tx_queue = TransactionQueue(
            max_ops=_smult * _scfg.ledger_max_tx_count,
            check_valid=self._check_tx_valid, ban_ledgers=_ban,
            excluded_op_types=_excluded)
        self.state = HERDER_STATE.BOOTING
        self.tracking_slot = 0
        # buffering + catchup arbitration for out-of-order externalizes
        # (reference LedgerApplyManagerImpl::processLedger); applies go
        # through _apply_externalized so drains carry full bookkeeping
        from stellar_tpu_torch.catchup.catchup import LedgerApplyManager
        self.ledger_apply = LedgerApplyManager(
            ledger_manager, apply_fn=self._apply_externalized)
        self.on_catchup_needed = None  # app hook: start archive catchup
        self._timers: Dict[tuple, VirtualTimer] = {}
        self._trigger_timer = VirtualTimer(clock)
        self._stuck_timer = VirtualTimer(clock)
        self.request_scp_state = None  # overlay hook: pull peers' state
        # overlay hook: settle off-crank preverification before a
        # proposal is built (deterministic resolve point)
        self.before_nomination: Optional[Callable] = None
        self._trigger_armed_for = 0
        self._last_trigger_at = 0.0
        # network hooks (set by overlay / simulation): fan out to peers
        self.broadcast_envelope: Callable = lambda env: None
        self.broadcast_tx_set: Callable = lambda frame: None
        self.broadcast_transaction: Callable = lambda frame: None
        # herder-level observers
        self.on_externalized: Optional[Callable] = None

    # ---------------- qset/txset registry ----------------

    def register_qset(self, qset: SCPQuorumSet):
        from stellar_tpu_torch.xdr.scp import quorum_set_hash
        h = quorum_set_hash(qset)
        if h in self.qsets:
            return
        self.qsets[h] = qset
        for env in self.waiting_for_qset.pop(h, []):
            self.recv_scp_envelope(env)

    def recv_tx_set(self, frame) -> bool:
        """Register a tx set heard from the network; releases any SCP
        envelopes waiting on it (reference
        ``PendingEnvelopes::recvTxSet``)."""
        if isinstance(frame, TxSetXDRFrame):
            applicable = frame.prepare_for_apply(self.network_id)
            if applicable is None:
                return False
        else:
            applicable = frame
        h = applicable.hash
        if h in self.tx_sets:
            return True
        self.tx_sets[h] = applicable
        # release held envelopes — but only those with no OTHER missing
        # tx set (an envelope held under several hashes is fed exactly
        # once, when its last dependency arrives)
        for env in self.waiting_envelopes.pop(h, []):
            if not self._missing_tx_sets(env.statement):
                self._feed_scp(env)
        return True

    def get_tx_set(self, h: bytes) -> Optional[ApplicableTxSetFrame]:
        return self.tx_sets.get(h)

    # ---------------- transactions ----------------

    def _check_tx_valid(self, frame, current_seq: int = 0):
        with LedgerTxn(self.lm.root) as ltx:
            res = frame.check_valid(
                ltx, current_seq, 0, self.target_close_seconds)
            ltx.rollback()
        return res

    def recv_transaction(self, frame, submitted_from_self=False
                         ) -> AddResult:
        """Reference ``HerderImpl::recvTransaction``: admit to the queue
        and flood on success."""
        res = self.queue_for(frame).try_add(frame)
        if res.code == AddResult.ADD_STATUS_PENDING:
            self.broadcast_transaction(frame)
        return res

    def queue_for(self, frame) -> TransactionQueue:
        return self.soroban_tx_queue if frame.is_soroban() \
            else self.tx_queue

    def get_pending_tx(self, tx_hash: bytes):
        """Pull-mode demand lookup across both queues."""
        return self.tx_queue.known_hashes.get(tx_hash) or \
            self.soroban_tx_queue.known_hashes.get(tx_hash)

    def is_tx_known_or_banned(self, tx_hash: bytes) -> bool:
        return (tx_hash in self.tx_queue.known_hashes or
                tx_hash in self.soroban_tx_queue.known_hashes or
                self.tx_queue.is_banned(tx_hash) or
                self.soroban_tx_queue.is_banned(tx_hash))

    # ---------------- SCP envelopes ----------------

    def verify_envelope(self, env: SCPEnvelope) -> bool:
        """Sig hot path #2 (reference ``HerderImpl::verifyEnvelope``).

        When the resident verify service is running
        (``VERIFY_SERVICE_ENABLED``), the envelope rides the ``scp``
        priority lane — the one lane the shed ladder NEVER sheds, so
        consensus keeps making progress while bulk work sheds under
        overload. A ``batch_verify_into_cache`` prefetch still wins
        (cache consulted first), the verdict re-seeds that cache so
        flood dedup stays O(1), and ingress rejection or any
        service-side failure falls back to the direct path — the
        decision is bit-identical on every route, so the service can
        only ever change latency, never validity."""
        payload = scp_envelope_sign_payload(self.network_id,
                                            env.statement)
        pk = env.statement.nodeID.value
        got = cached_verify_sig(pk, payload, env.signature)
        if got is not None:
            return got
        # shared adopter block (service_verified): bounded wait +
        # cache seeding + any-failure fallback — previously this call
        # had NO result timeout, so a wedged dispatcher could park
        # the consensus crank on an unresolved scp ticket. The round
        # trip is tenant-tagged with the envelope's VALIDATOR identity
        # when VERIFY_TENANT_FROM_PEER is on (the per-tenant quotas
        # of the service), so one flooding validator degrades
        # itself, not the whole scp lane; off (the default) keeps the
        # quota-exempt un-tenanted stream byte-identical.
        res = service_verified([(pk, payload, env.signature)],
                               lane="scp", tenant=peer_tenant(pk))
        if res is not None:
            return res[0]
        return verify_sig(pk, payload, env.signature)

    def prefetch_envelope_signatures(self, envs: List[SCPEnvelope]):
        """Batch-verify an envelope flood in one device round trip; the
        per-envelope verify_envelope calls then hit the cache."""
        batch_verify_into_cache([
            (e.statement.nodeID.value,
             scp_envelope_sign_payload(self.network_id, e.statement),
             e.signature)
            for e in envs])

    def recv_scp_envelope(self, env: SCPEnvelope) -> int:
        """Reference ``HerderImpl::recvSCPEnvelope``."""
        from stellar_tpu_torch.utils.tracing import zone
        with zone("herder.recvSCPEnvelope"):
            return self._recv_scp_envelope_inner(env)

    def _recv_scp_envelope_inner(self, env: SCPEnvelope) -> int:
        if not self.verify_envelope(env):
            return EnvelopeState.INVALID
        slot = env.statement.slotIndex
        low = max(1, self.lm.ledger_seq - SCP_EXTRA_LOOKBACK_LEDGERS)
        if slot < low or \
                slot > self.lm.ledger_seq + LEDGER_VALIDITY_BRACKET:
            return EnvelopeState.INVALID
        # hold envelopes pledging under a quorum set we don't know yet
        # (reference PendingEnvelopes qset fetch)
        qh = self._statement_qset_hash(env.statement)
        if qh not in self.qsets:
            self.waiting_for_qset.setdefault(qh, []).append(env)
            self.request_quorum_set(qh)
            return EnvelopeState.VALID
        # hold envelopes whose tx sets we don't have yet
        missing = self._missing_tx_sets(env.statement)
        if missing:
            for h in missing:
                self.waiting_envelopes.setdefault(h, []).append(env)
                self.request_tx_set(h)
            return EnvelopeState.VALID
        return self._feed_scp(env)

    @staticmethod
    def _statement_qset_hash(st: SCPStatement) -> bytes:
        from stellar_tpu_torch.xdr.scp import SCPStatementType as T
        p = st.pledges.value
        if st.pledges.arm == T.SCP_ST_EXTERNALIZE:
            return p.commitQuorumSetHash
        return p.quorumSetHash

    def _feed_scp(self, env: SCPEnvelope) -> int:
        return self.scp.receive_envelope(env)

    def _missing_tx_sets(self, st: SCPStatement) -> List[bytes]:
        out = []
        for v in self._statement_values(st):
            sv = _parse_stellar_value(v)
            if sv is not None and sv.txSetHash not in self.tx_sets \
                    and sv.txSetHash not in out:
                out.append(sv.txSetHash)
        return out

    @staticmethod
    def _statement_values(st: SCPStatement) -> List[bytes]:
        from stellar_tpu_torch.xdr.scp import SCPStatementType as T
        t = st.pledges.arm
        p = st.pledges.value
        if t == T.SCP_ST_NOMINATE:
            return list(p.votes) + list(p.accepted)
        if t == T.SCP_ST_PREPARE:
            vals = [p.ballot.value]
            if p.prepared is not None:
                vals.append(p.prepared.value)
            if p.preparedPrime is not None:
                vals.append(p.preparedPrime.value)
            return vals
        if t == T.SCP_ST_CONFIRM:
            return [p.ballot.value]
        return [p.commit.value]

    # ---------------- value validation / combination ----------------

    def _closetime_drift(self) -> int:
        """Configured MAXIMUM_LEDGER_CLOSETIME_DRIFT, or the
        reference's derivation: min((slots+2) * close cadence, 90s)
        (Config.cpp:196-204)."""
        cfg = getattr(self.node_config,
                      "MAXIMUM_LEDGER_CLOSETIME_DRIFT", 0)
        if cfg > 0:
            return cfg
        return min((self.max_slots_to_remember + 2) *
                   self.target_close_seconds, 90)

    def _validate_value(self, slot_index: int, value: bytes,
                        nomination: bool) -> int:
        sv = _parse_stellar_value(value)
        if sv is None:
            return ValidationLevel.INVALID
        lcl = self.lm.last_closed_header
        # close time advances strictly, and not absurdly into the future
        if sv.closeTime <= lcl.scpValue.closeTime:
            return ValidationLevel.INVALID
        if nomination:
            now = self.clock.system_now()
            if sv.closeTime > now + MAX_TIME_SLIP_SECONDS:
                return ValidationLevel.INVALID
            # and not absurdly in the past either (reference
            # MAXIMUM_LEDGER_CLOSETIME_DRIFT, HerderImpl.cpp:656-658;
            # 0 derives the reference's MAX_SLOTS_TO_REMEMBER bound)
            drift = self._closetime_drift()
            if now >= drift and sv.closeTime < now - drift:
                return ValidationLevel.INVALID
        # every carried upgrade must be apply-valid (and, at nomination,
        # exactly what this node scheduled) — reference
        # validateUpgrades in HerderSCPDriver::validateValueHelper
        for raw in sv.upgrades:
            if not self.upgrades.is_valid(
                    raw, lcl, nomination, sv.closeTime,
                    state_getter=self.lm.root.store.get):
                return ValidationLevel.INVALID
        if slot_index != lcl.ledgerSeq + 1:
            # can't fully validate against a non-current ledger
            return ValidationLevel.MAYBE_VALID
        txset = self.tx_sets.get(sv.txSetHash)
        if txset is None:
            return ValidationLevel.MAYBE_VALID
        with LedgerTxn(self.lm.root) as ltx:
            ok = txset.check_valid(ltx, self.lm.last_closed_hash)
            ltx.rollback()
        return ValidationLevel.FULLY_VALIDATED if ok \
            else ValidationLevel.INVALID

    def _extract_valid_value(self, slot_index: int, value: bytes
                             ) -> Optional[bytes]:
        """Salvage a nominated value by stripping upgrades this node
        won't vote for (reference
        ``HerderSCPDriver::extractValidValue``)."""
        sv = _parse_stellar_value(value)
        if sv is None:
            return None
        lcl = self.lm.last_closed_header
        if sv.closeTime <= lcl.scpValue.closeTime:
            return None
        kept = [u for u in sv.upgrades
                if self.upgrades.is_valid(
                    u, lcl, True, sv.closeTime,
                    state_getter=self.lm.root.store.get)]
        if len(kept) == len(sv.upgrades):
            return value
        return to_bytes(StellarValue, basic_stellar_value(
            sv.txSetHash, sv.closeTime, upgrades=kept))

    def _combine_candidates(self, slot_index: int,
                            candidates) -> Optional[bytes]:
        """Pick the best txset (most ops, xored-hash tiebreak), max
        closeTime, merged upgrades (reference
        ``HerderSCPDriver::combineCandidates``)."""
        from stellar_tpu_torch.crypto.sha import sha256
        parsed = []
        for v in sorted(candidates):
            sv = _parse_stellar_value(v)
            if sv is not None:
                parsed.append(sv)
        if not parsed:
            return None
        candidates_hash = sha256(b"".join(sorted(candidates)))
        best = None
        best_key = None
        max_close = 0
        upgrades: Dict[int, object] = {}
        for sv in parsed:
            max_close = max(max_close, sv.closeTime)
            txset = self.tx_sets.get(sv.txSetHash)
            ops = txset.size_op() if txset is not None else 0
            xored = bytes(a ^ b for a, b in
                          zip(sv.txSetHash, candidates_hash))
            key = (ops, xored)
            if best_key is None or key > best_key:
                best_key = key
                best = sv
            for raw in sv.upgrades:
                from stellar_tpu_torch.xdr.ledger import LedgerUpgrade
                try:
                    up = from_bytes(LedgerUpgrade, bytes(raw))
                except Exception:
                    continue
                cur = upgrades.get(up.arm)
                if cur is None or up.value > cur.value:
                    upgrades[up.arm] = up
        from stellar_tpu_torch.xdr.ledger import LedgerUpgrade
        up_bytes = [to_bytes(LedgerUpgrade, upgrades[t])
                    for t in sorted(upgrades)]
        out = basic_stellar_value(best.txSetHash, max_close, up_bytes)
        return to_bytes(StellarValue, out)

    # ---------------- timers ----------------

    def _setup_timer(self, slot_index, timer_id, timeout_ms, callback):
        key = (slot_index, timer_id)
        timer = self._timers.get(key)
        if timer is None:
            timer = self._timers[key] = VirtualTimer(self.clock)
        timer.cancel()
        if callback is not None and timeout_ms >= 0:
            timer.expires_from_now(timeout_ms / 1000.0)
            timer.async_wait(callback)

    # ---------------- nomination trigger ----------------

    def start(self):
        """Begin participating: arm the first ledger trigger."""
        self.state = HERDER_STATE.TRACKING
        self.tracking_slot = self.lm.ledger_seq + 1
        self._arm_trigger(0.0)
        self._arm_stuck_timer()

    # ---------------- stuck detection / out-of-sync recovery --------

    def _arm_stuck_timer(self):
        """Reference ``Herder::CONSENSUS_STUCK_TIMEOUT_SECONDS``: no
        externalize for 35s -> lost sync."""
        self._stuck_timer.cancel()
        self._stuck_timer.expires_from_now(
            CONSENSUS_STUCK_TIMEOUT_SECONDS)
        self._stuck_timer.async_wait(self._lost_sync)

    def _lost_sync(self):
        """Reference ``HerderImpl::lostSync`` + out-of-sync recovery:
        flag the state and periodically pull peers' SCP state until an
        externalize restores tracking."""
        self.state = HERDER_STATE.OUT_OF_SYNC
        from stellar_tpu_torch.utils.metrics import registry
        registry.counter("herder.lost-sync").inc()
        self._out_of_sync_recovery()

    def _out_of_sync_recovery(self):
        if self.state != HERDER_STATE.OUT_OF_SYNC:
            return
        if self.request_scp_state is not None:
            self.request_scp_state(self.lm.ledger_seq + 1)
        # keep nudging at close cadence until tracking returns
        self._stuck_timer.cancel()
        self._stuck_timer.expires_from_now(self.target_close_seconds)
        self._stuck_timer.async_wait(self._out_of_sync_recovery)

    def _arm_trigger(self, delay: float):
        seq = self.lm.ledger_seq + 1
        self._trigger_armed_for = seq
        self._trigger_timer.cancel()
        self._trigger_timer.expires_from_now(max(0.0, delay))
        self._trigger_timer.async_wait(
            lambda: self.trigger_next_ledger(seq))

    def trigger_next_ledger(self, ledger_seq_to_trigger: int):
        """Reference ``HerderImpl::triggerNextLedger``: build + nominate
        this node's proposal."""
        if ledger_seq_to_trigger != self.lm.ledger_seq + 1:
            return
        # deterministic resolve point: any off-crank pre-verified tx
        # floods must land in the queues BEFORE the proposal is built
        # (virtual-clock cranks would otherwise race real worker
        # threads — the single-writer-crank determinism rule)
        if self.before_nomination is not None:
            self.before_nomination()
        self._last_trigger_at = self.clock.now()
        lcl = self.lm.last_closed_header
        frames = self.tx_queue.get_transactions() + \
            self.soroban_tx_queue.get_transactions()
        txset, _ = make_tx_set_from_transactions(
            frames, lcl, self.lm.last_closed_hash,
            soroban_config=getattr(self.lm, "soroban_config", None),
            max_dex_ops=getattr(self.node_config,
                                "MAX_DEX_TX_OPERATIONS_IN_TX_SET",
                                None))
        self.recv_tx_set(txset)
        self.broadcast_tx_set(txset)
        close_time = max(self.clock.system_now(),
                         lcl.scpValue.closeTime + 1)
        sv = basic_stellar_value(
            txset.hash, close_time,
            upgrades=self.upgrades.create_upgrades_for(
                lcl, close_time,
                soroban_config=getattr(self.lm, "soroban_config", None),
                state_getter=self.lm.root.store.get
                if hasattr(self.lm.root, "store") else None))
        prev = to_bytes(StellarValue, lcl.scpValue)
        self.scp.nominate(ledger_seq_to_trigger,
                          to_bytes(StellarValue, sv), prev)

    # ---------------- externalize ----------------

    def _emit_envelope(self, envelope: SCPEnvelope):
        self.broadcast_envelope(envelope)

    def _value_externalized(self, slot_index: int, value: bytes):
        """Reference ``HerderImpl::valueExternalized`` →
        ``LedgerManager::valueExternalized`` →
        ``LedgerApplyManager::processLedger``: apply in sequence,
        buffer ahead-of-LCL slots, signal catchup when the gap grows."""
        sv = _parse_stellar_value(value)
        if sv is None:
            raise RuntimeError("externalized unparsable value")
        txset = self.tx_sets.get(sv.txSetHash)
        if txset is None:
            raise RuntimeError("externalized unknown tx set")
        if slot_index <= self.lm.ledger_seq:
            return  # stale: already applied
        lcd = LedgerCloseData(
            ledger_seq=slot_index, tx_set=txset,
            close_time=sv.closeTime, upgrades=list(sv.upgrades))
        outcome = self.ledger_apply.process_ledger(lcd)
        if outcome == "applied":
            return  # bookkeeping ran per applied close
        # ahead of the LCL: buffered; once the gap passes the trigger
        # depth, ask the application to catch up from archives
        # (reference LM_CATCHING_UP_STATE)
        self.state = HERDER_STATE.OUT_OF_SYNC
        if outcome == "catchup-needed" and \
                self.on_catchup_needed is not None:
            self.on_catchup_needed(slot_index)

    def drain_buffered(self):
        """Apply any buffered contiguous successors of the LCL (called
        after a catchup closes the gap)."""
        self.ledger_apply.drain()

    def _apply_externalized(self, lcd: LedgerCloseData):
        slot_index = lcd.ledger_seq
        txset = lcd.tx_set
        result = self.lm.close_ledger(lcd)
        self.upgrades.remove_upgrades_once_done(
            result.header,
            soroban_config=getattr(self.lm, "soroban_config", None),
            state_getter=self.lm.root.store.get
            if hasattr(self.lm.root, "store") else None)
        self.state = HERDER_STATE.TRACKING
        self.tracking_slot = slot_index + 1
        self._arm_stuck_timer()  # progress: reset the 35s watchdog
        # queue bookkeeping
        self.tx_queue.remove_applied(txset.frames)
        self.tx_queue.shift()
        # ledger limits can change via upgrades mid-run; re-derive the
        # queue caps with the CONFIGURED multipliers
        _mult = getattr(self.node_config,
                        "TRANSACTION_QUEUE_SIZE_MULTIPLIER", 2)
        _smult = getattr(self.node_config,
                         "SOROBAN_TRANSACTION_QUEUE_SIZE_MULTIPLIER", 2)
        self.tx_queue.max_ops = \
            _mult * self.lm.last_closed_header.maxTxSetSize
        self.soroban_tx_queue.remove_applied(txset.frames)
        self.soroban_tx_queue.shift()
        scfg = getattr(self.lm, "soroban_config", None)
        if scfg is not None:
            self.soroban_tx_queue.max_ops = \
                _smult * scfg.ledger_max_tx_count
        # GC old slots + their timers + txsets
        keep_from = max(1, slot_index - self.max_slots_to_remember)
        self.scp.purge_slots(keep_from)
        for key in [k for k in self._timers if k[0] < keep_from]:
            self._timers.pop(key).cancel()
        self._gc_tx_sets()
        self._maybe_reanalyze_quorum_map()
        if self.on_externalized is not None:
            self.on_externalized(slot_index, result)
        # pace the next ledger to the target cadence
        elapsed = self.clock.now() - self._last_trigger_at
        self._arm_trigger(max(0.0, self.target_close_seconds - elapsed))

    def _maybe_reanalyze_quorum_map(self):
        """Reference ``checkAndMaybeReanalyzeQuorumMap``
        (HerderImpl.cpp:1852-1905): when QUORUM_INTERSECTION_CHECKER
        is on and the tracked quorum map changed since the last
        analysis, re-run the bounded intersection check off-crank and
        remember the result (``latest_quorum_intersection``; a
        detected split is logged as an error)."""
        if self.node_config is None or not getattr(
                self.node_config, "QUORUM_INTERSECTION_CHECKER", False):
            return
        from stellar_tpu_torch.utils import workers
        if not workers.background_enabled():
            # the bounded search can still cost millions of sat calls;
            # the reference only ever runs it off-thread, so inline
            # (deterministic/pessimized) modes skip it rather than
            # stall externalize
            return
        from stellar_tpu_torch.crypto.sha import sha256
        from stellar_tpu_torch.herder.quorum_tracker import QuorumTracker
        from stellar_tpu_torch.xdr.scp import quorum_set_hash
        # SNAPSHOT on the crank thread: the worker must never touch
        # live herder state (workers contract: pure fn over immutable
        # inputs); the hash covers the node->qset ASSIGNMENT, not just
        # the learned-qset set (reference hashes the tracked map)
        qmap = QuorumTracker(self).node_qset_map()
        qmap_hash = sha256(b"".join(
            n + (quorum_set_hash(q) if q is not None else b"\x00" * 32)
            for n, q in sorted(qmap.items())))
        if qmap_hash == self._qic_last_hash or \
                self._qic_inflight is not None:
            return
        self._qic_last_hash = qmap_hash

        def run():
            return QuorumTracker(self).analyze(qmap=qmap)

        fut = workers.run_async(run)
        self._qic_inflight = fut

        def done(f):
            self._qic_inflight = None
            try:
                out = f.result()
            except Exception as e:
                import logging
                logging.getLogger("stellar_tpu.herder").warning(
                    "quorum intersection analysis failed: %s", e)
                # retry on the next externalize
                self._qic_last_hash = b""
                return
            self.latest_quorum_intersection = out
            if out.get("intersection") is False:
                import logging
                logging.getLogger("stellar_tpu.herder").error(
                    "POSSIBLE QUORUM SPLIT detected: %s",
                    out.get("split"))
        fut.add_done_callback(done)

    def _gc_tx_sets(self):
        """Keep only tx sets referenced by live slots' values."""
        live: set = set()
        for idx in self.scp.known_slots:
            slot = self.scp.known_slots[idx]
            for env in slot.get_current_state():
                for v in self._statement_values(env.statement):
                    sv = _parse_stellar_value(v)
                    if sv is not None:
                        live.add(sv.txSetHash)
        self.tx_sets = {h: t for h, t in self.tx_sets.items()
                        if h in live}
        # waiting envelopes for closed slots will never be fed; drop them
        self.waiting_envelopes = {
            h: kept for h, envs in self.waiting_envelopes.items()
            if (kept := [e for e in envs
                         if e.statement.slotIndex > self.lm.ledger_seq])}


def _parse_stellar_value(raw: bytes) -> Optional[StellarValue]:
    try:
        return from_bytes(StellarValue, bytes(raw))
    except Exception:
        return None
