"""OverlayManager: peer book, flooding, and the herder<->network glue
(reference ``src/overlay/OverlayManagerImpl.cpp``, ``Floodgate.cpp``,
``ItemFetcher``).

The Floodgate deduplicates by message hash and fans out to every
authenticated peer except those it already came from; records are swept
as ledgers close. Tx-set / quorum-set fetches are anycast: ask one
authenticated peer at a time (GET_TX_SET / GET_SCP_QUORUMSET), fall
through on DONT_HAVE.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.herder.tx_set import TxSetXDRFrame
from stellar_tpu_torch.xdr.overlay import (
    DontHave, MessageType, StellarMessage,
)
from stellar_tpu_torch.xdr.runtime import to_bytes

__all__ = ["Floodgate", "OverlayManager"]


class Floodgate:
    """Dedup + fanout (reference ``Floodgate.cpp:59-118``)."""

    def __init__(self):
        # msg hash -> set of peers it was seen from (ledger seq for GC)
        self.records: Dict[bytes, tuple] = {}

    def add_record(self, msg_hash: bytes, from_peer, ledger_seq: int
                   ) -> bool:
        """True if this is a NEW message (should be processed)."""
        rec = self.records.get(msg_hash)
        if rec is None:
            self.records[msg_hash] = ({id(from_peer)} if from_peer
                                      else set(), ledger_seq)
            return True
        rec[0].add(id(from_peer))
        return False

    def peers_to_skip(self, msg_hash: bytes) -> Set[int]:
        rec = self.records.get(msg_hash)
        return rec[0] if rec else set()

    def clear_below(self, ledger_seq: int):
        self.records = {h: r for h, r in self.records.items()
                        if r[1] + 10 >= ledger_seq}


class OverlayManager:
    """One node's network face. ``app`` is the owning Application-like
    container (herder, clock, peer_auth)."""

    def __init__(self, app):
        self.app = app
        self.peers: List = []  # authenticated peers
        self.pending_peers: List = []
        self.floodgate = Floodgate()
        from stellar_tpu_torch.overlay.peer_manager import BanManager, PeerManager
        from stellar_tpu_torch.overlay.tx_adverts import (
            TxAdverts, TxDemandsManager,
        )
        db = getattr(app, "database", None)
        self.peer_manager = PeerManager(db)
        self.ban_manager = BanManager(db)
        self.tx_adverts = TxAdverts()
        self.tx_demands = TxDemandsManager()
        from stellar_tpu_torch.overlay.survey_manager import SurveyManager
        self.survey_manager = SurveyManager(app)
        cfg = getattr(app, "config", None)
        # liveness budgets (reference Config PEER_TIMEOUT /
        # PEER_AUTHENTICATION_TIMEOUT / PEER_STRAGGLER_TIMEOUT,
        # enforced by the overlay tick)
        self.peer_timeout = getattr(cfg, "PEER_TIMEOUT", 30)
        self.peer_auth_timeout = getattr(
            cfg, "PEER_AUTHENTICATION_TIMEOUT", 10)
        self.peer_straggler_timeout = getattr(
            cfg, "PEER_STRAGGLER_TIMEOUT", 120)
        # flood pacing (reference FLOOD_ADVERT_PERIOD_MS /
        # FLOOD_DEMAND_PERIOD_MS / FLOOD_DEMAND_BACKOFF_DELAY_MS):
        # adverts batch until the flush timer or a half-full queue;
        # demand retries back off before asking another peer
        self.advert_period_s = getattr(
            cfg, "FLOOD_ADVERT_PERIOD_MS", 100) / 1000.0
        self.demand_period_s = getattr(
            cfg, "FLOOD_DEMAND_PERIOD_MS", 200) / 1000.0
        self.demand_backoff_s = getattr(
            cfg, "FLOOD_DEMAND_BACKOFF_DELAY_MS", 500) / 1000.0
        # per-peer advert rate limits (reference FLOOD_OP_RATE_PER_
        # LEDGER / FLOOD_TX_PERIOD_MS + soroban twins): each rate
        # window releases rate x ledger-limit x window/close_time
        # ops (classic) / txs (soroban) per peer; leftovers stay
        # queued. 0-or-negative rate disables the cap.
        self.flood_op_rate = getattr(cfg, "FLOOD_OP_RATE_PER_LEDGER",
                                     1.0)
        self.flood_tx_period_s = getattr(
            cfg, "FLOOD_TX_PERIOD_MS", 200) / 1000.0
        self.flood_soroban_rate = getattr(
            cfg, "FLOOD_SOROBAN_RATE_PER_LEDGER", 1.0)
        self.flood_soroban_period_s = getattr(
            cfg, "FLOOD_SOROBAN_TX_PERIOD_MS", 200) / 1000.0
        self._last_classic_release = 0.0
        self._last_soroban_release = 0.0
        # off-crank signature pre-verification of received tx floods
        # (reference BACKGROUND_OVERLAY_PROCESSING)
        self.background_processing = getattr(
            cfg, "BACKGROUND_OVERLAY_PROCESSING", True)
        self.tx_demands.backoff_s = self.demand_backoff_s
        self.tx_demands.retry_period_s = self.demand_period_s
        # (future, frame, peer) awaiting background sig pre-verification
        self._preverify: List = []
        self._preverify_hashes: Set[bytes] = set()
        self._wire_herder()

    def tick(self):
        """Periodic liveness sweep (reference ``Peer``'s 5s recurrent
        timer): drop pending peers that never authenticated within
        PEER_AUTHENTICATION_TIMEOUT; ping authenticated peers (a
        GET_SCP_QUORUMSET for a time-derived hash, answered DONT_HAVE —
        reference ``pingPeer``) and drop those with neither reads nor
        successful writes inside PEER_TIMEOUT."""
        from stellar_tpu_torch.crypto.sha import sha256
        now = self.app.clock.now()
        for p in list(self.pending_peers):
            if now - p.created_at > self.peer_auth_timeout:
                p.drop("authentication timeout")
        for p in list(self.peers):
            # pings below guarantee a live peer answers (DONT_HAVE)
            # every tick, so read-silence across the whole timeout
            # means ~timeout/5 unanswered pings: genuinely gone.
            # (The reference conditions on write-idle too, but its
            # writes are socket-flush timestamps; here queueing always
            # succeeds, which would make the sweep unreachable.)
            if now - p.last_read_time > self.peer_timeout:
                p.drop("idle timeout")
                continue
            # straggler: writes queue but never drain (reference
            # PEER_STRAGGLER_TIMEOUT — a reader that stopped reading)
            stalled = getattr(p, "write_stalled_for", None)
            if stalled is not None and \
                    stalled(now) > self.peer_straggler_timeout:
                p.drop("straggling (write queue never drains)")
                continue
            # ping: refreshes the remote's read-liveness view of us and
            # elicits a response that refreshes ours of it; latency is
            # measured from the matching DONT_HAVE (reference pingPeer
            # + maybeProcessPingResponse)
            sent_at = getattr(p, "_ping_sent_at", None)
            # re-arm a swallowed ping after two ticks so latency
            # sampling and the keepalive never freeze on one lost
            # response
            if sent_at is None or now - sent_at > 10:
                ping_id = sha256(b"ping" + str(now).encode())
                p._ping_id = ping_id
                p._ping_sent_at = now
                p.send(StellarMessage.make(
                    MessageType.GET_SCP_QUORUMSET, ping_id))

    def maybe_process_ping_response(self, peer, req_hash: bytes) -> bool:
        """DONT_HAVE for our outstanding ping id: record latency
        (reference ``Peer::maybeProcessPingResponse``)."""
        if getattr(peer, "_ping_id", None) != req_hash:
            return False
        from stellar_tpu_torch.utils.metrics import registry
        dt_ms = (self.app.clock.now() - peer._ping_sent_at) * 1000.0
        peer.last_ping_ms = dt_ms
        peer._ping_id = None
        peer._ping_sent_at = None
        registry.timer("overlay.connection.latency").update_ms(dt_ms)
        return True

    # ---------------- herder wiring ----------------

    def _wire_herder(self):
        h = self.app.herder
        h.broadcast_envelope = self.broadcast_scp_envelope
        h.broadcast_tx_set = self.broadcast_tx_set
        h.broadcast_transaction = self.broadcast_transaction
        h.request_tx_set = self.fetch_tx_set
        h.request_quorum_set = self.fetch_quorum_set
        h.request_scp_state = self.request_scp_state
        h.before_nomination = \
            lambda: self._drain_preverified(block=True)

    def request_scp_state(self, from_slot: int):
        """Out-of-sync recovery: ask every authenticated peer for its
        SCP state from ``from_slot`` (reference sendGetScpState)."""
        for p in list(self.peers):
            p.send(StellarMessage.make(
                MessageType.GET_SCP_STATE, from_slot))

    # ---------------- peer lifecycle ----------------

    def add_pending(self, peer):
        self.pending_peers.append(peer)

    def peer_authenticated(self, peer):
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        if peer not in self.peers:
            # the authenticated-inbound cap must hold at the
            # pending->authenticated transition (a burst can pass the
            # accept-time check together, reference
            # OverlayManagerImpl.cpp:318): reject over-cap inbound here
            if not getattr(peer, "we_called", True):
                cfg = getattr(self.app, "config", None)
                max_add = getattr(cfg,
                                  "MAX_ADDITIONAL_PEER_CONNECTIONS", -1)
                if max_add < 0:
                    max_add = getattr(cfg, "TARGET_PEER_CONNECTIONS",
                                      8) * 8
                in_auth = sum(1 for p in self.peers
                              if not getattr(p, "we_called", True))
                if in_auth >= max_add:
                    peer.drop("too many inbound peers")
                    return
            self.peers.append(peer)
            # node-key preference (reference PREFERRED_PEER_KEYS):
            # a peer whose identity key is preferred gets its address
            # pinned as PREFERRED whatever IP it dialed in from
            cfg = getattr(self.app, "config", None)
            keys = getattr(cfg, "PREFERRED_PEER_KEYS", None)
            if keys and getattr(peer, "remote_node_id", None) and \
                    getattr(peer, "address", None):
                from stellar_tpu_torch.crypto import strkey
                if strkey.encode_account(peer.remote_node_id) in keys:
                    from stellar_tpu_torch.overlay.peer_manager import PeerType
                    rec = self.peer_manager.ensure_exists(*peer.address)
                    rec.peer_type = PeerType.PREFERRED
            if self.survey_manager.collecting_nonce is not None:
                self.survey_manager.added_peers += 1
            # pull the peer's SCP state for the current slot so a node
            # joining mid-ledger catches up immediately (reference
            # Peer::recvAuth -> sendGetScpState)
            peer.send(StellarMessage.make(
                MessageType.GET_SCP_STATE,
                self.app.herder.lm.ledger_seq + 1))

    def peer_dropped(self, peer, reason: str):
        if peer in self.peers:
            self.peers.remove(peer)
            if self.survey_manager.collecting_nonce is not None:
                self.survey_manager.dropped_peers += 1
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        self.tx_adverts.forget_peer(peer)

    def authenticated_count(self) -> int:
        return len(self.peers)

    def _peers_by_id(self) -> Dict[int, object]:
        return {id(p): p for p in self.peers}

    # ---------------- broadcast (herder -> network) ----------------

    def _flood(self, msg, from_peer=None, msg_bytes: bytes = None):
        # serialize ONCE for hashing AND every peer's framing
        if msg_bytes is None:
            msg_bytes = to_bytes(StellarMessage, msg)
        raw_hash = sha256(msg_bytes)
        self.floodgate.add_record(raw_hash, from_peer,
                                  self.app.herder.lm.ledger_seq)
        skip = self.floodgate.peers_to_skip(raw_hash)
        for p in list(self.peers):
            if id(p) not in skip:
                p.send(msg, msg_bytes)

    def broadcast_scp_envelope(self, envelope):
        self._flood(StellarMessage.make(MessageType.SCP_MESSAGE, envelope))

    def broadcast_tx_set(self, txset_frame):
        self._flood(StellarMessage.make(MessageType.GENERALIZED_TX_SET,
                                        txset_frame.xdr))

    def broadcast_transaction(self, frame, from_peer=None):
        """Pull-mode tx relay (reference TxAdverts): flood the HASH;
        peers demand the body if they don't have it. Adverts batch up
        to the flush timer (FLOOD_ADVERT_PERIOD_MS) unless a queue is
        already half-full (reference flushAdvertTimer)."""
        from stellar_tpu_torch.overlay.tx_adverts import ADVERT_FLUSH_SIZE
        from stellar_tpu_torch.utils.metrics import registry
        if not self._arb_flood_admit(frame):
            registry.meter("overlay.flood.arb-damped").mark()
            return
        registry.meter("overlay.flood.advertised").mark()
        tx_hash = frame.contents_hash()
        skip = {id(from_peer)} if from_peer is not None else set()
        full = False
        for p in list(self.peers):
            if id(p) in skip:
                continue
            q = self.tx_adverts.queue_advert(p, tx_hash)
            if q >= ADVERT_FLUSH_SIZE:
                full = True
        if full or self.advert_period_s <= 0:
            self.tx_adverts.flush(self._peers_by_id())

    def _arb_flood_admit(self, frame) -> bool:
        """Arbitrage-flood damping (reference FLOOD_ARB_TX_BASE_
        ALLOWANCE / FLOOD_ARB_TX_DAMPING_FACTOR): per source and
        ledger, the first ``allowance`` DEX-crossing txs (path
        payments / offers) flood normally; each one beyond floods with
        probability damping^(n - allowance), decided deterministically
        from the tx hash so every node damps the same txs."""
        cfg = self.app.config
        allowance = getattr(cfg, "FLOOD_ARB_TX_BASE_ALLOWANCE", 0)
        if allowance <= 0:
            return True
        from stellar_tpu_torch.xdr.tx import OperationType as OT
        dex_ops = (OT.PATH_PAYMENT_STRICT_RECEIVE,
                   OT.PATH_PAYMENT_STRICT_SEND, OT.MANAGE_SELL_OFFER,
                   OT.MANAGE_BUY_OFFER,
                   OT.CREATE_PASSIVE_SELL_OFFER)
        inner = getattr(frame, "inner", frame)
        if not any(op.body.arm in dex_ops
                   for op in inner.tx.operations):
            return True
        src = inner.source_account_id().value
        counts = getattr(self, "_arb_counts", None)
        if counts is None:
            counts = self._arb_counts = {}
        n = counts.get(src, 0)
        counts[src] = n + 1
        if n < allowance:
            return True
        damping = getattr(cfg, "FLOOD_ARB_TX_DAMPING_FACTOR", 1.0)
        p = damping ** (n + 1 - allowance)
        # deterministic coin: the tx hash's first 8 bytes as a
        # fraction of 2^64
        h = int.from_bytes(frame.contents_hash()[:8], "big")
        return (h / (1 << 64)) < p

    def flush_adverts_tick(self):
        """Recurring advert flush (reference FLOOD_ADVERT_PERIOD_MS
        timer; scheduled by the Application), rate-limited per peer by
        the FLOOD_*_RATE/PERIOD knobs."""
        self._drain_preverified(block=False)
        self.tx_adverts.flush(self._peers_by_id(), force=True,
                              quotas=self._advert_quotas(),
                              lane_of=self._advert_lane)

    def _advert_lane(self, tx_hash: bytes) -> str:
        h = self.app.herder
        if tx_hash in h.soroban_tx_queue.known_hashes:
            return "soroban"
        return "classic"

    def _advert_quotas(self):
        """Per-peer {lane: quota} released this tick, or None (no rate
        caps). A window that elapsed releases one window's worth."""
        if self.flood_op_rate <= 0 and self.flood_soroban_rate <= 0:
            return None
        now = self.app.clock.now()
        cfg = getattr(self.app, "config", None)
        close_s = max(1, getattr(cfg, "EXPECTED_LEDGER_CLOSE_TIME", 5))
        quotas = {"classic": 0, "soroban": 0}
        if self.flood_op_rate > 0:
            if now - self._last_classic_release >= \
                    self.flood_tx_period_s:
                self._last_classic_release = now
                per_ledger = self.flood_op_rate * \
                    self.app.herder.lm.last_closed_header.maxTxSetSize
                quotas["classic"] = max(1, int(
                    per_ledger * self.flood_tx_period_s / close_s))
        else:
            quotas["classic"] = 1 << 30
        if self.flood_soroban_rate > 0:
            if now - self._last_soroban_release >= \
                    self.flood_soroban_period_s:
                self._last_soroban_release = now
                scfg = getattr(self.app.herder.lm, "soroban_config",
                               None)
                cap = getattr(scfg, "ledger_max_tx_count", 100) or 100
                quotas["soroban"] = max(1, int(
                    self.flood_soroban_rate * cap *
                    self.flood_soroban_period_s / close_s))
        else:
            quotas["soroban"] = 1 << 30
        return quotas

    def _admit_transaction(self, frame, peer):
        from stellar_tpu_torch.herder.transaction_queue import AddResult
        res = self.app.herder.queue_for(frame).try_add(frame)
        if res.code == AddResult.ADD_STATUS_PENDING:
            # propagate by advert, not by pushing the body
            self.broadcast_transaction(frame, from_peer=peer)

    def _drain_preverified(self, block: bool):
        """Admit txs whose background signature pre-verification
        finished; at ledger close ``block`` waits the stragglers out so
        close boundaries stay deterministic."""
        rest = []
        for fut, frame, peer in self._preverify:
            if block or fut.done():
                try:
                    fut.result()
                except Exception:
                    pass  # admission re-verifies through the cache
                self._preverify_hashes.discard(frame.contents_hash())
                self._admit_transaction(frame, peer)
            else:
                rest.append((fut, frame, peer))
        self._preverify = rest

    # ---------------- fetch (anycast) ----------------

    def fetch_tx_set(self, tx_set_hash: bytes):
        # ask every peer (the reference's ItemFetcher walks peers one at
        # a time on DONT_HAVE; asking all is the degenerate-but-correct
        # form at simulation scale)
        for p in list(self.peers):
            p.send(StellarMessage.make(MessageType.GET_TX_SET,
                                       tx_set_hash))

    def fetch_quorum_set(self, qset_hash: bytes):
        for p in list(self.peers):
            p.send(StellarMessage.make(MessageType.GET_SCP_QUORUMSET,
                                       qset_hash))

    # ---------------- inbound dispatch (peer -> node) ----------------

    def recv_message(self, peer, msg, msg_bytes: bytes = None):
        if msg_bytes is None:
            msg_bytes = to_bytes(StellarMessage, msg)
        t = msg.arm
        herder = self.app.herder
        if t == MessageType.TRANSACTION:
            raw_hash = sha256(msg_bytes)
            if self.floodgate.add_record(raw_hash, peer,
                                         herder.lm.ledger_seq):
                from stellar_tpu_torch.tx.transaction_frame import (
                    make_transaction_frame,
                )
                try:
                    frame = make_transaction_frame(herder.network_id,
                                                   msg.value)
                except Exception:
                    return
                self.tx_demands.fulfilled(frame.contents_hash())
                if self.background_processing:
                    # pre-verify master-key signatures on the worker
                    # pool; admission happens once the verdicts are in
                    # the cache (reference Peer.cpp:963-969 off-main
                    # sig verification)
                    items = _master_sig_items(frame)
                    if items:
                        from stellar_tpu_torch.utils.workers import run_async
                        self._preverify.append(
                            (run_async(_preverify_into_cache, items),
                             frame, peer))
                        self._preverify_hashes.add(
                            frame.contents_hash())
                        return
                self._admit_transaction(frame, peer)
        elif t == MessageType.FLOOD_ADVERT:
            hashes = list(msg.value.txHashes)
            self.tx_adverts.note_incoming(peer, hashes)
            demand = []
            for h in hashes:
                if h in self._preverify_hashes or \
                        herder.is_tx_known_or_banned(h):
                    continue  # body already held / pending admission
                if self.tx_demands.start_demand(
                        h, peer, now=self.app.clock.now()):
                    demand.append(h)
            if demand:
                from stellar_tpu_torch.xdr.overlay import FloodDemand
                peer.send(StellarMessage.make(
                    MessageType.FLOOD_DEMAND,
                    FloodDemand(txHashes=demand)))
        elif t == MessageType.FLOOD_DEMAND:
            from stellar_tpu_torch.utils.metrics import registry
            registry.meter("overlay.flood.demanded").mark(
                len(msg.value.txHashes))
            for h in msg.value.txHashes:
                frame = herder.get_pending_tx(h)
                if frame is not None:
                    peer.send(StellarMessage.make(
                        MessageType.TRANSACTION, frame.envelope))
        elif t == MessageType.PEERS:
            allow_local = getattr(getattr(self.app, "config", None),
                                  "ALLOW_LOCALHOST_FOR_TESTING", True)
            for addr in msg.value:
                try:
                    import ipaddress
                    ip = ipaddress.ip_address(bytes(addr.ip.value))
                    host = str(ip)
                    # gossiped loopback addresses are poison on a real
                    # network (reference ALLOW_LOCALHOST_FOR_TESTING);
                    # operator-configured peers are exempt
                    if not allow_local and ip.is_loopback:
                        continue
                    self.peer_manager.ensure_exists(host, addr.port)
                except Exception:
                    continue
        elif t == MessageType.SCP_MESSAGE:
            raw_hash = sha256(msg_bytes)
            if self.floodgate.add_record(raw_hash, peer,
                                         herder.lm.ledger_seq):
                from stellar_tpu_torch.scp import EnvelopeState
                if herder.recv_scp_envelope(msg.value) == \
                        EnvelopeState.VALID:
                    self._flood(msg, from_peer=peer,
                                msg_bytes=msg_bytes)
        elif t == MessageType.GENERALIZED_TX_SET:
            herder.recv_tx_set(TxSetXDRFrame(msg.value))
        elif t == MessageType.GET_TX_SET:
            ts = herder.get_tx_set(msg.value)
            if ts is not None:
                peer.send(StellarMessage.make(
                    MessageType.GENERALIZED_TX_SET, ts.xdr))
            else:
                peer.send(StellarMessage.make(
                    MessageType.DONT_HAVE,
                    DontHave(type=MessageType.GENERALIZED_TX_SET,
                             reqHash=msg.value)))
        elif t == MessageType.GET_SCP_QUORUMSET:
            qs = herder.qsets.get(msg.value)
            if qs is not None:
                peer.send(StellarMessage.make(
                    MessageType.SCP_QUORUMSET, qs))
            else:
                peer.send(StellarMessage.make(
                    MessageType.DONT_HAVE,
                    DontHave(type=MessageType.SCP_QUORUMSET,
                             reqHash=msg.value)))
        elif t == MessageType.ERROR_MSG:
            # the remote announced why it is dropping us (reference
            # Peer::recvError): log it and close our side
            import logging
            logging.getLogger("stellar_tpu.overlay").info(
                "peer %s sent error: %s",
                (peer.remote_node_id or b"").hex()[:16],
                bytes(msg.value.msg).decode("utf-8", "replace"))
            from stellar_tpu_torch.utils.metrics import registry
            registry.counter("overlay.recv.error-msg").inc()
            peer.remote_drop_reason = bytes(msg.value.msg)
            # close silently (reference recvError): never echo an
            # ERROR_MSG back at a peer that is already tearing down
            peer.drop("remote error", announce=False)
        elif t == MessageType.DONT_HAVE:
            self.maybe_process_ping_response(peer, msg.value.reqHash)
        elif t == MessageType.SCP_QUORUMSET:
            herder.register_qset(msg.value)
        elif t == MessageType.GET_SCP_STATE:
            for idx, slot in herder.scp.known_slots.items():
                for env in slot.get_current_state():
                    peer.send(StellarMessage.make(
                        MessageType.SCP_MESSAGE, env))
        elif t in (MessageType.TIME_SLICED_SURVEY_START_COLLECTING,
                   MessageType.TIME_SLICED_SURVEY_STOP_COLLECTING,
                   MessageType.TIME_SLICED_SURVEY_REQUEST,
                   MessageType.TIME_SLICED_SURVEY_RESPONSE):
            if self.survey_manager.handle_message(msg, peer):
                self._flood(msg, from_peer=peer)

    def ledger_closed(self, ledger_seq: int):
        # arb damping counts are per-ledger
        self._arb_counts = {}
        self._drain_preverified(block=True)
        self.floodgate.clear_below(ledger_seq)
        peers = self._peers_by_id()
        self.tx_adverts.flush(peers, force=True)
        self.tx_demands.age_and_retry(self.tx_adverts, peers,
                                      now=self.app.clock.now())
        self.survey_manager.ledger_closed()

    # ---------------- operator surface ----------------

    def ban_peer(self, node_id: bytes):
        """Ban + drop any live connection from that node (reference
        CommandHandler 'ban' + BanManager)."""
        self.ban_manager.ban(node_id)
        for p in list(self.peers) + list(self.pending_peers):
            if getattr(p, "remote_node_id", None) == node_id:
                p.drop("banned")


def _preverify_into_cache(items) -> None:
    """Worker-side tx-flood signature pre-verification: when the resident
    verify service is running, the flood rides the ``bulk`` lane —
    admission-controlled and sheddable, so a tx storm backs off at
    INGRESS instead of soaking the dispatch path ahead of consensus
    work; verdicts re-seed the ``verify_sig`` cache exactly as the
    direct path would (cache-first, bit-identical — the herder SCP
    adoption pattern). A shed/rejected/failed service round trip falls
    back to the direct batch path: pre-verification is an optimization,
    admission re-verifies through the cache either way."""
    from stellar_tpu_torch.crypto.keys import (
        batch_verify_into_cache, cached_verify_sig,
    )
    from stellar_tpu_torch.crypto.verify_service import service_verified
    todo = [it for it in items
            if cached_verify_sig(*it) is None]
    if not todo:
        return
    # bounded service wait (helper default): ledger close blocks on
    # these futures via _drain_preverified, so a wedged dispatcher
    # must degrade to the watchdog-bounded direct path, never stall
    # the close on an unresolved ticket
    if service_verified(todo, lane="bulk") is None:
        batch_verify_into_cache(todo)


def _master_sig_items(frame) -> List[tuple]:
    """(pk, payload_hash, sig) triples for the envelope signatures that
    hint-match the source (and fee-source) master keys — the cheap,
    ltx-free subset worth pre-verifying off-crank; other signers verify
    through the cache at admission as usual. Fee bumps pair the OUTER
    signatures with the fee source over the outer payload hash and the
    INNER signatures with the inner source over the inner hash —
    anything else would warm cache keys admission never queries."""
    items = []
    try:
        def add(pk_raw: bytes, h: bytes, sigs):
            for ds in sigs or ():
                if bytes(ds.hint) == pk_raw[-4:]:
                    items.append((pk_raw, h, bytes(ds.signature)))
        if hasattr(frame, "fee_source_id"):
            add(frame.fee_source_id().value, frame.contents_hash(),
                frame.envelope.value.signatures)
            inner = frame.inner
            add(inner.source_account_id().value,
                inner.contents_hash(),
                inner.envelope.value.signatures)
        else:
            add(frame.source_account_id().value, frame.contents_hash(),
                frame.envelope.value.signatures)
    except Exception:
        return []
    return items
