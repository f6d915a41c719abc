"""Time-sliced topology surveys (reference ``src/overlay/SurveyManager
.h:20-38`` + ``SurveyDataManager``).

A surveyor signs and floods START_COLLECTING (nonce + ledger); every
node begins a collecting phase, tracking per-peer traffic deltas. After
STOP_COLLECTING the surveyor sends signed, relayed REQUESTs to chosen
nodes; each surveyed node answers with its peer list + node stats,
encrypted to the surveyor's ephemeral curve25519 key so relaying peers
learn nothing. Responses flood back and the surveyor accumulates them
in ``results``.

Encryption (r4, resolving the r3 wire-format fork): the encrypted
response body now uses the genuine libsodium ``crypto_box_seal``
construction — X25519 + HSalsa20 key derivation + XSalsa20-Poly1305
secretbox with the BLAKE2b-192(eph_pub || recipient_pub) nonce
(``crypto/nacl_box.py``) — byte-compatible with the reference's
``curve25519Decrypt`` path (``src/crypto/Curve25519.cpp``), so mixed
fleets can survey across implementations.
"""

from __future__ import annotations

from typing import Dict, Optional

from stellar_tpu_torch.crypto import curve25519 as c25519
from stellar_tpu_torch.crypto.keys import verify_sig
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.xdr.overlay import (
    MessageType, SignedTimeSlicedSurveyRequestMessage,
    SignedTimeSlicedSurveyResponseMessage,
    SignedTimeSlicedSurveyStartCollectingMessage,
    SignedTimeSlicedSurveyStopCollectingMessage, StellarMessage,
    SurveyMessageCommandType, SurveyRequestMessage, SurveyResponseBody,
    SurveyResponseMessage, TimeSlicedNodeData, TimeSlicedPeerData,
    TimeSlicedSurveyRequestMessage, TimeSlicedSurveyResponseMessage,
    TimeSlicedSurveyStartCollectingMessage,
    TimeSlicedSurveyStopCollectingMessage, TopologyResponseBodyV2,
)
from stellar_tpu_torch.xdr.runtime import Packer, from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import Curve25519Public

__all__ = ["SurveyManager", "seal_box", "open_box"]

SURVEY_THROTTLE_PER_LEDGER = 10  # reference request rate cap


# ---------------------------------------------------------------------------
# Sealed boxes
# ---------------------------------------------------------------------------

def seal_box(recipient_pub: bytes, plaintext: bytes) -> bytes:
    """libsodium ``crypto_box_seal``: eph_pub || XSalsa20-Poly1305
    box keyed by HSalsa20(X25519(eph, recipient)) with the
    BLAKE2b-192(eph_pub || recipient_pub) nonce."""
    from stellar_tpu_torch.crypto.nacl_box import seal
    return seal(plaintext, recipient_pub)


def open_box(recipient_secret: bytes, sealed: bytes) -> Optional[bytes]:
    from stellar_tpu_torch.crypto.nacl_box import seal_open
    recipient_pub = c25519.public_from_secret(recipient_secret)
    try:
        return seal_open(sealed, recipient_secret, recipient_pub)
    except Exception:
        # bad point / short box / bad tag — all just "not for us"
        return None


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

def _signed_payload(tag: bytes, struct_type, value) -> bytes:
    p = Packer()
    p.pack_fopaque(32, tag)
    struct_type.pack(p, value)
    return sha256(p.bytes())


class _PeerTraffic:
    __slots__ = ("messages_read", "messages_written", "bytes_read",
                 "bytes_written")

    def __init__(self):
        self.messages_read = 0
        self.messages_written = 0
        self.bytes_read = 0
        self.bytes_written = 0


class SurveyManager:
    """One node's survey state machine: surveyor and surveyed roles."""

    def __init__(self, app):
        self.app = app
        # collecting phase
        self.collecting_nonce: Optional[int] = None
        self.collecting_surveyor: Optional[bytes] = None
        self.traffic: Dict[bytes, _PeerTraffic] = {}
        self.added_peers = 0
        self.dropped_peers = 0
        # surveyor state
        self.survey_secret: Optional[bytes] = None
        self.survey_nonce: Optional[int] = None
        self.results: Dict[str, dict] = {}
        self._seen: set = set()
        self._requests_this_ledger = 0

    # ---------------- traffic accounting (called by peers) ----------------

    def note_traffic(self, peer, read: int = 0, written: int = 0):
        if self.collecting_nonce is None or peer.remote_node_id is None:
            return
        t = self.traffic.setdefault(peer.remote_node_id, _PeerTraffic())
        if read:
            t.messages_read += 1
            t.bytes_read += read
        if written:
            t.messages_written += 1
            t.bytes_written += written

    # ---------------- surveyor API ----------------

    def _sign(self, payload: bytes) -> bytes:
        return self.app.config.NODE_SEED.sign(payload)

    def start_collecting(self) -> dict:
        """Begin a survey as surveyor: flood START_COLLECTING."""
        import random
        self.survey_nonce = random.randrange(2**32)
        self.survey_secret = c25519.random_secret()
        self.results = {}
        msg = TimeSlicedSurveyStartCollectingMessage(
            surveyorID=self.app.herder.scp.local_node_xdr,
            nonce=self.survey_nonce,
            ledgerNum=self.app.lm.ledger_seq)
        sig = self._sign(_signed_payload(
            self.app.herder.network_id,
            TimeSlicedSurveyStartCollectingMessage, msg))
        signed = SignedTimeSlicedSurveyStartCollectingMessage(
            signature=sig, startCollecting=msg)
        sm = StellarMessage.make(
            MessageType.TIME_SLICED_SURVEY_START_COLLECTING, signed)
        self._handle_start(signed)  # surveyor collects too
        self.app.overlay._flood(sm)
        return {"nonce": self.survey_nonce}

    def stop_collecting(self) -> dict:
        msg = TimeSlicedSurveyStopCollectingMessage(
            surveyorID=self.app.herder.scp.local_node_xdr,
            nonce=self.survey_nonce or 0,
            ledgerNum=self.app.lm.ledger_seq)
        sig = self._sign(_signed_payload(
            self.app.herder.network_id,
            TimeSlicedSurveyStopCollectingMessage, msg))
        signed = SignedTimeSlicedSurveyStopCollectingMessage(
            signature=sig, stopCollecting=msg)
        sm = StellarMessage.make(
            MessageType.TIME_SLICED_SURVEY_STOP_COLLECTING, signed)
        self._handle_stop(signed)
        self.app.overlay._flood(sm)
        return {"nonce": self.survey_nonce}

    def request_node(self, node_id: bytes) -> dict:
        """Ask one node for its time slice (relayed + encrypted)."""
        from stellar_tpu_torch.scp.quorum import make_node_id
        if self.survey_secret is None:
            return {"error": "no survey running"}
        if self._requests_this_ledger >= SURVEY_THROTTLE_PER_LEDGER:
            return {"error": "throttled"}
        self._requests_this_ledger += 1
        req = SurveyRequestMessage(
            surveyorPeerID=self.app.herder.scp.local_node_xdr,
            surveyedPeerID=make_node_id(node_id),
            ledgerNum=self.app.lm.ledger_seq,
            encryptionKey=Curve25519Public(
                key=c25519.public_from_secret(self.survey_secret)),
            commandType=SurveyMessageCommandType
            .TIME_SLICED_SURVEY_TOPOLOGY)
        ts = TimeSlicedSurveyRequestMessage(
            request=req, nonce=self.survey_nonce or 0,
            inboundPeersIndex=0, outboundPeersIndex=0)
        sig = self._sign(_signed_payload(
            self.app.herder.network_id,
            TimeSlicedSurveyRequestMessage, ts))
        signed = SignedTimeSlicedSurveyRequestMessage(
            requestSignature=sig, request=ts)
        sm = StellarMessage.make(
            MessageType.TIME_SLICED_SURVEY_REQUEST, signed)
        self.relay_or_handle_request(signed, from_peer=None)
        self.app.overlay._flood(sm)
        return {"requested": node_id.hex()}

    def ledger_closed(self):
        self._requests_this_ledger = 0
        # expire a collecting phase that overran its duration
        deadline = getattr(self, "_collecting_deadline", None)
        if deadline is not None and self.collecting_nonce is not None \
                and self.app.clock.now() > deadline:
            self.collecting_nonce = None
            self.collecting_surveyor = None
            self._collecting_deadline = None

    # ---------------- message handling (both roles) ----------------

    def _verify(self, node_xdr, payload: bytes, sig: bytes) -> bool:
        return verify_sig(node_xdr.value, payload, sig)

    def handle_message(self, msg, from_peer) -> bool:
        """True if the message was fresh (should be re-flooded)."""
        raw = sha256(to_bytes(StellarMessage, msg))
        if raw in self._seen:
            return False
        self._seen.add(raw)
        t = msg.arm
        if t == MessageType.TIME_SLICED_SURVEY_START_COLLECTING:
            return self._handle_start(msg.value)
        if t == MessageType.TIME_SLICED_SURVEY_STOP_COLLECTING:
            return self._handle_stop(msg.value)
        if t == MessageType.TIME_SLICED_SURVEY_REQUEST:
            return self.relay_or_handle_request(msg.value, from_peer)
        if t == MessageType.TIME_SLICED_SURVEY_RESPONSE:
            return self._handle_response(msg.value)
        return False

    def _surveyor_allowed(self, surveyor_raw: bytes) -> bool:
        """SURVEYOR_KEYS allowlist (reference Config.h): empty list =
        anyone may survey (test networks); otherwise only the listed
        strkeys."""
        cfg = getattr(self.app, "config", None)
        allowed = getattr(cfg, "SURVEYOR_KEYS", None)
        if not allowed:
            return True
        from stellar_tpu_torch.crypto import strkey
        return strkey.encode_account(surveyor_raw) in allowed

    def _handle_start(self, signed) -> bool:
        msg = signed.startCollecting
        if not self._verify(msg.surveyorID, _signed_payload(
                self.app.herder.network_id,
                TimeSlicedSurveyStartCollectingMessage, msg),
                signed.signature):
            return False
        if not self._surveyor_allowed(msg.surveyorID.value):
            return False
        if self.collecting_nonce is not None and \
                self.collecting_surveyor != msg.surveyorID.value:
            return False  # one survey at a time (reference rule)
        self.collecting_nonce = msg.nonce
        self.collecting_surveyor = msg.surveyorID.value
        self.traffic = {}
        self.added_peers = 0
        self.dropped_peers = 0
        # phase auto-expiry (reference survey phase duration, overridable
        # via ARTIFICIALLY_SET_SURVEY_PHASE_DURATION_FOR_TESTING)
        dur = getattr(getattr(self.app, "config", None),
                      "ARTIFICIALLY_SET_SURVEY_PHASE_DURATION_FOR_TESTING",
                      0) or 3600
        self._collecting_deadline = self.app.clock.now() + dur
        return True

    def _handle_stop(self, signed) -> bool:
        msg = signed.stopCollecting
        if not self._verify(msg.surveyorID, _signed_payload(
                self.app.herder.network_id,
                TimeSlicedSurveyStopCollectingMessage, msg),
                signed.signature):
            return False
        if msg.nonce != self.collecting_nonce:
            return False
        self.collecting_nonce = None
        return True

    def relay_or_handle_request(self, signed, from_peer) -> bool:
        ts = signed.request
        req = ts.request
        if not self._verify(req.surveyorPeerID, _signed_payload(
                self.app.herder.network_id,
                TimeSlicedSurveyRequestMessage, ts),
                signed.requestSignature):
            return False
        # the allowlist must gate the DATA-disclosing path, not just
        # startCollecting — a direct request from an unlisted surveyor
        # gets no topology (code-review r3 finding)
        if not self._surveyor_allowed(req.surveyorPeerID.value):
            return False
        if req.surveyedPeerID.value != \
                self.app.herder.scp.local_node_id:
            return True  # not for us: keep relaying
        body = self._build_topology_body()
        sealed = seal_box(req.encryptionKey.key,
                          to_bytes(SurveyResponseBody, body))
        resp = SurveyResponseMessage(
            surveyorPeerID=req.surveyorPeerID,
            surveyedPeerID=req.surveyedPeerID,
            ledgerNum=self.app.lm.ledger_seq,
            commandType=req.commandType,
            encryptedBody=sealed)
        tsr = TimeSlicedSurveyResponseMessage(response=resp,
                                              nonce=ts.nonce)
        sig = self._sign(_signed_payload(
            self.app.herder.network_id,
            TimeSlicedSurveyResponseMessage, tsr))
        out = SignedTimeSlicedSurveyResponseMessage(
            responseSignature=sig, response=tsr)
        self.app.overlay._flood(StellarMessage.make(
            MessageType.TIME_SLICED_SURVEY_RESPONSE, out))
        return True

    def _handle_response(self, signed) -> bool:
        tsr = signed.response
        resp = tsr.response
        if not self._verify(resp.surveyedPeerID, _signed_payload(
                self.app.herder.network_id,
                TimeSlicedSurveyResponseMessage, tsr),
                signed.responseSignature):
            return False
        if resp.surveyorPeerID.value != \
                self.app.herder.scp.local_node_id:
            return True  # someone else's survey: relay
        if self.survey_secret is None:
            return False
        raw = open_box(self.survey_secret, resp.encryptedBody)
        if raw is None:
            return False
        try:
            body = from_bytes(SurveyResponseBody, raw)
        except Exception:
            return False
        self.results[resp.surveyedPeerID.value.hex()] = \
            self._body_to_json(body.value)
        return False  # terminal: the surveyor doesn't re-flood

    # ---------------- response building ----------------

    def _peer_rows(self, peers):
        rows = []
        for p in peers[:25]:
            if p.remote_node_id is None:
                continue
            from stellar_tpu_torch.scp.quorum import make_node_id
            t = self.traffic.get(p.remote_node_id, _PeerTraffic())
            rows.append(TimeSlicedPeerData(
                peerId=make_node_id(p.remote_node_id),
                messagesRead=t.messages_read,
                messagesWritten=t.messages_written,
                bytesRead=t.bytes_read,
                bytesWritten=t.bytes_written))
        return rows

    def _build_topology_body(self):
        ov = self.app.overlay
        inbound = [p for p in ov.peers if not p.we_called]
        outbound = [p for p in ov.peers if p.we_called]
        cfg = self.app.config
        node = TimeSlicedNodeData(
            addedAuthenticatedPeers=self.added_peers,
            droppedAuthenticatedPeers=self.dropped_peers,
            totalInboundPeerCount=len(inbound),
            totalOutboundPeerCount=len(outbound),
            p75SCPFirstToSelfLatencyMs=0,
            p75SCPSelfToOtherLatencyMs=0,
            lostSyncCount=0,
            isValidator=bool(cfg.NODE_IS_VALIDATOR),
            maxInboundPeerCount=cfg.MAX_PEER_CONNECTIONS,
            maxOutboundPeerCount=cfg.TARGET_PEER_CONNECTIONS)
        return SurveyResponseBody.make(2, TopologyResponseBodyV2(
            inboundPeers=self._peer_rows(inbound),
            outboundPeers=self._peer_rows(outbound),
            nodeData=node))

    @staticmethod
    def _body_to_json(body) -> dict:
        def rows(lst):
            return [{"peer": r.peerId.value.hex(),
                     "messagesRead": r.messagesRead,
                     "messagesWritten": r.messagesWritten,
                     "bytesRead": r.bytesRead,
                     "bytesWritten": r.bytesWritten} for r in lst]
        n = body.nodeData
        return {
            "inboundPeers": rows(body.inboundPeers),
            "outboundPeers": rows(body.outboundPeers),
            "node": {
                "totalInbound": n.totalInboundPeerCount,
                "totalOutbound": n.totalOutboundPeerCount,
                "isValidator": bool(n.isValidator),
                "maxInbound": n.maxInboundPeerCount,
                "maxOutbound": n.maxOutboundPeerCount,
            },
        }
