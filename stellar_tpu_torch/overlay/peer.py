"""Peer: one authenticated overlay connection (reference
``src/overlay/Peer.cpp``, ``PeerAuth.cpp``, ``Hmac.h``,
``FlowControl.h``).

Channel security exactly as the reference: each node signs an ephemeral
X25519 key with its ed25519 identity (AuthCert, bound to the network id
and an expiration), HELLOs exchange certs+nonces, HKDF over the ECDH
shared secret + nonces derives one HMAC-SHA256 key per direction, and
every subsequent message is MAC'd over (sequence ‖ message) with a
strictly-increasing sequence — replay- and tamper-proof per connection.

Flow control is the reference's credit scheme: a peer may only send
while it holds message credits; the receiver returns SEND_MORE(_EXTENDED)
credits as it drains its queue.
"""

from __future__ import annotations

from typing import Callable, Optional

from stellar_tpu_torch.crypto import curve25519 as c25519
from stellar_tpu_torch.crypto.keys import SecretKey, verify_sig
from stellar_tpu_torch.xdr.overlay import (
    Auth, AuthCert, AuthenticatedMessage, AuthenticatedMessageV0, ErrorMsg,
    ErrorCode, Hello, MessageType, SendMoreExtended, StellarMessage,
)
from stellar_tpu_torch.xdr.runtime import Packer, from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import Curve25519Public, EnvelopeType

__all__ = ["PeerAuth", "FlowControl", "Peer", "PEER_STATE"]

from stellar_tpu_torch.utils.cache import RandomEvictionCache

# inner-message-bytes -> parsed StellarMessage (private copies both
# ways); shared process-wide because messages are content-addressed
_MSG_PARSE_CACHE: RandomEvictionCache = RandomEvictionCache(512)

AUTH_CERT_LIFETIME = 3600  # seconds (reference PeerAuth.cpp expiration)
OVERLAY_VERSION = 38

# reference FlowControl defaults
PEER_FLOOD_READING_CAPACITY = 200
FLOW_CONTROL_SEND_MORE_BATCH = 40
PEER_FLOOD_READING_CAPACITY_BYTES = 300_000
FLOW_CONTROL_SEND_MORE_BATCH_BYTES = 100_000


class PeerAuth:
    """Per-node auth material (reference ``PeerAuth``)."""

    def __init__(self, node_key: SecretKey, network_id: bytes, now: int):
        self.node_key = node_key
        self.network_id = network_id
        self.ecdh_secret = c25519.random_secret()
        self.ecdh_public = c25519.public_from_secret(self.ecdh_secret)
        self.cert = self._make_cert(now)

    def _cert_payload(self, expiration: int, pubkey: bytes) -> bytes:
        # (networkID | ENVELOPE_TYPE_AUTH | expiration | pubkey)
        # (reference PeerAuth::getAuthCert)
        p = Packer()
        p.pack_fopaque(32, self.network_id)
        p.pack_int(EnvelopeType.ENVELOPE_TYPE_AUTH)
        p.pack_uhyper(expiration)
        p.pack_fopaque(32, pubkey)
        return p.bytes()

    def _make_cert(self, now: int) -> AuthCert:
        expiration = now + AUTH_CERT_LIFETIME
        sig = self.node_key.sign(
            self._cert_payload(expiration, self.ecdh_public))
        return AuthCert(pubkey=Curve25519Public(key=self.ecdh_public),
                        expiration=expiration, sig=sig)

    def verify_remote_cert(self, cert: AuthCert, remote_node_id: bytes,
                           now: int) -> bool:
        """Sig hot path #3 (reference ``PeerAuth::verifyRemoteAuthCert``).

        When the resident verify service is running
        (``VERIFY_SERVICE_ENABLED``), the cert signature rides the
        ``auth`` priority lane — scheduled ahead of tx-flood backlog,
        so a flood cannot starve peer handshakes (the reference's
        Herder/overlay split). Mirrors the herder's cache-first SCP
        adoption: a cached verdict wins without a service
        round trip, the service verdict re-seeds the cache, and
        ingress rejection or any service failure falls back to the
        direct path — bit-identical decisions on every route."""
        if cert.expiration < now:
            return False
        payload = self._cert_payload(cert.expiration, cert.pubkey.key)
        from stellar_tpu_torch.crypto.keys import cached_verify_sig
        from stellar_tpu_torch.crypto.verify_service import service_verified
        got = cached_verify_sig(remote_node_id, payload, cert.sig)
        if got is not None:
            return got
        # tenant-tagged with the REMOTE peer's identity when
        # VERIFY_TENANT_FROM_PEER is on: a
        # handshake-flooding peer exhausts its own per-tenant quota
        # inside the auth lane instead of starving other peers
        from stellar_tpu_torch.crypto.tenant import peer_tenant
        res = service_verified(
            [(remote_node_id, payload, cert.sig)], lane="auth",
            tenant=peer_tenant(remote_node_id))
        if res is not None:
            return res[0]
        return verify_sig(remote_node_id, payload, cert.sig)

    def shared_keys(self, remote_pub: bytes, local_nonce: bytes,
                    remote_nonce: bytes, we_called: bool):
        """(sending_key, receiving_key) via HKDF over ECDH + nonces
        (reference ``PeerAuth::getSharedKey`` + per-direction expand)."""
        shared = c25519.scalarmult(self.ecdh_secret, remote_pub)
        # include both public keys sorted by role for symmetry
        if we_called:
            ikm = shared + self.ecdh_public + remote_pub
        else:
            ikm = shared + remote_pub + self.ecdh_public
        prk = c25519.hkdf_extract(ikm)
        if we_called:
            send_info = b"S" + local_nonce + remote_nonce
            recv_info = b"R" + remote_nonce + local_nonce
        else:
            send_info = b"R" + local_nonce + remote_nonce
            recv_info = b"S" + remote_nonce + local_nonce
        return (c25519.hkdf_expand(prk, send_info),
                c25519.hkdf_expand(prk, recv_info))


class FlowControl:
    """Message + byte credit flow control (reference
    ``FlowControl.h:27-104``: SEND_MORE_EXTENDED carries both axes;
    a flood message may only go out while the sender holds credits on
    BOTH)."""

    def __init__(self, capacity: int = PEER_FLOOD_READING_CAPACITY,
                 capacity_bytes: int = PEER_FLOOD_READING_CAPACITY_BYTES):
        self.outbound_credits = 0        # what the remote granted us
        self.outbound_bytes = 0
        self.to_grant = 0                # what we owe the remote
        self.to_grant_bytes = 0
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes

    def can_send(self, size: int) -> bool:
        return self.outbound_credits > 0 and self.outbound_bytes >= size

    def note_sent(self, size: int):
        self.outbound_credits -= 1
        self.outbound_bytes -= size

    def note_received(self, size: int) -> Optional[tuple]:
        """(messages, bytes) batch to grant back once either threshold
        hits (reference getFlowControlExtended batching)."""
        self.to_grant += 1
        self.to_grant_bytes += size
        if self.to_grant >= FLOW_CONTROL_SEND_MORE_BATCH or \
                self.to_grant_bytes >= FLOW_CONTROL_SEND_MORE_BATCH_BYTES:
            grant = (self.to_grant, self.to_grant_bytes)
            self.to_grant = self.to_grant_bytes = 0
            return grant
        return None

    def receive_credits(self, n: int, n_bytes: int):
        self.outbound_credits += n
        self.outbound_bytes += n_bytes


class PEER_STATE:
    CONNECTING = 0
    CONNECTED = 1       # transport up, HELLO not done
    GOT_HELLO = 2
    GOT_AUTH = 3        # fully authenticated
    CLOSING = 4


FLOOD_TYPES = (MessageType.TRANSACTION, MessageType.SCP_MESSAGE,
               MessageType.FLOOD_ADVERT, MessageType.FLOOD_DEMAND)


class Peer:
    """Protocol state machine over an abstract transport; subclasses
    provide ``send_bytes`` (Loopback or TCP)."""

    def __init__(self, app, we_called: bool):
        self.app = app  # duck-typed: .herder .clock .peer_auth .overlay
        self.we_called = we_called
        self.state = PEER_STATE.CONNECTED
        self.remote_node_id: Optional[bytes] = None
        self.remote_nonce: Optional[bytes] = None
        self.local_nonce = c25519.random_secret()
        self.send_key = self.recv_key = None
        self.send_seq = 0
        self.recv_seq = 0
        cfg = getattr(app, "config", None)
        self.flow = FlowControl(
            getattr(cfg, "PEER_FLOOD_READING_CAPACITY",
                    PEER_FLOOD_READING_CAPACITY),
            getattr(cfg, "PEER_FLOOD_READING_CAPACITY_BYTES",
                    PEER_FLOOD_READING_CAPACITY_BYTES))
        self.on_drop: Optional[Callable] = None
        # liveness bookkeeping for the overlay tick's timeout sweep
        # (reference Peer::mLastRead/mLastWrite / pending-peer age)
        now = app.clock.now()
        self.created_at = now
        self.last_read_time = now
        self.last_write_time = now

    # ---------------- transport hooks ----------------

    def send_bytes(self, raw: bytes):
        raise NotImplementedError

    def receive_bytes(self, raw: bytes):
        self.last_read_time = self.app.clock.now()
        sm = getattr(self.app.overlay, "survey_manager", None)
        if sm is not None:
            sm.note_traffic(self, read=len(raw))
        # fan-out parse cache: the INNER StellarMessage bytes of a
        # flooded frame are identical across peers (only the per-peer
        # sequence + mac differ), and the same tx/envelope arrives
        # from several peers before the floodgate dedups — parse each
        # unique message once and hand out compiled deep copies
        # (cheaper than re-parsing; copies keep nodes memory-isolated)
        inner = raw[12:-32]
        cached = _MSG_PARSE_CACHE.maybe_get(inner) \
            if len(raw) >= 44 and raw[:4] == b"\x00\x00\x00\x00" \
            else None
        if cached is not None:
            from stellar_tpu_torch.xdr.types import HmacSha256Mac
            am_v = AuthenticatedMessageV0(
                sequence=int.from_bytes(raw[4:12], "big"),
                message=StellarMessage.copy(cached),
                mac=HmacSha256Mac(mac=raw[-32:]))
            return self._recv_authenticated(am_v, raw)
        try:
            am = from_bytes(AuthenticatedMessage, raw)
        except Exception:
            return self.drop("malformed frame")
        # insertion happens in _recv_authenticated AFTER the MAC
        # verifies — unauthenticated senders must not populate (or
        # evict from) a process-wide cache
        self._recv_authenticated(am.value, raw, cache_inner=inner)

    # ---------------- handshake ----------------

    def start_handshake(self):
        if self.we_called:
            self._send_hello()

    def _send_hello(self):
        lcl = self.app.herder.lm.last_closed_header
        cfg = getattr(self.app, "config", None)
        hello = Hello(
            ledgerVersion=lcl.ledgerVersion,
            overlayVersion=getattr(cfg, "OVERLAY_PROTOCOL_VERSION",
                                   OVERLAY_VERSION),
            overlayMinVersion=getattr(cfg,
                                      "OVERLAY_PROTOCOL_MIN_VERSION",
                                      OVERLAY_VERSION),
            networkID=self.app.herder.network_id,
            versionStr=b"stellar_tpu",
            listeningPort=getattr(self.app, "port", 0),
            peerID=self.app.herder.scp.local_node_xdr,
            cert=self.app.peer_auth.cert,
            nonce=self.local_nonce)
        self._send_message(StellarMessage.make(MessageType.HELLO, hello))

    def _send_auth(self):
        self._send_message(StellarMessage.make(
            MessageType.AUTH,
            Auth(flags=200)))  # flow-control-in-bytes requested

    # ---------------- MAC framing ----------------

    def _send_message(self, msg, msg_bytes: bytes = None):
        """Frame + MAC + send. ``msg_bytes`` (the pre-packed
        StellarMessage) lets broadcast fan-out serialize a message ONCE
        for all peers; the wire layout is assembled by concatenation —
        AuthenticatedMessage(v=0){sequence, message, mac} is exactly
        uint32(0) || uhyper(seq) || message || mac(32), which the
        framing test pins against the full XDR pack."""
        if msg_bytes is None:
            msg_bytes = to_bytes(StellarMessage, msg)
        seq = self.send_seq
        mac = b"\x00" * 32
        if self.send_key is not None and msg.arm != MessageType.HELLO:
            mac = c25519.hmac_sha256(
                self.send_key,
                seq.to_bytes(8, "big") + msg_bytes)
            self.send_seq += 1
        raw = (b"\x00\x00\x00\x00" + seq.to_bytes(8, "big") +
               msg_bytes + mac)
        if msg.arm in FLOOD_TYPES and self.state == PEER_STATE.GOT_AUTH:
            self.flow.note_sent(len(raw))
        sm = getattr(self.app.overlay, "survey_manager", None)
        if sm is not None:
            sm.note_traffic(self, written=len(raw))
        self.last_write_time = self.app.clock.now()
        self.send_bytes(raw)

    def _recv_authenticated(self, am: AuthenticatedMessageV0,
                            raw: bytes, cache_inner: bytes = None):
        msg = am.message
        if msg.arm != MessageType.HELLO:
            if self.recv_key is None:
                return self.drop("message before handshake")
            if am.sequence != self.recv_seq:
                return self.drop("out-of-order sequence")
            # MAC input = uhyper(seq) || message — exactly the frame
            # between the 4-byte union tag and the 32-byte trailing
            # mac (from_bytes enforces canonical length), so no
            # re-serialization is needed
            if not c25519.verify_hmac_sha256(self.recv_key,
                                             raw[4:-32], am.mac.mac):
                return self.drop("bad MAC")
            self.recv_seq += 1
            if cache_inner is not None and msg.arm in FLOOD_TYPES \
                    and len(cache_inner) <= 65536:
                # cache a PRIVATE copy, only for MAC-verified flood
                # types (the only ones that repeat across peers) and
                # bounded in size — the live object handed onward may
                # be mutated and must never poison the cache
                _MSG_PARSE_CACHE.put(cache_inner,
                                     StellarMessage.copy(msg))
        # msg bytes = frame minus 4B tag, 8B seq, 32B mac — shared
        # downstream so flood hashing/re-broadcast never re-serializes
        self._recv_message(msg, raw[12:-32])

    # ---------------- dispatch ----------------

    def _recv_message(self, msg, msg_bytes: bytes):
        t = msg.arm
        if t == MessageType.HELLO:
            return self._recv_hello(msg.value)
        if t == MessageType.AUTH:
            return self._recv_auth()
        if self.state != PEER_STATE.GOT_AUTH:
            return self.drop("message before AUTH")
        if t == MessageType.SEND_MORE:
            self.flow.receive_credits(msg.value.numMessages, 0x7FFFFFFF)
            return
        if t == MessageType.SEND_MORE_EXTENDED:
            self.flow.receive_credits(msg.value.numMessages,
                                      msg.value.numBytes)
            return
        if t in FLOOD_TYPES:
            grant = self.flow.note_received(
                len(msg_bytes) + 44)  # + frame header
            if grant:
                self._send_message(StellarMessage.make(
                    MessageType.SEND_MORE_EXTENDED,
                    SendMoreExtended(numMessages=grant[0],
                                     numBytes=grant[1])))
        self.app.overlay.recv_message(self, msg, msg_bytes)

    def _recv_hello(self, hello: Hello):
        if self.state not in (PEER_STATE.CONNECTED,):
            return self.drop("duplicate HELLO")
        if hello.networkID != self.app.herder.network_id:
            return self.drop("wrong network")
        cfg = getattr(self.app, "config", None)
        our_min = getattr(cfg, "OVERLAY_PROTOCOL_MIN_VERSION",
                          OVERLAY_VERSION)
        our_ver = getattr(cfg, "OVERLAY_PROTOCOL_VERSION",
                          OVERLAY_VERSION)
        # overlay version handshake (reference Peer::recvHello: the
        # ranges must overlap)
        if hello.overlayVersion < our_min or \
                hello.overlayMinVersion > our_ver:
            return self.drop("incompatible overlay protocol version")
        now = self.app.clock.system_now()
        remote_id = hello.peerID.value
        if remote_id == self.app.herder.scp.local_node_id:
            return self.drop("connected to self")
        ban_mgr = getattr(self.app.overlay, "ban_manager", None)
        if ban_mgr is not None and ban_mgr.is_banned(remote_id):
            self._send_message(StellarMessage.make(
                MessageType.ERROR_MSG,
                ErrorMsg(code=ErrorCode.ERR_AUTH, msg=b"banned")))
            return self.drop("banned peer")
        if not self.app.peer_auth.verify_remote_cert(
                hello.cert, remote_id, now):
            self._send_message(StellarMessage.make(
                MessageType.ERROR_MSG,
                ErrorMsg(code=ErrorCode.ERR_AUTH, msg=b"bad cert")))
            return self.drop("bad auth cert")
        self.remote_node_id = remote_id
        self.remote_nonce = hello.nonce
        self.send_key, self.recv_key = self.app.peer_auth.shared_keys(
            hello.cert.pubkey.key, self.local_nonce, hello.nonce,
            self.we_called)
        self.state = PEER_STATE.GOT_HELLO
        if not self.we_called:
            self._send_hello()
        self._send_auth()

    def _recv_auth(self):
        if self.state != PEER_STATE.GOT_HELLO:
            return self.drop("AUTH out of order")
        self.state = PEER_STATE.GOT_AUTH
        # initial flood credits for the remote
        self._send_message(StellarMessage.make(
            MessageType.SEND_MORE_EXTENDED,
            SendMoreExtended(
                numMessages=self.flow.capacity,
                numBytes=self.flow.capacity_bytes)))
        self.app.overlay.peer_authenticated(self)

    # ---------------- outbound API ----------------

    def send(self, msg, msg_bytes: bytes = None):
        """Queue-or-send respecting flow control for flood traffic.
        ``msg_bytes`` shares one serialization across broadcast."""
        if self.state != PEER_STATE.GOT_AUTH:
            return
        if msg_bytes is None:
            msg_bytes = to_bytes(StellarMessage, msg)
        if msg.arm in FLOOD_TYPES and not self.flow.can_send(
                len(msg_bytes) + 44):
            return  # dropped under backpressure (reference load shedding)
        self._send_message(msg, msg_bytes)

    def is_authenticated(self) -> bool:
        return self.state == PEER_STATE.GOT_AUTH

    def drop(self, reason: str = "", announce: bool = True):
        if self.state == PEER_STATE.CLOSING:
            return  # already dropping (avoid send->fail->drop loops)
        was_auth = self.state == PEER_STATE.GOT_AUTH
        # CLOSING FIRST: a failing farewell send must not re-enter
        # drop (dead socket -> send error -> drop recursion)
        self.state = PEER_STATE.CLOSING
        if was_auth and reason and announce:
            # tell the remote WHY before closing (reference
            # sendErrorAndDrop), best effort only
            try:
                self._send_message(StellarMessage.make(
                    MessageType.ERROR_MSG,
                    ErrorMsg(code=ErrorCode.ERR_MISC,
                             msg=reason.encode()[:100])))
            except Exception:
                pass
        if self.on_drop is not None:
            self.on_drop(self, reason)
        self.app.overlay.peer_dropped(self, reason)
