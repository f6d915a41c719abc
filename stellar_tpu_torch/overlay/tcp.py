"""TCP peer transport (reference ``src/overlay/TCPPeer.cpp`` +
``PeerDoor.cpp`` + the OverlayManager connection maintainer):
length-prefixed AuthenticatedMessage frames over non-blocking sockets,
driven by OS readiness (``selectors``) from the node's crank loop — the
same single-threaded-I/O discipline as the reference's asio handlers,
without per-peer syscalls on idle ticks. Outbound connections come from
the PeerManager address book and report successes/failures back into
its backoff state.
"""

from __future__ import annotations

import errno
import selectors
import socket
import struct
from typing import Dict, Optional

from stellar_tpu_torch.overlay.peer import Peer

__all__ = ["TCPPeer", "PeerDoor", "TCPDriver"]

MAX_MESSAGE_SIZE = 0x1000000  # 16 MiB frame cap (reference MAX_MESSAGE_SIZE)


class TCPPeer(Peer):
    def __init__(self, app, we_called: bool, sock: socket.socket,
                 address=None):
        super().__init__(app, we_called)
        self.sock = sock
        self.sock.setblocking(False)
        self.address = address  # (host, port) for outbound book-keeping
        self._rx = bytearray()
        self._txq = bytearray()
        cfg = getattr(app, "config", None)
        # per-flush write budget (reference MAX_BATCH_WRITE_COUNT /
        # MAX_BATCH_WRITE_BYTES: cap one peer's drain so a fat queue
        # can't starve the poll loop)
        self._batch_bytes = getattr(cfg, "MAX_BATCH_WRITE_BYTES",
                                    1024 * 1024)
        self._batch_count = getattr(cfg, "MAX_BATCH_WRITE_COUNT", 1024)
        # when the queue first became non-empty (straggler detection)
        self._write_stalled_since = None

    def wants_write(self) -> bool:
        return bool(self._txq)

    def send_bytes(self, raw: bytes):
        if not self._txq:
            self._write_stalled_since = self.app.clock.now()
        self._txq += struct.pack(">I", len(raw)) + raw
        self._try_flush()

    def _try_flush(self):
        sent_bytes = 0
        sent_chunks = 0
        while self._txq and sent_bytes < self._batch_bytes and \
                sent_chunks < self._batch_count:
            try:
                n = self.sock.send(self._txq)
            except (BlockingIOError, InterruptedError):
                break  # fall through: partial progress still resets
            except OSError:
                return self.drop("socket write error")
            if n <= 0:
                break
            del self._txq[:n]
            sent_bytes += n
            sent_chunks += 1
        if sent_bytes > 0:
            # progress resets the straggler clock: a busy-but-draining
            # queue is healthy; only a reader that stopped ACCEPTING
            # bytes is a straggler
            self._write_stalled_since = None if not self._txq \
                else self.app.clock.now()

    def write_stalled_for(self, now: float) -> float:
        """Seconds the send queue has failed to drain (reference
        PEER_STRAGGLER_TIMEOUT enforcement)."""
        if self._write_stalled_since is None or not self._txq:
            return 0.0
        return now - self._write_stalled_since

    def on_readable(self):
        # drain the socket fully each poll tick (a single recv would cap
        # throughput at 64 KiB per 5 ms)
        while True:
            try:
                chunk = self.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return self.drop("socket read error")
            if not chunk:
                return self.drop("remote closed")
            self._rx += chunk
            if len(chunk) < 65536:
                break
        self._process_rx()

    def _process_rx(self):
        """Decode buffered frames, bounded per call (reference
        PEER_READING_CAPACITY: one peer can't monopolize a crank tick).
        Leftover complete frames drain on the NEXT poll tick — the
        driver re-calls this for every peer with buffered bytes, so a
        quiet socket can't strand them."""
        budget = getattr(getattr(self.app, "config", None),
                         "PEER_READING_CAPACITY", 200)
        while len(self._rx) >= 4 and budget > 0:
            (n,) = struct.unpack_from(">I", self._rx, 0)
            if n > MAX_MESSAGE_SIZE:
                return self.drop("oversized frame")
            if len(self._rx) < 4 + n:
                break
            frame = bytes(self._rx[4:4 + n])
            del self._rx[:4 + n]
            budget -= 1
            self.receive_bytes(frame)

    def has_buffered_frames(self) -> bool:
        if len(self._rx) < 4:
            return False
        (n,) = struct.unpack_from(">I", self._rx, 0)
        return len(self._rx) >= 4 + n

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class PeerDoor:
    """Listening socket accepting inbound peers (reference
    ``PeerDoor``)."""

    def __init__(self, app, port: int):
        self.app = app
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", port))
        self.listener.listen(16)
        self.listener.setblocking(False)
        self.port = self.listener.getsockname()[1]

    def try_accept(self) -> Optional[TCPPeer]:
        try:
            sock, _addr = self.listener.accept()
        except (BlockingIOError, InterruptedError):
            return None
        # inbound pending cap (reference MAX_INBOUND_PENDING_
        # CONNECTIONS; 0 derives from the shared pool)
        cfg = getattr(self.app, "config", None)
        max_in = getattr(cfg, "MAX_INBOUND_PENDING_CONNECTIONS", 0) or \
            max(1, getattr(cfg, "MAX_PENDING_CONNECTIONS", 500) // 2)
        in_pending = sum(
            1 for p in self.app.overlay.pending_peers
            if not getattr(p, "we_called", True))
        if in_pending >= max_in:
            sock.close()
            return None
        # authenticated-inbound cap: TARGET outbound + this many more
        # (reference MAX_ADDITIONAL_PEER_CONNECTIONS; -1 derives 8x
        # the outbound target, OverlayManagerImpl.cpp:318)
        max_add = getattr(cfg, "MAX_ADDITIONAL_PEER_CONNECTIONS", -1)
        if max_add < 0:
            max_add = getattr(cfg, "TARGET_PEER_CONNECTIONS", 8) * 8
        in_auth = sum(1 for p in self.app.overlay.peers
                      if not getattr(p, "we_called", True))
        if in_auth >= max_add:
            sock.close()
            return None
        peer = TCPPeer(self.app, we_called=False, sock=sock)
        self.app.overlay.add_pending(peer)
        return peer

    def close(self):
        self.listener.close()


RECONNECT_PERIOD = 2.0  # seconds between connection-maintainer passes


class TCPDriver:
    """Readiness-driven socket pump (the asio io_context role): a
    ``selectors`` registry watches the listener + every peer socket;
    poll() touches only ready sockets. One per node process."""

    def __init__(self, app, listen_port: int = 0):
        self.app = app
        app.tcp_driver = self  # the 'connect' admin route dials here
        self.door = PeerDoor(app, listen_port)
        self.peers: list = []
        self.sel = selectors.DefaultSelector()
        self.sel.register(self.door.listener, selectors.EVENT_READ, None)
        self._masks: Dict[socket.socket, int] = {}
        self._pump_armed = False
        self._last_maintain = 0.0
        self.arm()

    def connect(self, host: str, port: int) -> TCPPeer:
        self.app.overlay.peer_manager.ensure_exists(host, port)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.connect((host, port))
        except BlockingIOError:
            pass
        except OSError:
            self.app.overlay.peer_manager.on_connection_failure(
                host, port, self.app.clock.now())
            raise
        peer = TCPPeer(self.app, we_called=True, sock=sock,
                       address=(host, port))
        self.app.overlay.add_pending(peer)
        self.peers.append(peer)
        self._register(peer)
        # handshake begins once the socket is writable; send eagerly
        # (bytes queue until the connect completes)
        peer.start_handshake()
        return peer

    # ---------------- selector bookkeeping ----------------

    def _register(self, peer: TCPPeer):
        mask = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if peer.wants_write() else 0)
        self.sel.register(peer.sock, mask, peer)
        self._masks[peer.sock] = mask

    def _refresh_mask(self, peer: TCPPeer):
        want = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if peer.wants_write() else 0)
        if self._masks.get(peer.sock) != want:
            try:
                self.sel.modify(peer.sock, want, peer)
                self._masks[peer.sock] = want
            except KeyError:
                pass

    def _unregister(self, peer: TCPPeer):
        try:
            self.sel.unregister(peer.sock)
        except (KeyError, ValueError):
            pass
        self._masks.pop(peer.sock, None)

    # ---------------- the pump ----------------

    def poll(self):
        from stellar_tpu_torch.overlay.peer import PEER_STATE
        for key, events in self.sel.select(timeout=0):
            peer = key.data
            if peer is None:
                newp = self.door.try_accept()
                if newp is not None:
                    self.peers.append(newp)
                    self._register(newp)
                continue
            if events & selectors.EVENT_WRITE:
                peer._try_flush()
            if events & selectors.EVENT_READ:
                peer.on_readable()
        for p in list(self.peers):
            if p.state == PEER_STATE.CLOSING:
                self._unregister(p)
                if p.we_called and p.address and not p.is_authenticated():
                    self.app.overlay.peer_manager.on_connection_failure(
                        *p.address, now=self.app.clock.now())
                p.close()
                self.peers.remove(p)
            else:
                # drain frames left over a previous tick's read budget
                # (the socket may never become readable again)
                if p.has_buffered_frames():
                    p._process_rx()
                self._refresh_mask(p)
        self._maybe_maintain()

    def _maybe_maintain(self):
        """Connection maintainer (reference OverlayManager tick): top up
        outbound connections from the address book, respecting
        backoff."""
        now = self.app.clock.now()
        if now - self._last_maintain < RECONNECT_PERIOD:
            return
        self._last_maintain = now
        ov = self.app.overlay
        cfg = getattr(self.app, "config", None)
        if getattr(cfg,
                   "ARTIFICIALLY_SKIP_CONNECTION_ADJUSTMENT_FOR_TESTING",
                   False):
            return  # tests pin topology by hand
        target = getattr(cfg, "TARGET_PEER_CONNECTIONS", 8) \
            if cfg is not None else 8
        # cap in-flight outbound dials (reference
        # MAX_OUTBOUND_PENDING_CONNECTIONS; 0 derives from the shared
        # MAX_PENDING_CONNECTIONS pool)
        max_out_pending = getattr(
            cfg, "MAX_OUTBOUND_PENDING_CONNECTIONS", 0) or \
            max(1, getattr(cfg, "MAX_PENDING_CONNECTIONS", 500) // 2)
        out_pending = sum(1 for p in ov.pending_peers
                          if getattr(p, "we_called", False))
        if out_pending >= max_out_pending:
            return
        have = ov.authenticated_count() + len(ov.pending_peers)
        if have >= target:
            return
        connected = {p.address for p in self.peers if p.address}
        preferred_only = getattr(cfg, "PREFERRED_PEERS_ONLY", False)
        from stellar_tpu_torch.overlay.peer_manager import PeerType
        for rec in ov.peer_manager.random_peers(target - have, now=now):
            if preferred_only and rec.peer_type != PeerType.PREFERRED:
                continue  # reference PREFERRED_PEERS_ONLY
            addr = (rec.host, rec.port)
            if addr in connected:
                continue
            try:
                self.connect(rec.host, rec.port)
            except OSError:
                continue

    def arm(self):
        """Keep polling scheduled off the clock (REAL_TIME cranks)."""
        if self._pump_armed:
            return
        self._pump_armed = True
        from stellar_tpu_torch.utils.timer import VirtualTimer
        self._timer = VirtualTimer(self.app.clock)

        def tick():
            if not self._pump_armed:
                return
            self.poll()
            self._timer.expires_from_now(0.005)
            self._timer.async_wait(tick)
        self._timer.expires_from_now(0.0)
        self._timer.async_wait(tick)

    def close(self):
        self._pump_armed = False
        if hasattr(self, "_timer"):
            self._timer.cancel()
        try:
            self.sel.unregister(self.door.listener)
        except (KeyError, ValueError):
            pass
        self.door.close()
        for p in self.peers:
            self._unregister(p)
            p.close()
        self.peers.clear()
        self.sel.close()
