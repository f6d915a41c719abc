"""Streaming wire ingress: the verify plane's network front door — the
port's copy of ``stellar_tpu/crypto/ingress.py``.

A length-prefixed binary frame protocol (:mod:`stellar_tpu_torch.utils.
wire`) over a local socket, terminating in a
:class:`~stellar_tpu_torch.crypto.fleet.FleetRouter` (or a single
:class:`~stellar_tpu_torch.crypto.verify_service.VerifyService`).

**Zero-copy path.** Each connection reader ``recv_into`` s frame bodies
directly into buffers leased from a
:class:`~stellar_tpu_torch.parallel.hostbuf.HostBufferPool` and decodes
items in place: message bytes enter the service queues as
:class:`memoryview` slices of the lease (``pk``/``sig`` are 96 fixed
hashable bytes), and the lease is refcounted a frame — the buffer is
reused only after every ticket decoded from it reached a terminal and its
response left on the wire. The engine reads those views once, when it
encodes a submit's rows into its pinned operand fill.

**Traces start on the wire.** The reader allocates a contiguous trace
block (``verify_service._alloc_trace_block``) the moment a SUBMIT
frame's preamble decodes, before admission, and emits an
``ingress.frame`` recorder event, so a trace's timeline begins at the
wire and survives refusal (the typed
:class:`~stellar_tpu_torch.utils.resilience.Overloaded` is serialized
back as a canonical-JSON REFUSAL frame carrying
kind/lane/reason/tenant/replica/trace_lo) and fleet handoff
(``FleetRouter.submit(trace_lo=...)`` keeps the block through a replica
kill).

**Conservation extends to the wire.** Under the server's one condition
variable, at every snapshot, exactly::

    frames_received == decoded_frames + malformed_frames
    items_decoded   == accepted + refused
    accepted        == resolved + shed + failed + pending

(the last sum feeds the service's and the fleet's law: an accepted item
is the service's ``submitted``). ``snapshot()["conservation_gap"]`` is
the sum of the three residuals' magnitudes and must read 0.

**No lock across any socket operation.** Every
``accept``/``recv_into``/``sendall`` here happens with no lock held;
counters change under ``self._cv`` strictly after the I/O completed. The
module reads no clock: read deadlines ride ``socket.settimeout`` and
event counts (timeout polls a frame, recv-call budgets).

**A slow client cannot wedge the node.** The accept loop only accepts;
each connection gets its own reader and responder daemons.
Per-connection defenses: a mid-frame read deadline (a torn frame must
make progress every ``read_deadline_s``), a recv-call budget a frame (a
1-byte-a-recv trickler is cut off after ``frame_recv_limit`` recvs), a
total byte budget, and a frame-size ceiling enforced on the declared
length, before any buffering. A protocol violation gets a best-effort
typed ERROR frame, then the connection drops; a poisoned stream is never
resynced.

**Zero-loss drain.** ``stop()`` closes the listener and stops reading,
but every admitted ticket is flushed: responders keep draining until
each pending ticket reaches a terminal (a verdict, a typed refusal —
post-handoff outcomes after a fleet ``kill_replica`` included — or a
ticketed failure) and the response is sent, before the sockets close.
"""

from __future__ import annotations

import concurrent.futures
import socket
import threading
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np

from stellar_tpu_torch.crypto import batch_verifier
from stellar_tpu_torch.crypto import verify_service as vs_mod
from stellar_tpu_torch.parallel import hostbuf
from stellar_tpu_torch.utils import faults
from stellar_tpu_torch.utils import wire
from stellar_tpu_torch.utils.metrics import registry
from stellar_tpu_torch.utils.resilience import Overloaded

__all__ = ["IngressServer", "WireClient", "WireTicket",
           "ingress_health", "register_ingress_health",
           "READ_DEADLINE_S", "FRAME_RECV_LIMIT", "CONN_BYTE_BUDGET"]

# per-connection defense defaults (constructor overrides)
READ_DEADLINE_S = 5.0          # max wall time without mid-frame progress
FRAME_RECV_LIMIT = 8192        # max recv calls spent on ONE frame
CONN_BYTE_BUDGET = 1 << 30     # max bytes one connection may ever send
_POLL_S = 0.25                 # recv poll quantum (stop responsiveness)
_RESULT_TIMEOUT_S = 120.0      # max wait for one ticket's terminal

_MV = memoryview


# ---------------- health-surface registration ----------------
# same last-started-instance policy as register_service_health /
# register_fleet_health: the health surface reads whatever server is
# currently serving

_health_lock = threading.Lock()
_health_provider = None
_server_ref = None


def register_ingress_health(provider) -> None:
    global _health_provider
    with _health_lock:
        _health_provider = provider


def running_server():
    """The last-started (still-running) server instance, or None —
    the journal collector reads its wire totals through
    this, the same last-started-instance policy as the health
    surface."""
    with _health_lock:
        return _server_ref


def ingress_health() -> dict:
    """The active server's snapshot, or ``{"enabled": False}``."""
    with _health_lock:
        p = _health_provider
    if p is None:
        return {"enabled": False}
    snap = p()
    snap["enabled"] = True
    return snap


class IngressServer:
    """The wire front door over ``front`` (a FleetRouter or a
    VerifyService — anything with
    ``submit(items, lane=, tenant=, trace_lo=)``)."""

    def __init__(self, front, host: str = "127.0.0.1", port: int = 0,
                 *, max_frame_bytes: int = wire.MAX_FRAME_BYTES,
                 read_deadline_s: float = READ_DEADLINE_S,
                 frame_recv_limit: int = FRAME_RECV_LIMIT,
                 conn_byte_budget: int = CONN_BYTE_BUDGET,
                 result_timeout_s: float = _RESULT_TIMEOUT_S,
                 pool: Optional[hostbuf.HostBufferPool] = None):
        self._cv = threading.Condition()
        self._front = front
        self._host = host
        self._port = int(port)
        self.max_frame_bytes = int(max_frame_bytes)
        self.read_deadline_s = float(read_deadline_s)
        self.frame_recv_limit = int(frame_recv_limit)
        self.conn_byte_budget = int(conn_byte_budget)
        self.result_timeout_s = float(result_timeout_s)
        if pool is None:
            pool = hostbuf.HostBufferPool(
                buf_bytes=max(hostbuf.DEFAULT_BUF_BYTES,
                              self.max_frame_bytes))
        if pool.buf_bytes < self.max_frame_bytes:
            raise ValueError("pool buffers smaller than the frame "
                             "ceiling — a max-size frame must fit")
        self._pool = pool
        self._listener: Optional[socket.socket] = None
        self._accept_t: Optional[threading.Thread] = None
        self._running = False
        self._stopping = False
        self._conn_seq = 0
        self._conns: Dict[int, dict] = {}
        # the wire-extended conservation counters (module docstring) —
        # every one mutates ONLY under self._cv, strictly after the
        # socket op that justified it completed
        self._frames_received = 0
        self._decoded_frames = 0
        self._malformed_frames = 0
        self._items_decoded = 0
        self._accepted = 0
        self._refused = 0
        self._resolved = 0
        self._shed = 0
        self._failed = 0
        self._pending = 0
        self._bytes_in = 0
        self._bytes_out = 0
        self._conns_total = 0
        self._deadline_kills = 0
        self._budget_kills = 0
        self._send_failures = 0
        self._malformed_reasons: Dict[str, int] = {}

    # ---------------- lifecycle ----------------

    @property
    def port(self) -> int:
        with self._cv:
            return self._port

    def start(self) -> "IngressServer":
        with self._cv:
            if self._running:
                return self
            self._running = True
            self._stopping = False
        lst = socket.create_server((self._host, self._port))
        lst.settimeout(_POLL_S)
        t = threading.Thread(target=self._accept_loop, args=(lst,),
                             daemon=True, name="ingress-accept")
        with self._cv:
            self._listener = lst
            self._port = lst.getsockname()[1]
            self._accept_t = t
        t.start()
        register_ingress_health(self.snapshot)
        global _server_ref
        with _health_lock:
            _server_ref = self
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Zero-loss drain: stop accepting and reading, flush every
        admitted ticket's response, then close. ``timeout`` bounds
        each thread join (the responders themselves bound each
        ticket wait by ``result_timeout_s`` — a wedged terminal
        becomes a counted, ticketed failure, never silence)."""
        with self._cv:
            if not self._running:
                return
            self._stopping = True
            lst = self._listener
            self._listener = None
            accept_t = self._accept_t
            conns = list(self._conns.values())
            self._cv.notify_all()
        if lst is not None:
            lst.close()
        if accept_t is not None:
            accept_t.join(timeout or 30.0)
        for conn in conns:
            conn["reader_t"].join(timeout or 30.0)
        for conn in conns:
            conn["responder_t"].join(
                timeout or self.result_timeout_s + 30.0)
        with self._cv:
            self._running = False

    # ---------------- accept loop (never blocks on a client) ------

    def _accept_loop(self, lst: socket.socket) -> None:
        while True:
            with self._cv:
                if self._stopping:
                    return
            try:
                sock, _addr = lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.settimeout(_POLL_S)
            conn = {
                "sock": sock,
                "pending": deque(),   # FIFO of response entries
                "reader_done": False,
                "killed": False,
            }
            rt = threading.Thread(target=self._conn_reader,
                                  args=(conn,), daemon=True,
                                  name="ingress-read")
            st = threading.Thread(target=self._conn_responder,
                                  args=(conn,), daemon=True,
                                  name="ingress-respond")
            conn["reader_t"] = rt
            conn["responder_t"] = st
            with self._cv:
                cid = self._conn_seq
                self._conn_seq += 1
                conn["id"] = cid
                self._conns[cid] = conn
                self._conns_total += 1
            registry.gauge("crypto.verify.ingress.connections").set(
                len(self._conns))
            rt.start()
            st.start()

    # ---------------- per-connection reader ----------------

    def _read_exact(self, conn: dict, view, n: int,
                    mid_frame: bool) -> str:
        """Fill ``view[:n]`` from the connection. Returns ``"ok"``,
        ``"eof"`` (clean close between frames), ``"disconnect"``
        (close mid-frame), ``"deadline"`` (no mid-frame progress
        within the read deadline), ``"slow-frame"`` (recv-call
        budget for this frame exhausted), or ``"stopped"``. Clock
        discipline: the deadline is counted in ``_POLL_S`` timeout
        polls, never read from a clock."""
        sock = conn["sock"]
        got = 0
        idle_polls = 0
        max_polls = max(1, int(self.read_deadline_s / _POLL_S))
        while got < n:
            with self._cv:
                stopping = self._stopping
            if stopping and not mid_frame and got == 0:
                return "stopped"
            conn["frame_recvs"] += 1
            if conn["frame_recvs"] > self.frame_recv_limit:
                return "slow-frame"
            try:
                r = sock.recv_into(view[got:n])
            except socket.timeout:
                if mid_frame or got > 0:
                    idle_polls += 1
                    if idle_polls >= max_polls:
                        return "deadline"
                continue
            except OSError:
                return "disconnect" if (mid_frame or got) else "eof"
            if r == 0:
                return "disconnect" if (mid_frame or got) else "eof"
            idle_polls = 0
            got += r
            conn["bytes"] += r
        return "ok"

    def _conn_reader(self, conn: dict) -> None:
        lease = self._pool.lease()
        pos = 0
        header = bytearray(wire.HEADER_LEN)
        hview = _MV(header)
        try:
            while True:
                conn["frame_recvs"] = 0
                conn.setdefault("bytes", 0)
                status = self._read_exact(conn, hview,
                                          wire.HEADER_LEN,
                                          mid_frame=False)
                if status in ("eof", "stopped"):
                    return
                if status != "ok":
                    self._kill_conn(conn, status, frame=status in
                                    ("disconnect", "deadline",
                                     "slow-frame"))
                    return
                ftype, length = wire._HDR.unpack(header)
                if ftype not in (wire.SUBMIT,):
                    self._kill_conn(conn, "garbage", frame=True)
                    return
                if length > self.max_frame_bytes:
                    self._kill_conn(conn, "oversize", frame=True)
                    return
                if conn["bytes"] + length > self.conn_byte_budget:
                    self._kill_conn(conn, "byte-budget", frame=True)
                    return
                if pos + length > len(lease.buf):
                    # rotate to a fresh lease; the old buffer stays
                    # alive until its decoded frames' tickets finish
                    old = lease
                    lease = self._pool.lease()
                    pos = 0
                    self._pool.release(old)
                body = lease.mv[pos:pos + length]
                status = self._read_exact(conn, body, length,
                                          mid_frame=True)
                if status != "ok":
                    self._kill_conn(conn, status, frame=True)
                    return
                pos += length
                try:
                    req_id, lane, tenant, items = \
                        wire.decode_submit(body)
                except wire.MalformedFrame as e:
                    self._kill_conn(conn, e.reason, frame=True)
                    return
                self._admit(conn, lease, req_id, lane, tenant, items,
                            wire.HEADER_LEN + length)
        finally:
            self._pool.release(lease)
            with self._cv:
                conn["reader_done"] = True
                self._cv.notify_all()

    def _admit(self, conn: dict, lease, req_id: int, lane: str,
               tenant: Optional[str], items: list,
               frame_bytes: int) -> None:
        """One decoded SUBMIT frame → trace block, recorder event,
        admission, and EXACT counter movement (one locked section
        per outcome, after the submit attempt completed)."""
        n = len(items)
        trace_lo = vs_mod._alloc_trace_block(n)
        trange = [[trace_lo, trace_lo + n]] if n else []
        batch_verifier.note_trace_event(
            "ingress.frame", lane=lane, tenant=tenant, traces=trange,
            conn=conn["id"], req_id=req_id, items=n,
            nbytes=frame_bytes)
        entry = None
        refusal = None
        try:
            tkt = self._front.submit(items, lane=lane, tenant=tenant,
                                     trace_lo=trace_lo)
            entry = ("ticket", req_id, trace_lo, n, tkt, lease)
        except Overloaded as e:
            refusal = wire.encode_refusal(
                req_id, kind=e.kind, lane=e.lane, reason=e.reason,
                tenant=e.tenant, replica=e.replica,
                trace_lo=trace_lo, n=n, message=str(e))
        except ValueError as e:
            # semantic garbage (unknown lane / invalid tenant): a
            # typed refusal, not a dead connection — framing is fine
            refusal = wire.encode_refusal(
                req_id, kind="rejected", lane=lane,
                reason="invalid", tenant=None, replica=None,
                trace_lo=trace_lo, n=n, message=str(e))
        if entry is not None:
            # the lease must be retained BEFORE the entry becomes
            # visible to the responder (which releases it)
            self._pool.retain(lease)
        with self._cv:
            self._frames_received += 1
            self._decoded_frames += 1
            self._items_decoded += n
            self._bytes_in += frame_bytes
            if entry is not None:
                self._accepted += n
                self._pending += n
                conn["pending"].append(entry)
            else:
                self._refused += n
                conn["pending"].append(("raw", refusal))
            self._cv.notify_all()
        registry.meter("crypto.verify.ingress.frames").mark(1)
        registry.meter("crypto.verify.ingress.items").mark(n)
        registry.meter("crypto.verify.ingress.bytes_in").mark(
            frame_bytes)
        if entry is None:
            registry.meter("crypto.verify.ingress.refused").mark(n)

    def _kill_conn(self, conn: dict, reason: str,
                   frame: bool) -> None:
        """Protocol violation / budget exhaustion: best-effort typed
        ERROR frame, count (a malformed event counts as a received
        frame — the wire law stays exact), drop the read side. The
        responder still drains every already-admitted ticket."""
        try:
            conn["sock"].sendall(wire.encode_error(reason))
        except OSError:
            pass
        try:
            conn["sock"].shutdown(socket.SHUT_RD)
        except OSError:
            pass
        with self._cv:
            if frame:
                self._frames_received += 1
                self._malformed_frames += 1
                self._malformed_reasons[reason] = \
                    self._malformed_reasons.get(reason, 0) + 1
            if reason == "deadline":
                self._deadline_kills += 1
            elif reason == "byte-budget":
                self._budget_kills += 1
            conn["killed"] = True
        if frame:
            registry.meter("crypto.verify.ingress.malformed").mark(1)
        batch_verifier.note_trace_event(
            "ingress.malformed", conn=conn["id"], reason=reason)

    # ---------------- per-connection responder ----------------

    def _conn_responder(self, conn: dict) -> None:
        try:
            while True:
                entry = None
                with self._cv:
                    if conn["pending"]:
                        entry = conn["pending"].popleft()
                    elif conn["reader_done"]:
                        return
                    else:
                        self._cv.wait(0.05)
                        continue
                self._respond_one(conn, entry)
        finally:
            try:
                conn["sock"].close()
            except OSError:
                pass
            with self._cv:
                self._conns.pop(conn["id"], None)
                nconn = len(self._conns)
            registry.gauge(
                "crypto.verify.ingress.connections").set(nconn)

    def _respond_one(self, conn: dict, entry: tuple) -> None:
        if entry[0] == "raw":
            self._send_response(conn, entry[1])
            return
        # ("ticket", req_id, trace_lo, n, tkt, lease)
        _, req_id, trace_lo, n, tkt, lease = entry
        terminal = "resolved"
        try:
            out = np.asarray(
                tkt.result(timeout=self.result_timeout_s))
            fb = wire.encode_verdict(req_id, trace_lo, out.tolist())
        except Overloaded as e:
            # a typed post-admission verdict: a shed, or a refusal
            # from the survivor a fleet handoff re-homed us to —
            # either way the client gets the full typed story
            terminal = "shed"
            fb = wire.encode_refusal(
                req_id, kind=e.kind, lane=e.lane, reason=e.reason,
                tenant=e.tenant, replica=e.replica,
                trace_lo=trace_lo, n=n, message=str(e))
        except BaseException as e:  # ticketed failure, never silence
            terminal = "failed"
            fb = wire.encode_refusal(
                req_id, kind="failed", lane=None,
                reason="dispatch-error", tenant=None, replica=None,
                trace_lo=trace_lo, n=n, message=str(e))
        self._send_response(conn, fb)
        with self._cv:
            self._pending -= n
            if terminal == "resolved":
                self._resolved += n
            elif terminal == "shed":
                self._shed += n
            else:
                self._failed += n
        self._pool.release(lease)
        registry.meter(
            f"crypto.verify.ingress.{terminal}").mark(n)

    def _send_response(self, conn: dict, fb: bytes) -> None:
        sent = False
        try:
            conn["sock"].sendall(fb)
            sent = True
        except OSError:
            pass
        with self._cv:
            if sent:
                self._bytes_out += len(fb)
            else:
                self._send_failures += 1
        if sent:
            registry.meter(
                "crypto.verify.ingress.bytes_out").mark(len(fb))

    # ---------------- observability ----------------

    def journal_totals(self) -> dict:
        """Never-evicting wire totals for the system journal — the
        ingress half of the completeness law
        (:func:`stellar_tpu_torch.utils.journal.completeness` reconciles
        them against the fleet/service terminals). The wire counters
        depend on socket timing (how much a flooder got through), so
        the journal treats ingress as a NONDETERMINISTIC component:
        included in the completeness reconciliation, excluded from
        the bit-identity merge. No gauge side effects — journal
        collection must be a pure read (unlike :meth:`snapshot`)."""
        with self._cv:
            return {
                "frames_received": self._frames_received,
                "decoded_frames": self._decoded_frames,
                "malformed_frames": self._malformed_frames,
                "items_decoded": self._items_decoded,
                "accepted": self._accepted,
                "refused": self._refused,
                "resolved": self._resolved,
                "shed": self._shed,
                "failed": self._failed,
                "pending": self._pending,
            }

    def snapshot(self) -> dict:
        """The ingress surface: every wire counter plus the
        wire-extended conservation residual (must read 0)."""
        with self._cv:
            wire_gap = self._frames_received - (
                self._decoded_frames + self._malformed_frames)
            admit_gap = self._items_decoded - (
                self._accepted + self._refused)
            term_gap = self._accepted - (
                self._resolved + self._shed + self._failed
                + self._pending)
            snap = {
                "running": self._running,
                "port": self._port,
                "connections": len(self._conns),
                "connections_total": self._conns_total,
                "frames_received": self._frames_received,
                "decoded_frames": self._decoded_frames,
                "malformed_frames": self._malformed_frames,
                "malformed_reasons": dict(self._malformed_reasons),
                "items_decoded": self._items_decoded,
                "accepted": self._accepted,
                "refused": self._refused,
                "resolved": self._resolved,
                "shed": self._shed,
                "failed": self._failed,
                "pending": self._pending,
                "bytes_in": self._bytes_in,
                "bytes_out": self._bytes_out,
                "deadline_kills": self._deadline_kills,
                "budget_kills": self._budget_kills,
                "send_failures": self._send_failures,
                "conservation_gap": (abs(wire_gap) + abs(admit_gap)
                                     + abs(term_gap)),
                "pool": self._pool.stats(),
            }
        registry.gauge("crypto.verify.ingress.pending").set(
            snap["pending"])
        registry.gauge(
            "crypto.verify.ingress.conservation_gap").set(
            snap["conservation_gap"])
        return snap


# ---------------- client ----------------

class WireTicket:
    """Client-side handle for one SUBMIT frame: quacks like a
    :class:`VerifyTicket` (``result``/``done``/``n_items``/``lane``/
    ``tenant``); ``trace_lo`` is learned from the response frame."""

    __slots__ = ("lane", "tenant", "n_items", "req_id", "trace_lo",
                 "_fut")

    def __init__(self, lane: str, tenant: Optional[str], n: int,
                 req_id: int):
        self.lane = lane
        self.tenant = tenant
        self.n_items = n
        self.req_id = req_id
        self.trace_lo: Optional[int] = None
        self._fut = concurrent.futures.Future()

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        return self._fut.result(timeout)


class WireClient:
    """A well-behaved (or, with ``fault_point``, deliberately
    misbehaving — see ``faults.WIRE_MODES``/``faults.send_mangled``)
    wire client. Responses are correlated by ``req_id``, so they may
    arrive in any order; a reader daemon resolves tickets, rebuilding
    the typed :class:`Overloaded` from REFUSAL frames field by
    field."""

    def __init__(self, host: str, port: int, *,
                 timeout: float = 60.0,
                 fault_point: Optional[str] = None):
        self._lock = threading.Lock()
        sock = socket.create_connection((host, port),
                                        timeout=timeout)
        sock.settimeout(timeout)
        self._sock = sock
        self._fault_point = fault_point
        self._req_seq = 0
        self._pending: Dict[int, WireTicket] = {}
        self._closed = False
        self._dead = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="wire-client")
        self._reader.start()

    # -- two-step API so callers can time the encode

    def reserve(self, lane: str, tenant: Optional[str],
                n: int) -> WireTicket:
        with self._lock:
            req_id = self._req_seq
            self._req_seq += 1
            tkt = WireTicket(lane, tenant, n, req_id)
            self._pending[req_id] = tkt
        return tkt

    def send_encoded(self, tkt: WireTicket, data: bytes) -> WireTicket:
        try:
            if self._fault_point:
                if not faults.send_mangled(self._sock, data,
                                           self._fault_point):
                    raise ConnectionError(
                        "wire fault closed the connection")
            else:
                self._sock.sendall(data)
        except OSError as e:
            self._fail_all(e)
            raise
        return tkt

    def submit(self, items: Sequence[tuple], lane: str = "bulk",
               tenant: Optional[str] = None) -> WireTicket:
        tkt = self.reserve(lane, tenant, len(items))
        data = wire.encode_submit(items, lane, tenant, tkt.req_id)
        return self.send_encoded(tkt, data)

    def verify(self, items: Sequence[tuple], lane: str = "bulk",
               tenant: Optional[str] = None,
               timeout: Optional[float] = None):
        return self.submit(items, lane, tenant).result(timeout)

    @property
    def alive(self) -> bool:
        """False once a wire fault, server kill, or close has failed
        the connection — misbehaving clients poll this to know
        when to reconnect."""
        with self._lock:
            return not (self._dead or self._closed)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # shutdown first: it tears the connection down and wakes the
        # reader thread even while it is blocked in recv (a bare
        # close only drops this fd's reference — the kernel keeps the
        # connection alive under the blocked read, so the server
        # would never see the FIN)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    # -- reader

    def _read_loop(self) -> None:
        dec = wire.FrameDecoder()
        try:
            while True:
                try:
                    data = self._sock.recv(65536)
                except socket.timeout:
                    with self._lock:
                        if self._closed:
                            return
                    continue
                except OSError:
                    break
                if not data:
                    break
                for ftype, decoded in dec.feed_decoded(data):
                    self._dispatch(ftype, decoded)
        except wire.MalformedFrame as e:
            self._fail_all(e)
            return
        self._fail_all(ConnectionError("ingress connection closed"))

    def _dispatch(self, ftype: int, decoded) -> None:
        if ftype == wire.VERDICT:
            req_id, trace_lo, verdicts = decoded
            tkt = self._take(req_id)
            if tkt is not None:
                tkt.trace_lo = trace_lo
                tkt._fut.set_result(np.asarray(verdicts, dtype=bool))
        elif ftype == wire.REFUSAL:
            d = decoded
            tkt = self._take(d.get("req_id"))
            if tkt is not None:
                tkt.trace_lo = d.get("trace_lo")
                n = int(d.get("n") or 0)
                lo = int(d.get("trace_lo") or 0)
                if d.get("kind") in ("rejected", "shed"):
                    tkt._fut.set_exception(Overloaded(
                        d.get("message") or "refused on the wire",
                        kind=d["kind"], lane=d.get("lane"),
                        reason=d.get("reason") or "",
                        tenant=d.get("tenant"),
                        trace_ids=range(lo, lo + n),
                        replica=d.get("replica")))
                else:
                    tkt._fut.set_exception(RuntimeError(
                        d.get("message") or "ingress failure"))
        # ERROR frames have no req_id: the server is about to close;
        # the closing recv loop fails every pending ticket

    def _take(self, req_id) -> Optional[WireTicket]:
        if req_id is None:
            return None
        with self._lock:
            return self._pending.pop(req_id, None)

    def _fail_all(self, err: BaseException) -> None:
        with self._lock:
            self._dead = True
            pend = list(self._pending.values())
            self._pending.clear()
        for tkt in pend:
            if not tkt._fut.done():
                tkt._fut.set_exception(err)
