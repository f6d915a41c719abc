"""Length-prefixed binary frame codec of the streaming verify ingress —
the port's copy of ``stellar_tpu/utils/wire.py``, byte for byte the
reference's frames (the wire half of
:mod:`stellar_tpu_torch.crypto.ingress`).

Every frame is a fixed 5-byte header ``type:u8 || length:u32be``
followed by exactly ``length`` payload bytes. Four frame types:

* ``SUBMIT`` (0x01), client → server::

      req_id:u32be || lane_len:u8 || lane || tenant_len:u8 || tenant
      || count:u16be || count * (pk_len:u8 || pk || sig_len:u8 || sig
                                 || msg_len:u32be || msg)

  ``tenant_len == 0`` encodes the quota-exempt default tenant
  (``None``). ``req_id`` is a client-chosen correlation id echoed in the
  response frame, so responses need no ordering. ``pk_len``/``sig_len``
  are canonically :data:`PK_LEN` (32) / :data:`SIG_LEN` (64) but not
  enforced by the codec: the verifier is the sole authority on key and
  signature validity, so a structurally invalid key rides the wire and
  comes back as verdict ``False``, as in a direct in-process submission.

* ``VERDICT`` (0x02), server → client::

      req_id:u32be || trace_lo:u64be || count:u16be || count * u8

  one 0/1 byte an item, index-aligned with the submission; the items'
  trace IDs are ``range(trace_lo, trace_lo + count)``.

* ``REFUSAL`` (0x03), server → client: a canonical-JSON rendering of a
  typed :class:`~stellar_tpu_torch.utils.resilience.Overloaded`
  (kind/lane/reason/tenant/replica/trace_lo/n/req_id/message).
  Canonical = ``sort_keys=True`` + ``separators=(",", ":")``: two servers
  refusing the same submission for the same reason emit identical bytes.

* ``ERROR`` (0x04), server → client: a canonical-JSON wire-protocol error
  (``reason`` one of ``"garbage"``, ``"oversize"``, ``"deadline"``,
  ``"byte-budget"``, ``"truncated-item"``, ``"trailing-bytes"``,
  ``"slow-frame"``, ``"stopped"``) sent best-effort before the server
  closes a connection it can no longer trust to be in frame sync.

Decoding is streaming and tear-proof: :class:`FrameDecoder` may be fed
any byte split of a valid frame sequence and yields exactly the frames of
feeding it whole. Anything that is not a well-formed frame raises
:class:`MalformedFrame` with a typed ``reason``, never a silent resync:
after a malformed frame the decoder is poisoned (``dead``), because frame
boundaries are no longer trustworthy, and the transport must drop the
connection (as the ingress server does).

A pure codec: no sockets, threads, locks, clocks or random numbers, so
two nodes decoding the same bytes always agree on what arrived.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "SUBMIT", "VERDICT", "REFUSAL", "ERROR", "HEADER_LEN",
    "MAX_FRAME_BYTES", "PK_LEN", "SIG_LEN", "MalformedFrame",
    "FrameDecoder", "encode_submit", "encode_verdict",
    "encode_refusal", "encode_error", "decode_payload",
    "decode_submit", "decode_verdict", "decode_json", "frame",
    "split_points",
]

SUBMIT = 0x01
VERDICT = 0x02
REFUSAL = 0x03
ERROR = 0x04

_TYPES = frozenset((SUBMIT, VERDICT, REFUSAL, ERROR))

HEADER_LEN = 5
PK_LEN = 32
SIG_LEN = 64

# the default frame ceiling: a declared length above this is refused
# as ``oversize`` WITHOUT buffering the body — a client cannot make
# the server reserve memory by declaring a huge frame
MAX_FRAME_BYTES = 1 << 20

_HDR = struct.Struct(">BI")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


class MalformedFrame(ValueError):
    """A typed wire-protocol violation. ``reason`` is the machine
    name the ingress counters and the ERROR reply carry:
    ``"garbage"`` (unknown frame type — includes any garbage-prefix
    attack byte), ``"oversize"`` (declared length over the ceiling),
    ``"truncated-item"`` (payload too short for its own counts),
    ``"trailing-bytes"`` (payload longer than its counts account
    for), ``"bad-json"`` (REFUSAL/ERROR payload not canonical
    JSON)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"malformed frame ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


def frame(ftype: int, payload: bytes) -> bytes:
    """One encoded frame: header + payload."""
    return _HDR.pack(ftype, len(payload)) + payload


# ---------------- encoders ----------------

def encode_submit(items: Sequence[tuple], lane: str = "bulk",
                  tenant: Optional[str] = None,
                  req_id: int = 0) -> bytes:
    """Encode ``(pk, msg, sig)`` triples into one SUBMIT frame."""
    lane_b = lane.encode()
    ten_b = (tenant or "").encode()
    if len(lane_b) > 255 or len(ten_b) > 255:
        raise ValueError("lane/tenant over 255 bytes")
    if len(items) > 0xFFFF:
        raise ValueError("over 65535 items per frame")
    parts = [_U32.pack(req_id & 0xFFFFFFFF),
             bytes([len(lane_b)]), lane_b,
             bytes([len(ten_b)]), ten_b,
             _U16.pack(len(items))]
    for pk, msg, sig in items:
        if len(pk) > 255 or len(sig) > 255:
            raise ValueError("pk/sig over 255 bytes")
        parts.append(bytes([len(pk)]))
        parts.append(bytes(pk))
        parts.append(bytes([len(sig)]))
        parts.append(bytes(sig))
        parts.append(_U32.pack(len(msg)))
        parts.append(bytes(msg))
    return frame(SUBMIT, b"".join(parts))


def encode_verdict(req_id: int, trace_lo: int,
                   verdicts: Sequence) -> bytes:
    """Encode one per-item 0/1 verdict vector."""
    body = bytes(1 if bool(v) else 0 for v in verdicts)
    return frame(VERDICT, _U32.pack(req_id & 0xFFFFFFFF)
                 + _U64.pack(trace_lo) + _U16.pack(len(body)) + body)


def _canonical_json(obj: dict) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


def encode_refusal(req_id: int, *, kind: str, lane: Optional[str],
                   reason: str, tenant: Optional[str],
                   replica: Optional[int], trace_lo: int, n: int,
                   message: str = "") -> bytes:
    """Canonical-JSON refusal: field-for-field the typed
    ``Overloaded`` the server raised. Two servers refusing the same
    submission emit byte-identical frames."""
    return frame(REFUSAL, _canonical_json({
        "req_id": int(req_id), "kind": kind, "lane": lane,
        "reason": reason, "tenant": tenant, "replica": replica,
        "trace_lo": int(trace_lo), "n": int(n), "message": message,
    }))


def encode_error(reason: str, detail: str = "") -> bytes:
    """Canonical-JSON wire-protocol error (sent before close)."""
    return frame(ERROR, _canonical_json(
        {"reason": reason, "detail": detail}))


# ---------------- payload decoders ----------------

def decode_submit(payload) -> Tuple[int, str, Optional[str], list]:
    """``(req_id, lane, tenant, items)`` from a SUBMIT payload.

    ``payload`` may be a :class:`memoryview` into a reusable host
    buffer: each item's ``msg`` is returned as a zero-copy slice of
    it (``pk``/``sig`` are materialized as :class:`bytes` — 96 fixed
    bytes per item, and downstream caches key on them, so they must
    be hashable). The caller owns keeping the backing buffer alive
    until the items reach a terminal."""
    mv = memoryview(payload)
    try:
        req_id = _U32.unpack_from(mv, 0)[0]
        pos = 4
        lane_len = mv[pos]
        pos += 1
        lane = bytes(mv[pos:pos + lane_len]).decode()
        pos += lane_len
        ten_len = mv[pos]
        pos += 1
        tenant = bytes(mv[pos:pos + ten_len]).decode() or None
        pos += ten_len
        count = _U16.unpack_from(mv, pos)[0]
        pos += 2
    except (struct.error, IndexError):
        raise MalformedFrame("truncated-item", "submit preamble")
    items = []
    end = len(mv)
    for _ in range(count):
        # pk/sig carry their own u8 lengths (canonically PK_LEN /
        # SIG_LEN, but NOT enforced here: the verifier is the
        # authority on key validity — a structurally invalid key must
        # ride the wire and come back as verdict False, exactly like
        # a direct in-process submission)
        if pos + 1 > end:
            raise MalformedFrame("truncated-item",
                                 f"item {len(items)} pk length")
        pklen = mv[pos]
        pos += 1
        if pos + pklen + 1 > end:
            raise MalformedFrame("truncated-item",
                                 f"item {len(items)} pk")
        pk = bytes(mv[pos:pos + pklen])
        pos += pklen
        siglen = mv[pos]
        pos += 1
        if pos + siglen + 4 > end:
            raise MalformedFrame("truncated-item",
                                 f"item {len(items)} sig")
        sig = bytes(mv[pos:pos + siglen])
        pos += siglen
        mlen = _U32.unpack_from(mv, pos)[0]
        pos += 4
        if pos + mlen > end:
            raise MalformedFrame("truncated-item",
                                 f"item {len(items)} body")
        items.append((pk, mv[pos:pos + mlen], sig))
        pos += mlen
    if pos != end:
        raise MalformedFrame("trailing-bytes",
                             f"{end - pos} bytes after last item")
    return req_id, lane, tenant, items


def decode_verdict(payload) -> Tuple[int, int, list]:
    """``(req_id, trace_lo, [bool])`` from a VERDICT payload."""
    mv = memoryview(payload)
    try:
        req_id = _U32.unpack_from(mv, 0)[0]
        trace_lo = _U64.unpack_from(mv, 4)[0]
        count = _U16.unpack_from(mv, 12)[0]
    except struct.error:
        raise MalformedFrame("truncated-item", "verdict preamble")
    if len(mv) != 14 + count:
        raise MalformedFrame("trailing-bytes", "verdict body")
    return req_id, trace_lo, [b != 0 for b in bytes(mv[14:])]


def decode_json(payload) -> dict:
    """REFUSAL / ERROR payload → dict."""
    try:
        obj = json.loads(bytes(payload).decode())
    except (ValueError, UnicodeDecodeError):
        raise MalformedFrame("bad-json")
    if not isinstance(obj, dict):
        raise MalformedFrame("bad-json", "not an object")
    return obj


def decode_payload(ftype: int, payload):
    """Dispatch a payload to its typed decoder — the ONE parsing
    path both the streaming decoder and the ingress server's
    read-exact path share."""
    if ftype == SUBMIT:
        return decode_submit(payload)
    if ftype == VERDICT:
        return decode_verdict(payload)
    if ftype in (REFUSAL, ERROR):
        return decode_json(payload)
    raise MalformedFrame("garbage", f"frame type {ftype:#x}")


# ---------------- streaming decoder ----------------

class FrameDecoder:
    """Incremental frame splitter: feed arbitrary byte chunks, get
    complete ``(type, payload, raw_len)`` frames out. Tear-proof by
    construction — partial bytes accumulate until the frame
    completes; the torn-frame fuzz corpus sweeps every split point.

    On any :class:`MalformedFrame` the decoder poisons itself
    (``dead=True``): a stream that has lost framing cannot be
    resynced safely, so every later ``feed`` raises the original
    error again. The transport must close the connection."""

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = int(max_frame_bytes)
        self.dead: Optional[MalformedFrame] = None
        self._buf = bytearray()

    @property
    def partial_bytes(self) -> int:
        """Bytes buffered toward an incomplete frame — the ingress
        server's mid-frame read-deadline trigger."""
        return len(self._buf)

    def feed(self, data) -> List[tuple]:
        """Buffer ``data`` and return every now-complete frame as
        ``(ftype, payload_bytes, frame_len)``."""
        if self.dead is not None:
            raise self.dead
        self._buf.extend(data)
        out: List[tuple] = []
        while True:
            if len(self._buf) < HEADER_LEN:
                return out
            ftype, length = _HDR.unpack_from(self._buf, 0)
            if ftype not in _TYPES:
                raise self._poison(MalformedFrame(
                    "garbage", f"frame type {ftype:#x}"))
            if length > self.max_frame_bytes:
                raise self._poison(MalformedFrame(
                    "oversize",
                    f"declared {length} > {self.max_frame_bytes}"))
            if len(self._buf) < HEADER_LEN + length:
                return out
            payload = bytes(self._buf[HEADER_LEN:HEADER_LEN + length])
            del self._buf[:HEADER_LEN + length]
            out.append((ftype, payload, HEADER_LEN + length))

    def feed_decoded(self, data) -> Iterator[tuple]:
        """``feed`` + ``decode_payload``: yields ``(ftype, decoded)``
        and poisons on a payload-level violation too."""
        for ftype, payload, _raw in self.feed(data):
            try:
                yield ftype, decode_payload(ftype, payload)
            except MalformedFrame as e:
                raise self._poison(e)

    def _poison(self, err: MalformedFrame) -> MalformedFrame:
        self.dead = err
        return err


def split_points(blob: bytes) -> range:
    """Every proper split point of an encoded frame sequence — the
    torn-frame fuzz corpus's iteration domain."""
    return range(1, len(blob))
