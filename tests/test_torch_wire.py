"""The port's wire frame codec against the reference's, on the CPU.

For the same inputs the port's frames equal the reference's byte for
byte, each package decodes the other's frames, a ``FrameDecoder`` fed at
every ``split_points`` cut yields the same frames in both, and
``MalformedFrame`` carries the same reasons. Pure bytes: no sockets, no
threads, no JAX. This covers the 13 cases of ``tests/test_wire.py``.
"""

import pytest

from stellar_tpu.utils import wire as jwire
from stellar_tpu_torch.utils import wire as pwire

CODECS = {"reference": jwire, "port": pwire}


def _items(i, n=3, pk_len=32, sig_len=64):
    pk = bytes([(i * 13 + j) % 251 + 1 for j in range(pk_len)])
    return [(pk, b"w%d-%d" % (i, k) * (k + 1),
             bytes([(i + k) % 251]) * sig_len) for k in range(n)]


def _frames(codec, blob):
    return [(t, bytes(p), n) for t, p, n in codec.FrameDecoder().feed(blob)]


def _blob(codec):
    return (codec.encode_submit(_items(0, 2), "bulk", None, 1)
            + codec.encode_verdict(1, 40, [1, 0])
            + codec.encode_refusal(2, kind="rejected", lane="bulk",
                                   reason="queue-depth", tenant="t0",
                                   replica=0, trace_lo=42, n=2)
            + codec.encode_error("deadline"))


def _plain(items):
    return [(bytes(p), bytes(m), bytes(s)) for p, m, s in items]


def test_constants_equal_the_reference():
    for name in ("SUBMIT", "VERDICT", "REFUSAL", "ERROR", "HEADER_LEN",
                 "PK_LEN", "SIG_LEN", "MAX_FRAME_BYTES"):
        assert getattr(pwire, name) == getattr(jwire, name), name
    assert pwire._HDR.format == jwire._HDR.format
    assert list(pwire.split_points(b"abcd")) == \
        list(jwire.split_points(b"abcd"))


@pytest.mark.parametrize("lane,tenant", [
    ("bulk", None), ("scp", "t0"), ("auth", "tenant-with-a-name")])
def test_submit_bytes_equal_and_cross_decode(lane, tenant):
    items = _items(3, 5)
    blob = pwire.encode_submit(items, lane, tenant, req_id=77)
    assert blob == jwire.encode_submit(items, lane, tenant, req_id=77)
    for enc in CODECS.values():
        for dec in CODECS.values():
            (ftype, payload, raw_len), = _frames(
                dec, enc.encode_submit(items, lane, tenant, req_id=77))
            assert ftype == dec.SUBMIT and raw_len == len(blob)
            req_id, got_lane, got_tenant, got = dec.decode_submit(payload)
            assert (req_id, got_lane, got_tenant) == (77, lane, tenant)
            assert _plain(got) == _plain(items)


def test_submit_noncanonical_key_lengths_ride_the_wire():
    items = [(b"\x01" * 31, b"short", b"\x02" * 64),
             (b"", b"empty", b""),
             (b"\x03" * 255, b"long", b"\x04" * 255)]
    blob = pwire.encode_submit(items, "bulk", None, 5)
    assert blob == jwire.encode_submit(items, "bulk", None, 5)
    for codec in CODECS.values():
        _, _, _, got = codec.decode_submit(_frames(codec, blob)[0][1])
        assert _plain(got) == items


def test_submit_rejects_unencodable_alike():
    for codec in CODECS.values():
        with pytest.raises(ValueError):
            codec.encode_submit([(b"\x01" * 256, b"m", b"\x02" * 64)])
        with pytest.raises(ValueError):
            codec.encode_submit(_items(0, 1), lane="x" * 256)
        with pytest.raises(ValueError):
            codec.encode_submit(_items(0, 1) * 65536)


def test_verdict_bytes_equal_and_cross_decode():
    for verdicts in ([1, 0, 1, 1], [], [True] * 300):
        blob = pwire.encode_verdict(9, 12345, verdicts)
        assert blob == jwire.encode_verdict(9, 12345, verdicts)
        for codec in CODECS.values():
            req_id, trace_lo, got = codec.decode_verdict(
                _frames(codec, blob)[0][1])
            assert (req_id, trace_lo) == (9, 12345)
            assert got == [bool(v) for v in verdicts]


def test_refusal_and_error_bytes_equal_and_cross_decode():
    kw = dict(kind="shed", lane="bulk", reason="queue-depth", tenant="t1",
              replica=2, trace_lo=100, n=8, message="m")
    blob = pwire.encode_refusal(4, **kw)
    assert blob == jwire.encode_refusal(4, **kw)
    err = pwire.encode_error("garbage", "det")
    assert err == jwire.encode_error("garbage", "det")
    for codec in CODECS.values():
        assert codec.decode_json(_frames(codec, blob)[0][1]) == \
            dict(kw, req_id=4)
        assert codec.decode_json(_frames(codec, err)[0][1]) == \
            {"reason": "garbage", "detail": "det"}


def test_refusal_encoding_is_canonical():
    kw = dict(kind="rejected", lane="scp", reason="stopped", tenant=None,
              replica=1, trace_lo=7, n=3, message="x")
    b = pwire.encode_refusal(9, **kw)
    assert b == pwire.encode_refusal(9, **kw) == jwire.encode_refusal(9, **kw)
    payload = _frames(pwire, b)[0][1]
    assert b" " not in payload and payload.find(b'"kind"') < \
        payload.find(b'"lane"') < payload.find(b'"message"')


# ---------------- torn frames ----------------


def test_torn_frames_decode_identically_at_every_split():
    blob = _blob(pwire)
    assert blob == _blob(jwire)
    whole = [(t, p) for t, p, _ in _frames(jwire, blob)]
    assert len(whole) == 4
    for cut in pwire.split_points(blob):
        for codec in CODECS.values():
            dec = codec.FrameDecoder()
            out = dec.feed(blob[:cut]) + dec.feed(blob[cut:])
            assert [(t, bytes(p)) for t, p, _ in out] == whole, \
                f"split at byte {cut} diverged"
            assert dec.dead is None and dec.partial_bytes == 0


def test_torn_byte_at_a_time_and_decoded_payloads():
    blob = _blob(pwire)
    got = {}
    for name, codec in CODECS.items():
        dec = codec.FrameDecoder()
        out = []
        for i in range(len(blob)):
            for ftype, decoded in dec.feed_decoded(blob[i:i + 1]):
                if ftype == codec.SUBMIT:
                    decoded = decoded[:3] + (_plain(decoded[3]),)
                out.append((ftype, decoded))
        got[name] = out
    assert got["port"] == got["reference"] and len(got["port"]) == 4


@pytest.mark.parametrize("junk", [0x00, 0x05, 0x7f, 0xff])
def test_garbage_prefix_is_typed_and_poisons(junk):
    for codec in CODECS.values():
        dec = codec.FrameDecoder()
        with pytest.raises(codec.MalformedFrame) as ei:
            dec.feed(bytes([junk]) + _blob(codec))
        assert ei.value.reason == "garbage"
        assert dec.dead is ei.value
        with pytest.raises(codec.MalformedFrame):
            dec.feed(_blob(codec))
    assert str(pwire.MalformedFrame("garbage", "d")) == \
        str(jwire.MalformedFrame("garbage", "d"))


def test_oversize_declaration_refused_without_buffering():
    for codec in CODECS.values():
        dec = codec.FrameDecoder()
        with pytest.raises(codec.MalformedFrame) as ei:
            dec.feed(codec._HDR.pack(codec.SUBMIT,
                                     codec.MAX_FRAME_BYTES + 1))
        assert ei.value.reason == "oversize"
        assert dec.partial_bytes <= codec.HEADER_LEN


def test_truncated_submit_payloads_give_the_same_reasons():
    blob = pwire.encode_submit(_items(2, 3), "scp", "t9", 6)
    payload = _frames(pwire, blob)[0][1]

    def outcome(codec, data):
        try:
            r = codec.decode_submit(data)
            return ("ok", r[:3], _plain(r[3]))
        except codec.MalformedFrame as e:
            assert e.reason in ("truncated-item", "trailing-bytes")
            return ("malformed", e.reason, str(e))

    for cut in range(len(payload)):
        assert outcome(pwire, payload[:cut]) == \
            outcome(jwire, payload[:cut]), cut
    assert outcome(pwire, payload + b"\x00") == \
        outcome(jwire, payload + b"\x00") == \
        ("malformed", "trailing-bytes", outcome(pwire, payload + b"\x00")[2])


def test_feed_decoded_poisons_on_payload_violation():
    for codec in CODECS.values():
        dec = codec.FrameDecoder()
        bad = codec.frame(codec.VERDICT, b"\x00\x01")
        with pytest.raises(codec.MalformedFrame) as ei:
            list(dec.feed_decoded(bad))
        assert ei.value.reason == "truncated-item"
        assert dec.dead is not None
        with pytest.raises(codec.MalformedFrame) as ei:
            list(codec.FrameDecoder().feed_decoded(
                codec.frame(codec.ERROR, b"{not json")))
        assert ei.value.reason == "bad-json"


def test_decode_submit_zero_copy_slices():
    blob = pwire.encode_submit(_items(1, 2), "bulk", None, 3)
    buf = bytearray(blob)
    payload = memoryview(buf)[pwire.HEADER_LEN:]
    _, _, _, items = pwire.decode_submit(payload)
    assert all(isinstance(m, memoryview) for _, m, _ in items)
    assert all(isinstance(p, bytes) and isinstance(s, bytes)
               for p, _, s in items)
    assert bytes(items[0][1]) == b"w1-0"
    buf[buf.index(b"w1-0"[0])] ^= 0xFF
    assert bytes(items[0][1]) != b"w1-0"
