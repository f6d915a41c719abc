"""The port's wire ingress on loopback, on the CPU.

A port ``IngressServer`` over a port ``VerifyService`` with stub
verifiers: round trips over a real loopback socket, typed refusals
rebuilt on the client, each wire fault shape killed with its typed
reason, the wire-extended conservation law, zero-loss drain on
``stop()``, the per-connection defenses and the host-buffer pool — the 14
cases of ``tests/test_ingress.py``. Then the two packages against each
other: a port ``WireClient`` against a reference ``IngressServer`` and a
reference ``WireClient`` against a port ``IngressServer``, with equal
verdicts and byte-identical refusal frames. Every server is stopped with a
timeout, every ``result()`` has one, and the slow-client case runs at a
short read deadline. No JAX program is compiled.
"""

import socket
import time

import numpy as np
import pytest

from stellar_tpu.crypto import batch_verifier as jbv
from stellar_tpu.crypto import ingress as jingress
from stellar_tpu.crypto import verify_service as jvs
from stellar_tpu.utils import faults as jfaults
from stellar_tpu.utils.resilience import Overloaded as JOverloaded
from stellar_tpu_torch.crypto import batch_verifier as bv
from stellar_tpu_torch.crypto import ingress
from stellar_tpu_torch.crypto import verify_service as vs
from stellar_tpu_torch.parallel import hostbuf
from stellar_tpu_torch.utils import faults, wire
from stellar_tpu_torch.utils.resilience import Overloaded

STOP_S = 10.0


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    faults.clear()
    jfaults.clear()
    for mod in (ingress, jingress):
        mod.register_ingress_health(None)
        with mod._health_lock:
            mod._server_ref = None
    bv.register_service_health(None)
    jbv.register_service_health(None)


class InstantVerifier:
    def submit(self, items, trace_ids=None):
        n = len(items)
        return lambda: np.ones(n, dtype=bool)


class EchoPkVerifier:
    """Verdict an item = (first pk byte is even): item bytes crossed the
    wire intact and the index alignment held."""

    def submit(self, items, trace_ids=None):
        out = np.asarray([pk[0] % 2 == 0 for pk, _m, _s in items])
        return lambda: out


def _items(i, n=3):
    pk = bytes([(i * 13 + j) % 251 + 1 for j in range(32)])
    return [(pk, b"i%d-%d" % (i, k), bytes([(i + k) % 251]) * 64)
            for k in range(n)]


def _serve(verifier=None, svc_mod=vs, ing_mod=ingress, **kw):
    svc = svc_mod.VerifyService(verifier=verifier or InstantVerifier(),
                                lane_depth=256, lane_bytes=10 ** 8,
                                max_batch=64).start()
    srv = ing_mod.IngressServer(svc, **kw).start()
    return svc, srv


def _close(cli, srv, svc):
    cli.close()
    srv.stop(timeout=STOP_S)
    svc.stop(timeout=STOP_S)


# ---------------- round trips ----------------


def test_wire_verdicts_round_trip_with_trace_block():
    svc, srv = _serve(EchoPkVerifier())
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        items = [(bytes([2] * 32), b"a", b"\x01" * 64),
                 (bytes([3] * 32), b"b", b"\x01" * 64),
                 (bytes([4] * 32), b"c", b"\x01" * 64)]
        tkt = cli.submit(items, lane="bulk", tenant="t0")
        assert tkt.result(timeout=30).tolist() == [True, False, True]
        assert tkt.trace_lo is not None and tkt.trace_lo > 0
    finally:
        _close(cli, srv, svc)


def test_many_interleaved_requests_correlate_by_req_id():
    svc, srv = _serve()
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        tkts = [cli.submit(_items(i, 1 + i % 4)) for i in range(40)]
        for i, tkt in enumerate(tkts):
            assert len(tkt.result(timeout=30)) == 1 + i % 4
        assert len({t.trace_lo for t in tkts}) == 40
    finally:
        _close(cli, srv, svc)


def test_unknown_lane_is_typed_refusal_not_dead_connection():
    svc, srv = _serve()
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        bad = cli.submit(_items(1), lane="latency")
        with pytest.raises(Overloaded) as ei:
            bad.result(timeout=30)
        assert (ei.value.kind, ei.value.reason) == ("rejected", "invalid")
        good = cli.submit(_items(2))
        assert len(good.result(timeout=30)) == 3
    finally:
        _close(cli, srv, svc)


def test_overload_refusal_rebuilds_typed_overloaded():
    svc = vs.VerifyService(verifier=InstantVerifier(), lane_depth=2,
                           lane_bytes=10 ** 8, max_batch=64)
    # not started: the queues take two and never drain; the short result
    # timeout turns the stranded tickets into ticketed failures at stop()
    svc._running = True
    srv = ingress.IngressServer(svc, result_timeout_s=1.0).start()
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        tkts = [cli.submit(_items(i, 1)) for i in range(12)]
        outcomes = {"refused": 0, "queued": 0}
        for tkt in tkts:
            try:
                tkt.result(timeout=0.5)
            except Overloaded as e:
                outcomes["refused"] += 1
                assert (e.kind, e.lane) == ("rejected", "bulk")
                assert len(list(e.trace_ids)) == 1
            except Exception:
                outcomes["queued"] += 1
        assert outcomes["refused"] >= 8
    finally:
        cli.close()
        srv.stop(timeout=STOP_S)
    assert srv.snapshot()["conservation_gap"] == 0


# ---------------- wire fault shapes ----------------


def test_torn_frames_from_faulty_client_still_verify():
    svc, srv = _serve()
    faults.set_fault("wire.t", "torn-frame")
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30,
                             fault_point="wire.t")
    try:
        for i in range(4):
            assert len(cli.submit(_items(i)).result(timeout=30)) == 3
        assert faults.counters()["wire.t"]["fired"] >= 4
        assert srv.snapshot()["malformed_frames"] == 0
    finally:
        _close(cli, srv, svc)


@pytest.mark.parametrize("mode,reason", [
    ("garbage-prefix", "garbage"),
    ("oversize-frame", "oversize"),
    ("disconnect-mid-batch", "disconnect")])
def test_fault_shapes_killed_with_typed_reason(mode, reason):
    svc, srv = _serve()
    faults.set_fault("wire.f", mode)
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30,
                             fault_point="wire.f")
    try:
        try:
            cli.submit(_items(1))
        except (ConnectionError, OSError):
            pass
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                not srv.snapshot()["malformed_reasons"].get(reason):
            time.sleep(0.05)
        snap = srv.snapshot()
        assert snap["malformed_reasons"].get(reason, 0) >= 1
        assert snap["conservation_gap"] == 0
    finally:
        _close(cli, srv, svc)


def test_slow_loris_killed_by_read_deadline_not_wedged():
    svc, srv = _serve(read_deadline_s=0.5)
    good = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    raw = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        blob = wire.encode_submit(_items(0), "bulk", None, 1)
        raw.sendall(blob[:7])      # header and 2 body bytes, then stall
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                not srv.snapshot()["malformed_reasons"].get("deadline"):
            assert len(good.submit(_items(1)).result(timeout=10)) == 3
        snap = srv.snapshot()
        assert snap["malformed_reasons"].get("deadline", 0) >= 1
        assert snap["deadline_kills"] >= 1
    finally:
        raw.close()
        _close(good, srv, svc)


def test_byte_budget_kills_connection():
    svc, srv = _serve(conn_byte_budget=600)
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        results = []
        for i in range(10):
            try:
                results.append(cli.submit(_items(i, 2)).result(timeout=10))
            except (ConnectionError, OSError, RuntimeError):
                break
        assert srv.snapshot()["budget_kills"] == 1
        assert 0 < len(results) < 10
    finally:
        _close(cli, srv, svc)


# ---------------- conservation and drain ----------------


def test_conservation_exact_under_mixed_outcomes():
    svc, srv = _serve()
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        tkts = [cli.submit(_items(i, 2)) for i in range(10)]
        tkts.append(cli.submit(_items(99), lane="latency"))
        for tkt in tkts:
            try:
                tkt.result(timeout=30)
            except Overloaded:
                pass
        snap = srv.snapshot()
        assert snap["conservation_gap"] == 0
        assert snap["items_decoded"] == 23
        assert (snap["accepted"], snap["refused"], snap["pending"]) == \
            (20, 3, 0)
    finally:
        _close(cli, srv, svc)


def test_stop_drains_every_admitted_ticket():
    class SlowVerifier:
        def submit(self, items, trace_ids=None):
            n = len(items)

            def resolve():
                time.sleep(0.05)
                return np.ones(n, dtype=bool)
            return resolve

    svc, srv = _serve(SlowVerifier())
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        tkts = [cli.submit(_items(i, 2)) for i in range(20)]
        time.sleep(0.1)
        srv.stop(timeout=STOP_S)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and \
                not all(t.done() for t in tkts):
            time.sleep(0.05)
        assert all(t.done() for t in tkts)
        resolved = 0
        for tkt in tkts:
            try:
                resolved += len(tkt.result(timeout=0))
            except Exception:
                pass   # a typed terminal either way
        snap = srv.snapshot()
        assert snap["pending"] == 0 and snap["conservation_gap"] == 0
        assert resolved == snap["resolved"] > 0
    finally:
        cli.close()
        svc.stop(timeout=STOP_S)


def test_health_surface_registration():
    assert ingress.ingress_health() == {"enabled": False}
    assert ingress.running_server() is None
    svc, srv = _serve()
    try:
        h = ingress.ingress_health()
        assert h["enabled"] is True and h["port"] == srv.port
        assert ingress.running_server() is srv
    finally:
        srv.stop(timeout=STOP_S)
        svc.stop(timeout=STOP_S)


# ---------------- host-buffer pool ----------------


def test_hostbuf_pool_reuses_and_overflows():
    pool = hostbuf.HostBufferPool(buffers=2, buf_bytes=64)
    a = pool.lease()
    b = pool.lease()
    assert pool.stats()["free"] == 0
    assert all(type(x.buf) is bytearray for x in (a, b))
    c = pool.lease()                      # overflow: an unpooled buffer
    assert pool.stats()["misses"] == 1
    pool.release(a)
    assert pool.stats()["free"] == 1
    a2 = pool.lease()
    assert a2.buf is a.buf
    pool.release(a2)
    pool.release(b)
    pool.release(c)
    assert pool.stats()["outstanding"] == 0
    with pytest.raises(RuntimeError):
        pool.release(c)


def test_hostbuf_refcount_holds_buffer_across_retain():
    pool = hostbuf.HostBufferPool(buffers=1, buf_bytes=64)
    lease = pool.lease()
    pool.retain(lease)                    # a frame's ticket holds it
    pool.release(lease)                   # the reader rotates away
    assert pool.stats()["free"] == 0
    pool.release(lease)                   # the ticket's terminal
    assert pool.stats()["free"] == 1
    with pytest.raises(RuntimeError):
        pool.retain(lease)


def test_lease_rotation_keeps_item_bytes_alive():
    """A tiny pool of tiny buffers forces lease rotation mid-connection;
    verdicts stay right because each frame's lease lives until its
    ticket resolves."""
    pool = hostbuf.HostBufferPool(buffers=2, buf_bytes=512)
    svc = vs.VerifyService(verifier=EchoPkVerifier(), lane_depth=256,
                           lane_bytes=10 ** 8, max_batch=64).start()
    srv = ingress.IngressServer(svc, max_frame_bytes=512, pool=pool).start()
    cli = ingress.WireClient("127.0.0.1", srv.port, timeout=30)
    try:
        for i in range(30):
            pk_even = bytes([2 + 2 * (i % 3)] * 32)
            pk_odd = bytes([3] * 32)
            tkt = cli.submit([(pk_even, b"x%d" % i, b"\x01" * 64),
                              (pk_odd, b"y%d" % i, b"\x01" * 64)])
            assert tkt.result(timeout=30).tolist() == [True, False]
        assert srv.snapshot()["pool"]["leases"] >= 10
    finally:
        _close(cli, srv, svc)


# ---------------- the two packages on one wire ----------------


def _mixed_run(client_mod, server_mod, svc_mod):
    """Echo verdicts over five frames, one unknown-lane refusal and one
    over-depth refusal, through ``client_mod``'s client and
    ``server_mod``'s server; returns the outcomes and the server's
    snapshot."""
    svc = svc_mod.VerifyService(verifier=EchoPkVerifier(), lane_depth=1,
                                lane_bytes=10 ** 8, max_batch=64)
    svc._running = True   # never started: the one queued ticket stays
    srv = server_mod.IngressServer(svc, result_timeout_s=1.0).start()
    cli = client_mod.WireClient("127.0.0.1", srv.port, timeout=30)
    outs = []
    try:
        tkts = [cli.submit(_items(1), lane="latency"),
                cli.submit(_items(2), lane="bulk", tenant="t0"),
                cli.submit(_items(3), lane="bulk", tenant="t0")]
        for tkt in tkts:
            try:
                outs.append(("verdicts", tkt.result(timeout=10).tolist()))
            except (Overloaded, JOverloaded) as e:
                outs.append((e.kind, e.lane, e.reason, e.tenant, e.replica,
                             len(e.trace_ids)))
            except RuntimeError as e:
                outs.append(("failed", type(e).__name__))
    finally:
        cli.close()
        srv.stop(timeout=STOP_S)
    snap = srv.snapshot()
    svc2 = svc_mod.VerifyService(verifier=EchoPkVerifier(), lane_depth=64,
                                 lane_bytes=10 ** 8, max_batch=64).start()
    srv2 = server_mod.IngressServer(svc2).start()
    cli2 = client_mod.WireClient("127.0.0.1", srv2.port, timeout=30)
    try:
        for i in range(5):
            items = [(bytes([2 + i] * 32), b"a%d" % i, b"\x01" * 64),
                     (bytes([5] * 32), b"b", b"\x01" * 64)]
            outs.append(("verdicts", cli2.submit(items, tenant="t1")
                         .result(timeout=30).tolist()))
    finally:
        _close(cli2, srv2, svc2)
    keys = ("frames_received", "decoded_frames", "items_decoded",
            "accepted", "refused", "resolved", "failed", "pending",
            "bytes_in", "conservation_gap")
    return outs, {k: snap[k] for k in keys}, srv2.snapshot()["bytes_out"]


def test_port_client_against_reference_server():
    got = _mixed_run(ingress, jingress, jvs)
    want = _mixed_run(jingress, jingress, jvs)
    assert got == want
    outs, snap, _bytes_out = got
    assert outs[0] == ("rejected", "latency", "invalid", None, None, 3)
    assert outs[1] == ("failed", "RuntimeError")
    assert outs[2] == ("rejected", "bulk", "queue-depth", "t0", None, 3)
    assert snap["conservation_gap"] == 0


def test_reference_client_against_port_server():
    got = _mixed_run(jingress, ingress, vs)
    want = _mixed_run(jingress, jingress, jvs)
    assert got == want
    assert got[0][3:] == [("verdicts", [i % 2 == 0, False])
                          for i in range(5)]


def test_refusal_frames_byte_identical_across_servers():
    """A port server and a reference server refuse the same frame (an
    unknown lane) with the same bytes, the trace block aside: canonical
    JSON of the same fields."""
    fields = ("kind", "lane", "reason", "tenant", "replica", "n", "message")
    frames = {}
    for name, (svc_mod, ing_mod) in {"reference": (jvs, jingress),
                                     "port": (vs, ingress)}.items():
        svc, srv = _serve(svc_mod=svc_mod, ing_mod=ing_mod)
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        try:
            sock.sendall(wire.encode_submit(_items(4), "latency", "t0", 9))
            dec = wire.FrameDecoder()
            out = []
            while not out:
                out = dec.feed(sock.recv(65536))
        finally:
            sock.close()
            srv.stop(timeout=STOP_S)
            svc.stop(timeout=STOP_S)
        (ftype, payload, _n), = out
        assert ftype == wire.REFUSAL
        d = wire.decode_json(payload)
        # the server's bytes are the canonical encoding of its fields
        assert wire.frame(ftype, payload) == wire.encode_refusal(
            9, trace_lo=d["trace_lo"], **{k: d[k] for k in fields})
        frames[name] = wire.encode_refusal(9, trace_lo=0,
                                           **{k: d[k] for k in fields})
    assert frames["port"] == frames["reference"]


def test_memoryview_messages_reach_every_consumer():
    """The ingress hands messages on as ``memoryview`` slices of a lease:
    the verifier's encode (the join and SHA-512 prep), the host oracle
    the audit runs, the pure-Python oracle, the service's shed digest and
    the node cache's key give the same answers as for ``bytes``."""
    from stellar_tpu_torch.crypto import ed25519_ref as ref
    from stellar_tpu_torch.crypto import keys, native_verify, vectors
    rng = np.random.default_rng(93)
    items = vectors.edge_corpus(rng)[:12] + vectors.valid_items(rng, 4)
    blob = wire.encode_submit(items, "bulk", None, 1)
    lease = hostbuf.HostBufferPool(buffers=1, buf_bytes=len(blob)).lease()
    lease.buf[:len(blob)] = blob
    _, _, _, viewed = wire.decode_submit(lease.mv[wire.HEADER_LEN:len(blob)])
    assert all(isinstance(m, memoryview) for _p, m, _s in viewed)
    w = bv.Ed25519Workload()
    gate_b, enc_b = w.encode(items)
    gate_v, enc_v = w.encode(viewed)
    np.testing.assert_array_equal(gate_b, gate_v)
    for a, b in zip(enc_b, enc_v):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native_verify.host_verify(items),
                                  native_verify.host_verify(viewed))
    assert [ref.verify(*it) for it in viewed] == \
        [ref.verify(*it) for it in items]
    assert [keys._cache_key(*it) for it in viewed] == \
        [keys._cache_key(*it) for it in items]
    svc_b = vs.VerifyService(verifier=InstantVerifier())
    svc_v = vs.VerifyService(verifier=InstantVerifier())
    for svc in (svc_b, svc_v):
        svc._running = True
    tb, tv = svc_b.submit(items), svc_v.submit(viewed)
    assert tb._digest == tv._digest and tb._nbytes == tv._nbytes
