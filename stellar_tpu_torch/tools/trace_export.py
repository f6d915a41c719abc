"""Chrome ``trace_event`` exporter: the flight recorder
(:mod:`stellar_tpu_torch.utils.tracing`) as a JSON file that
chrome://tracing and Perfetto load directly: thread-named tracks, nested
begin/end span pairs, instant markers for events and still-open spans,
and counter tracks (``C`` events: each device's pipeline in-flight
state, each resolve's busy fraction, the cumulative transfer bytes) on
the spans' clock. It is the host's side of the timeline that
:mod:`stellar_tpu_torch.tools.trace_kernel_time` reads on the device.

Three sources:

* ``--url http://127.0.0.1:11626``: a running node's
  ``spans?format=chrome`` admin route; with ``--fleet`` the whole-fleet
  window (``spans?format=chrome&fleet=true``), each replica a process
  track on one clock;
* ``--fleet`` with no URL: a three-replica fleet in this process over an
  instant stub verifier (no device, no socket), exported by replica;
* neither: one synthetic resolve in this process,
  ``BatchVerifier(bucket_sizes=(64,)).compute_batch`` of 64 signatures on
  the card (the port has no host-only mode), and a scripted two-device
  pipeline window, so the counter tracks show busy, bubble and byte
  series.

``--out trace.json`` writes the file (default stdout); the last stderr
line counts the events by kind.

    python -m stellar_tpu_torch.tools.trace_export [--url URL] [--fleet]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def synthetic_pipeline_window() -> None:
    """Drive the pipeline profiler with a scripted two-device resolve
    (prep, staggered dispatches, deliveries; real clock, millisecond
    sleeps) so the exported trace carries busy/bubble counter tracks and
    a transfer-byte series without touching a device."""
    from stellar_tpu_torch.utils.timeline import pipeline_timeline

    tok = pipeline_timeline.begin("demo")
    with pipeline_timeline.host_phase(tok, "prep"):
        time.sleep(0.004)
    pipeline_timeline.note_dispatch(tok, 0)
    time.sleep(0.006)                       # dev1's queue-wait bubble
    pipeline_timeline.note_dispatch(tok, 1)
    with pipeline_timeline.host_phase(tok, "fetch"):
        time.sleep(0.005)
    pipeline_timeline.note_delivery(tok, 0)
    with pipeline_timeline.host_phase(tok, "fetch"):
        time.sleep(0.003)
    pipeline_timeline.note_delivery(tok, 1)
    pipeline_timeline.finish(tok, transfer={
        "round_trips": 2, "bytes_h2d": 4096, "bytes_d2h": 512,
        "redundant_constant_bytes": 0})


def synthetic_trace(device=None) -> dict:
    """The scripted pipeline window and one resolve of 64 signatures (8
    signers) through ``BatchVerifier.compute_batch`` on ``device`` (the
    card by default), trace IDs riding every row."""
    from stellar_tpu_torch.crypto import batch_verifier as bv
    from stellar_tpu_torch.crypto import ed25519_ref as ref
    from stellar_tpu_torch.utils import tracing

    synthetic_pipeline_window()
    pool = []
    for i in range(8):
        seed = bytes([i + 1]) * 32
        pk = ref.secret_to_public(seed)
        msg = b"trace-export-%d" % i
        pool.append((pk, msg, ref.sign(seed, msg)))
    items = [pool[i % len(pool)] for i in range(64)]
    v = bv.BatchVerifier(device=device, bucket_sizes=(64,))
    out = v.compute_batch(items, trace_ids=list(range(1, 65)))
    if not out.all():
        raise RuntimeError("the synthetic resolve's signatures did not "
                           "verify")
    return tracing.flight_recorder.to_chrome_trace()


def synthetic_fleet_trace() -> dict:
    """A three-replica fleet window in this process, exported with a
    process track a replica (``to_chrome_trace(by_replica=True)``)."""
    import numpy as np

    from stellar_tpu_torch.crypto import fleet as fleet_mod
    from stellar_tpu_torch.utils import tracing

    class _Instant:
        def submit(self, items, trace_ids=None):
            n = len(items)
            return lambda: np.ones(n, dtype=bool)

    tracing.flight_recorder.clear()
    synthetic_pipeline_window()
    fl = fleet_mod.FleetRouter(verifier=_Instant(), replicas=3).start()
    tkts = []
    for i in range(12):
        pk = bytes([(i * 29 + j) % 251 + 1 for j in range(32)])
        items = [(pk, b"fleettrace-%d-%d" % (i, k),
                  bytes([(i + k) % 251]) * 64) for k in range(2)]
        tkts.append(fl.submit(items, lane="bulk", tenant=f"t{i % 3}"))
    for t in tkts:
        t.result(timeout=30)
    fl.stop(drain=True, timeout=30)
    return tracing.flight_recorder.to_chrome_trace(by_replica=True)


def fetch_trace(url: str, fleet: bool = False) -> dict:
    import urllib.request
    route = "/spans?format=chrome" + ("&fleet=true" if fleet else "")
    with urllib.request.urlopen(
            url.rstrip("/") + route, timeout=10) as resp:
        return json.loads(resp.read().decode())


def event_counts(trace: dict) -> dict:
    """The trace's events in all, and its spans, instants and counter
    samples."""
    evs = trace.get("traceEvents", [])
    return {"events": len(evs),
            "spans": sum(1 for e in evs if e.get("ph") == "B"),
            "instants": sum(1 for e in evs if e.get("ph") == "i"),
            "counters": sum(1 for e in evs if e.get("ph") == "C")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url", default=None,
                    help="admin base URL of a running node "
                         "(default: synthetic local resolve)")
    ap.add_argument("--fleet", action="store_true",
                    help="whole-fleet window: per-replica process "
                         "tracks merged on one clock "
                         "(spans?format=chrome&fleet=true)")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)
    if args.url:
        trace = fetch_trace(args.url, fleet=args.fleet)
    elif args.fleet:
        trace = synthetic_fleet_trace()
    else:
        trace = synthetic_trace()
    text = json.dumps(trace)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    c = event_counts(trace)
    print(f"trace-export: {c['events']} events ({c['spans']} spans, "
          f"{c['instants']} instants, {c['counters']} counter "
          f"samples) -> {args.out or 'stdout'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
