"""PIPELINE_OBS_OK self-check: the pipeline-bubble profiler end to end
on CHAOS resolves — the port of ``tools/pipeline_selfcheck.py``.

A ``BatchHasher`` at bucket ``BUCKET`` over ``N_DEV`` device entries
(the card named four times, or ``["cpu"] * 4`` with ``--device cpu``)
runs K3:

1. an INJECTED inter-dispatch stall (``stall-device:1``, a host sleep
   before entry 1's launch) must show as a BUBBLE of class
   ``queue_wait``, the largest bubble >= ``MIN_STALL_ATTRIBUTED`` of
   the stall, standing out above a clean resolve's own queue-wait
   floor;
2. an INJECTED transfer stall (``stall-transfer:1``, a sleep at the
   operand copy, not the launch) must ALSO land in ``queue_wait``,
   never in ``prep``, standing out above the same floor;
3. a resolve of ``PIPELINE_CHUNKS`` top-bucket chunks must measure
   ``overlap_frac`` >= ``MIN_OVERLAP`` (best of ``PIPELINE_TRIES``):
   chunk k+1's encode and padding run while chunk k is in flight, which
   the timeline counts from its launch to the delivery stamped at
   resolve. On the card the kernel runs behind the launch; on the CPU
   the plain version runs inside it, and the window from launch to
   delivery still holds the next chunks' encode, so the gate is taken
   on both (``overlap_gated``);
4. busy plus attributed bubbles must reconcile to >= ``MIN_RECONCILE``
   of devices x wall, the record's wall must agree with an independent
   clock, the ``crypto.pipeline.*`` metrics must ride the Prometheus
   exposition, the time-series ring must sample concurrently with the
   resolving engine without raising or tearing, and every digest must
   be ``hashlib``'s.

The device breakers' knobs go through the engine's ``health.configure``.
The top level carries the pipelined resolve's ``busy_frac``,
``overlap_frac`` and ``reconciliation``. Prints one JSON line; exit 0
only when every check passed.

    python -m stellar_tpu_torch.tools.pipeline_selfcheck [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

N_DEV = 4
BUCKET = 8
PIPELINE_CHUNKS = 6
STALL_S = 0.25
MIN_RECONCILE = 0.95
MIN_STALL_ATTRIBUTED = 0.8
# host prep hidden behind in-flight device work on a multi-chunk resolve
# (the structural floor with 6 chunks is about 5/6; 0.5 leaves room for
# a loaded host's first-chunk jitter)
MIN_OVERLAP = 0.5
PIPELINE_TRIES = 3


def _corpus(i: int, n: int):
    return [bytes(((7 * j + k + i) % 256)
                  for k in range(40 + 13 * j))
            for j in range(n)]


def run(device=None) -> dict:
    import hashlib

    from stellar_tpu_torch.crypto import batch_hasher as bh
    from stellar_tpu_torch.crypto import batch_verifier as bv
    from stellar_tpu_torch.utils import faults
    from stellar_tpu_torch.utils.device import resolve_device
    from stellar_tpu_torch.utils.metrics import registry, timeseries
    from stellar_tpu_torch.utils.timeline import pipeline_timeline

    dev = resolve_device(device)
    h = bh.BatchHasher(devices=[dev] * N_DEV, bucket_sizes=(BUCKET,))
    bv.configure_dispatch(
        deadline_ms=30_000, dispatch_retries=0,
        failure_threshold=8, backoff_min_s=0.3, backoff_max_s=0.6,
        audit_rate=0.25)
    h.health.configure(failure_threshold=4, backoff_min_s=0.2,
                       backoff_max_s=0.5)

    # concurrent time-series sampling: a hammer thread drives
    # sample_once and snapshot as fast as it can for the whole window
    ts_errors = []
    stop = threading.Event()

    def hammer():
        try:
            while not stop.is_set():
                timeseries.sample_once()
                snap = timeseries.snapshot(series="crypto.")
                for s in snap["series"].values():
                    # a torn series would show samples beyond its
                    # declared length
                    if len(s["samples"]) > max(s["n"], 1):
                        raise RuntimeError(f"torn series: {s}")
                # fast but not a busy loop: a spin holding the
                # interpreter lock would measure the hammer, not the
                # engine
                time.sleep(0.002)
        except Exception as e:  # surfaced as a problem below
            ts_errors.append(repr(e)[:200])
    t = threading.Thread(target=hammer, daemon=True, name="ts-hammer")
    t.start()

    def resolve(i, n=BUCKET):
        msgs = _corpus(i, n)
        want = [hashlib.sha256(m).digest() for m in msgs]
        t0 = time.perf_counter()
        got = h.hash_batch(msgs)
        wall_ms = (time.perf_counter() - t0) * 1000.0
        mism = sum(1 for g, w in zip(got, want) if g != w)
        return wall_ms, mism

    try:
        # warm: first use (its record is not measured)
        _, mismatches = resolve(0)
        # clean resolve: the stall detectors' noise floor
        _, m = resolve(1)
        mismatches += m
        clean = pipeline_timeline.recent(1)[-1]

        # ---- check 1: inter-dispatch stall (stall-device:1) ----
        faults.set_fault(faults.DISPATCH, "stall-device", 1,
                         seconds=STALL_S)
        try:
            stalled_wall_ms, m = resolve(2)
            mismatches += m
        finally:
            fault_counters = faults.counters()
            faults.clear()
        stalled = pipeline_timeline.recent(1)[-1]

        # ---- check 2: transfer stall (stall-transfer:1 at the
        # operand copy) — must land in queue_wait, never prep ----
        faults.set_fault(faults.TRANSFER, "stall-transfer", 1,
                         seconds=STALL_S)
        try:
            _, m = resolve(3)
            mismatches += m
        finally:
            xfer_counters = faults.counters()
            faults.clear()
        xfer_stalled = pipeline_timeline.recent(1)[-1]

        # ---- check 3: the pipelined loop over PIPELINE_CHUNKS chunks,
        # best of PIPELINE_TRIES ----
        pipelined = None
        for i in range(PIPELINE_TRIES):
            _, m = resolve(10 + i, n=BUCKET * PIPELINE_CHUNKS)
            mismatches += m
            rec = pipeline_timeline.recent(1)[-1]
            if pipelined is None or \
                    (rec["overlap_frac"] or 0.0) > \
                    (pipelined["overlap_frac"] or 0.0):
                pipelined = rec
    finally:
        stop.set()
        t.join(timeout=10)
    ts_snap = timeseries.snapshot(series="crypto.pipeline")

    stall_ms = STALL_S * 1000.0
    prom = registry.to_prometheus()
    wall_agreement = (min(stalled["wall_ms"], stalled_wall_ms)
                      / max(stalled["wall_ms"], stalled_wall_ms, 1e-9))

    problems = []
    if mismatches:
        problems.append(f"{mismatches} digests mismatched hashlib")
    if t.is_alive():
        problems.append("the time-series hammer did not stop")
    if stalled["n_devices"] < 2 or stalled["delivered"] == 0:
        problems.append(
            f"stalled resolve saw {stalled['n_devices']} devices / "
            f"{stalled['delivered']} deliveries — hooks not firing")
    if stalled["largest_bubble_class"] != "queue_wait":
        problems.append(
            "injected inter-dispatch stall attributed to "
            f"{stalled['largest_bubble_class']!r}, expected "
            "'queue_wait' (the delayed device waiting for its "
            "dispatch)")
    if stalled["largest_bubble_ms"] < MIN_STALL_ATTRIBUTED * stall_ms:
        problems.append(
            f"largest bubble {stalled['largest_bubble_ms']}ms < "
            f"{MIN_STALL_ATTRIBUTED:.0%} of the injected "
            f"{stall_ms:.0f}ms stall")
    # differential: each stall must stand out above the clean resolve's
    # own queue-wait floor
    excess = (stalled["bubbles"]["queue_wait"]
              - clean["bubbles"]["queue_wait"])
    if excess < MIN_STALL_ATTRIBUTED * stall_ms:
        problems.append(
            f"stalled-vs-clean queue_wait excess {excess:.1f}ms < "
            f"{MIN_STALL_ATTRIBUTED:.0%} of the injected "
            f"{stall_ms:.0f}ms stall — the stall did not stand out "
            "above the noise floor")
    xfer_excess = (xfer_stalled["bubbles"]["queue_wait"]
                   - clean["bubbles"]["queue_wait"])
    if xfer_excess < MIN_STALL_ATTRIBUTED * stall_ms:
        problems.append(
            f"transfer-stall queue_wait excess {xfer_excess:.1f}ms < "
            f"{MIN_STALL_ATTRIBUTED:.0%} of the injected "
            f"{stall_ms:.0f}ms upload stall — h2d delay not "
            "attributed as queue_wait")
    if xfer_stalled["largest_bubble_class"] != "queue_wait":
        problems.append(
            "injected h2d transfer stall attributed to "
            f"{xfer_stalled['largest_bubble_class']!r}, expected "
            "'queue_wait' (the host was moving bytes, not encoding "
            "— a 'prep' verdict would hide slow transfer lanes)")
    if stalled["reconciliation"] is None or \
            stalled["reconciliation"] < MIN_RECONCILE:
        problems.append(
            f"busy+bubble reconciliation {stalled['reconciliation']} "
            f"< {MIN_RECONCILE}")
    if wall_agreement < MIN_RECONCILE:
        problems.append(
            f"record wall {stalled['wall_ms']}ms disagrees with the "
            f"independently measured {stalled_wall_ms:.1f}ms "
            f"(agreement {wall_agreement:.3f} < {MIN_RECONCILE})")
    if pipelined["parts"] < 2 * stalled["n_devices"] or \
            pipelined["delivered"] == 0:
        problems.append(
            f"pipelined resolve dispatched {pipelined['parts']} "
            "parts — not a multi-sub-chunk window")
    if pipelined["overlap_frac"] is None or \
            pipelined["overlap_frac"] < MIN_OVERLAP:
        problems.append(
            f"pipelined overlap_frac {pipelined['overlap_frac']} < "
            f"{MIN_OVERLAP} — chunk k+1's prep is not hiding behind "
            "chunk k's in-flight device work")
    if pipelined["reconciliation"] is None or \
            pipelined["reconciliation"] < MIN_RECONCILE:
        problems.append(
            "pipelined busy+bubble reconciliation "
            f"{pipelined['reconciliation']} < {MIN_RECONCILE}")
    if not fault_counters.get(faults.DISPATCH, {}).get("fired"):
        problems.append("stall-device:1 never fired — nothing was "
                        "injected")
    if not xfer_counters.get(faults.TRANSFER, {}).get("fired"):
        problems.append("stall-transfer:1 never fired — the h2d "
                        "upload point is not planted")
    if "crypto_pipeline_resolves" not in prom or \
            "crypto_pipeline_bubble_ms" not in prom:
        problems.append("crypto.pipeline.* metrics missing from the "
                        "Prometheus exposition")
    if ts_errors:
        problems.append("time-series sampling under load raised: "
                        + "; ".join(ts_errors[:3]))
    if ts_snap["sampling"]["ticks"] == 0:
        problems.append("time-series ring never sampled during the "
                        "window")

    return {
        "ok": not problems,
        "devices": N_DEV,
        "device": str(dev),
        "bucket": BUCKET,
        # the pipelined multi-chunk resolve's values (a deliberate stall
        # never poisons these: the stall phases report below)
        "busy_frac": pipelined["busy_frac"],
        "overlap_frac": pipelined["overlap_frac"],
        "overlap_gated": True,
        "reconciliation": pipelined["reconciliation"],
        "bubbles": pipelined["bubbles"],
        "largest_bubble_ms": pipelined["largest_bubble_ms"],
        "largest_bubble_class": pipelined["largest_bubble_class"],
        "wall_ms": pipelined["wall_ms"],
        "chunks": PIPELINE_CHUNKS,
        "clean": {
            "busy_frac": clean["busy_frac"],
            "overlap_frac": clean["overlap_frac"],
            "reconciliation": clean["reconciliation"],
            "queue_wait_ms": clean["bubbles"]["queue_wait"],
            "wall_ms": clean["wall_ms"],
        },
        "stall": {
            "injected_ms": stall_ms,
            "largest_bubble_ms": stalled["largest_bubble_ms"],
            "largest_bubble_class": stalled["largest_bubble_class"],
            "queue_wait_ms": stalled["bubbles"]["queue_wait"],
            "prep_bubble_ms": stalled["bubbles"]["prep"],
            "reconciliation": stalled["reconciliation"],
            "wall_agreement": round(wall_agreement, 4),
            "busy_frac": stalled["busy_frac"],
            "queue_wait_excess_ms": round(excess, 3),
        },
        "stall_transfer": {
            "injected_ms": stall_ms,
            "largest_bubble_class":
                xfer_stalled["largest_bubble_class"],
            "queue_wait_ms": xfer_stalled["bubbles"]["queue_wait"],
            "prep_bubble_ms": xfer_stalled["bubbles"]["prep"],
            "queue_wait_excess_ms": round(xfer_excess, 3),
        },
        "totals": pipeline_timeline.totals(),
        "timeseries": {"ticks": ts_snap["sampling"]["ticks"],
                       "series": len(ts_snap["series"])},
        "chaos": f"stall-device:1 + stall-transfer:1 ({STALL_S}s)",
        "workload": "sha256",
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda[:N] (default: the first card) or cpu")
    args = ap.parse_args(argv)
    rec = run(args.device)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
