"""TRANSFER_LEDGER_OK self-check: the transfer ledger and the
device-resident operand cache end to end on a CHAOS resolve — the port
of ``tools/transfer_selfcheck.py``.

A ``BatchHasher`` at bucket ``BUCKET`` over ``N_DEV`` device entries
(the card named four times, or ``["cpu"] * 4`` with ``--device cpu``)
hashes one corpus through K3, with ``flaky-device:0`` armed over the
measured window: every second launch attributed to entry 0 fails, and
the engine moves that part to another entry (the port has no host
failover). Three phases:

1. **detector** (resident cache OFF): two resolves of the SAME batch
   must record nonzero ``round_trips`` and nonzero
   ``redundant_constant_bytes`` — the redundancy instrument still
   convicts re-uploads while the cache hides them;
2. **resident** (cache ON; the chaos window): after one resolve that
   re-seeds the cache, re-resolving the batch must record
   ``resident_hits`` > 0 and ``redundant_constant_bytes`` == 0;
3. the ledger's byte totals over the run must RECONCILE (>=
   ``MIN_RECONCILE`` both ways) with the engine's own shape-derived
   ``shipped_bytes`` / ``fetched_bytes``; the ``crypto.transfer.*``
   counters must ride the Prometheus exposition; and every digest must
   be ``hashlib``'s through the flap.

The port's resident cache starts off (the reference's starts on): the
tool turns it on for its warm-up and its resident window, as the
reference's production default has it, and puts back the process's
setting after (``resident_cache`` in the record). The device breakers'
knobs go through the engine's ``health.configure`` (in the port they are
not ``configure_dispatch`` arguments). The ledger is read as deltas over
the tool's own run, so the check holds inside a process that dispatched
before it.

The top-level fields are the resident window's; ``detector`` carries the
cache-off evidence. Prints one JSON line; exit 0 only when every check
passed.

    python -m stellar_tpu_torch.tools.transfer_selfcheck [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

N_DEV = 4
BUCKET = 8
MIN_RECONCILE = 0.95


def _corpus(n: int):
    return [bytes(((7 * j + k) % 256) for k in range(40 + 13 * j))
            for j in range(n)]


def _ratio(a: int, b: int):
    if max(a, b) == 0:
        return None
    return min(a, b) / max(a, b)


def _delta(after: dict, before: dict, keys) -> dict:
    return {k: after[k] - before[k] for k in keys}


def run(device=None) -> dict:
    import hashlib

    from stellar_tpu_torch.crypto import batch_hasher as bh
    from stellar_tpu_torch.crypto import batch_verifier as bv
    from stellar_tpu_torch.parallel.residency import resident_cache
    from stellar_tpu_torch.utils import faults
    from stellar_tpu_torch.utils.device import resolve_device
    from stellar_tpu_torch.utils.metrics import registry
    from stellar_tpu_torch.utils.transfer_ledger import transfer_ledger

    dev = resolve_device(device)
    h = bh.BatchHasher(devices=[dev] * N_DEV, bucket_sizes=(BUCKET,))
    bv.configure_dispatch(
        deadline_ms=30_000, dispatch_retries=0,
        failure_threshold=8, backoff_min_s=0.3, backoff_max_s=0.6,
        audit_rate=0.25)
    h.health.configure(failure_threshold=2, backoff_min_s=0.2,
                       backoff_max_s=0.5)
    msgs = _corpus(BUCKET)
    want = [hashlib.sha256(m).digest() for m in msgs]

    def mismatched() -> int:
        return sum(1 for g, w in zip(h.hash_batch(msgs), want) if g != w)

    was_enabled = resident_cache.enabled
    start = transfer_ledger.totals()
    try:
        # warm: the first upload of this content seeds the cache
        resident_cache.configure(enabled=True)
        mismatches = mismatched()

        # ---- phase 1: detector, cache OFF ----
        resident_cache.configure(enabled=False)
        det_before = transfer_ledger.totals()
        try:
            for _ in range(2):
                mismatches += mismatched()
        finally:
            resident_cache.configure(enabled=True)
        detector = _delta(transfer_ledger.totals(), det_before,
                          ("round_trips", "bytes_h2d",
                           "redundant_constant_bytes",
                           "redundant_uploads"))
        detector["redundancy_frac"] = round(
            detector["redundant_constant_bytes"]
            / max(1, detector["bytes_h2d"]), 4)

        # ---- phase 2: resident steady state, cache ON, the chaos
        # window; the first resolve re-seeds the cache (turning it off
        # cleared it) ----
        mismatches += mismatched()
        before = transfer_ledger.totals()
        faults.set_fault(faults.DISPATCH, "flaky-device", 0)
        try:
            for _ in range(2):
                mismatches += mismatched()
        finally:
            fault_counters = faults.counters()
            faults.clear()
        after = transfer_ledger.totals()
        resident = resident_cache.snapshot()
    finally:
        resident_cache.configure(enabled=was_enabled)
    tallies = h.health_snapshot()
    shipped1, fetched1 = tallies["shipped_bytes"], tallies["fetched_bytes"]

    delta = _delta(after, before,
                   ("round_trips", "bytes_h2d", "bytes_d2h",
                    "device_puts", "fetches", "redundant_constant_bytes",
                    "redundant_uploads", "resident_hits",
                    "resident_bytes"))
    # reconciliation: the ledger over the whole run (warm, detector and
    # resident phases) against the engine's own accounting; resident
    # hits move zero bytes on either side
    run_h2d = after["bytes_h2d"] - start["bytes_h2d"]
    run_d2h = after["bytes_d2h"] - start["bytes_d2h"]
    rec_h2d = _ratio(run_h2d, shipped1)
    rec_d2h = _ratio(run_d2h, fetched1)
    reconciliation = min(x for x in (rec_h2d, rec_d2h)
                         if x is not None) \
        if (rec_h2d or rec_d2h) else None
    prom = registry.to_prometheus()

    problems = []
    if mismatches:
        problems.append(f"{mismatches} digests mismatched hashlib "
                        "under the flap")
    if detector["redundant_constant_bytes"] == 0:
        problems.append("cache-off re-ship recorded zero redundant "
                        "constant bytes — the redundancy detector "
                        "has rotted")
    if detector["round_trips"] == 0:
        problems.append("detector window recorded zero round trips")
    if delta["round_trips"] == 0:
        problems.append("chaos window recorded zero round trips")
    if delta["redundant_constant_bytes"] != 0:
        problems.append(
            "resident window re-shipped "
            f"{delta['redundant_constant_bytes']} redundant constant "
            "bytes — the device-resident cache is not absorbing "
            "re-uploads (constants must upload once per placement "
            "per process)")
    if delta["resident_hits"] == 0:
        problems.append("resident window recorded zero resident hits "
                        "— re-dispatched content did not ride the "
                        "cache")
    if delta["bytes_d2h"] == 0:
        problems.append(f"d2h byte accounting empty: {delta}")
    if reconciliation is None or reconciliation < MIN_RECONCILE:
        problems.append(
            f"ledger/engine byte reconciliation {reconciliation} < "
            f"{MIN_RECONCILE} (ledger h2d={run_h2d} vs engine "
            f"{shipped1}; d2h={run_d2h} vs {fetched1})")
    if not fault_counters.get(faults.DISPATCH, {}).get("fired"):
        problems.append("flaky-device:0 never fired — not a chaos "
                        "window")
    if "crypto_transfer_bytes_h2d" not in prom or \
            "crypto_transfer_resident_hits" not in prom:
        problems.append("transfer counters missing from the "
                        "Prometheus exposition")
    per_resolve = transfer_ledger.recent(2)
    if not per_resolve:
        problems.append("no per-resolve ledger records")

    return {
        "ok": not problems,
        "devices": N_DEV,
        "device": str(dev),
        "bucket": BUCKET,
        # steady-state (resident) window
        "round_trips": delta["round_trips"],
        "bytes_h2d": delta["bytes_h2d"],
        "bytes_d2h": delta["bytes_d2h"],
        "device_puts": delta["device_puts"],
        "fetches": delta["fetches"],
        "redundant_constant_bytes": delta["redundant_constant_bytes"],
        "redundant_uploads": delta["redundant_uploads"],
        "resident_hits": delta["resident_hits"],
        "resident_bytes": delta["resident_bytes"],
        "reconciliation": round(reconciliation, 4)
        if reconciliation is not None else None,
        "redundancy_frac": round(
            delta["redundant_constant_bytes"] /
            max(1, delta["bytes_h2d"]), 4)
        if delta["bytes_h2d"] else 0.0,
        "engine_shipped_bytes": shipped1,
        "engine_fetched_bytes": fetched1,
        "resident": resident,
        "resident_cache": {"on_in_windows": True,
                           "restored_to": was_enabled},
        # cache-off conviction evidence: the detector still works
        "detector": detector,
        "last_resolves": per_resolve,
        "workload": "sha256",
        "chaos": "flaky-device:0",
        "fault_counters": fault_counters,
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
