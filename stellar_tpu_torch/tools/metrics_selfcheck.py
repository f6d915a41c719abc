"""METRICS_EXPORT_OK self-check: the observability surface end to end
on one real resolve — the port of ``tools/metrics_selfcheck.py``.

1. runs one span-instrumented ``BatchVerifier.verify_batch`` of
   ``N_SIGS`` signatures from 8 signers: on the card, or through the
   plain versions with ``--device cpu``. The port has no host-only
   mode, so the reference's synthetic host resolve is a real one here.
   The signer-table cache keeps the process's setting, as the
   reference's does: with it on (the default), each signer's first
   sight builds its table in the ``prep`` phase and rides K1, and its
   repeats ride K2. The 8 signers are evicted from the cache first, so
   the call starts from the reference's fresh process;
2. asserts the per-phase span sum reconciles to >= ``MIN_COVERAGE`` of
   the blocking root span, with every phase of
   ``batch_verifier.RESOLVE_PHASES`` present in the breakdown
   (``verify.host_fallback`` at count 0: the port never opens it) and
   the root recorded once;
3. renders the registry's Prometheus text exposition and parses every
   sample line back, requiring the histograms of the phases the resolve
   ran: the root, ``prep``, ``bucket``, ``dispatch`` and ``fetch``.

Prints one JSON line with the reference's keys and the device; exit 0
only when every gate passed.

    python -m stellar_tpu_torch.tools.metrics_selfcheck [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

MIN_COVERAGE = 0.95
N_SIGS = 64

# one exposition sample: name, optional {labels}, numeric value
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" [-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|inf|nan)$")

# the span histograms the resolve must export: the root and the phases a
# dispatched chunk always runs (``audit`` only when a row is sampled)
_EXPORTED = ("verify.blocking", "verify.prep", "verify.bucket",
             "verify.dispatch", "verify.fetch")


def signer_pool():
    """The resolve's 8 signers, one signed message each:
    ``(pk, msg, sig)`` triples."""
    from stellar_tpu_torch.crypto import ed25519_ref as ref
    pool = []
    for i in range(8):
        seed = bytes([i + 1]) * 32
        pk = ref.secret_to_public(seed)
        msg = b"metrics-selfcheck-%d" % i
        pool.append((pk, msg, ref.sign(seed, msg)))
    return pool


def synthetic_resolve(device=None):
    """One resolve of ``N_SIGS`` signatures from 8 signers on ``device``
    (the card by default): ``(attribution, wall ms, verifier)``."""
    from stellar_tpu_torch.crypto import batch_verifier as bv
    from stellar_tpu_torch.parallel import signer_tables
    from stellar_tpu_torch.utils import tracing

    pool = signer_pool()
    for pk, _msg, _sig in pool:
        signer_tables.signer_table_cache.evict(pk)
    items = [pool[i % len(pool)] for i in range(N_SIGS)]
    v = bv.BatchVerifier(device=device, bucket_sizes=(N_SIGS,))
    before = tracing.span_totals()
    t0 = time.perf_counter()
    out = v.verify_batch(items)
    wall_ms = (time.perf_counter() - t0) * 1000.0
    if not out.all():
        raise RuntimeError("self-check signatures must verify")
    att = bv.dispatch_attribution(before, tracing.span_totals(), reps=1)
    return att, wall_ms, v


def check_attribution(att) -> list:
    from stellar_tpu_torch.crypto import batch_verifier as bv
    problems = []
    phases = att.get("phases", {})
    missing = [p for p in bv.RESOLVE_PHASES if p not in phases]
    if missing:
        problems.append(f"phases missing from breakdown: {missing}")
    fallback = phases.get("verify.host_fallback", {}).get("count")
    if fallback != 0:
        problems.append(f"verify.host_fallback counted {fallback} (the "
                        "port has no host failover: must be 0)")
    cov = att.get("coverage")
    if cov is None or cov < MIN_COVERAGE:
        problems.append(
            f"span sum covers {cov} of the blocking root span "
            f"(need >= {MIN_COVERAGE})")
    if att.get("blocking_span_count") != 1:
        problems.append("blocking root span did not record exactly "
                        f"once: {att.get('blocking_span_count')}")
    return problems


def check_prometheus() -> tuple:
    from stellar_tpu_torch.utils.metrics import _prom_name, registry
    text = registry.to_prometheus()
    problems = []
    bad = [ln for ln in text.splitlines()
           if ln and not ln.startswith("#")
           and not _PROM_SAMPLE.match(ln)]
    if bad:
        problems.append(f"unparseable exposition lines: {bad[:5]}")
    for phase in _EXPORTED:
        base = _prom_name(f"span.{phase}")
        if f"{base}_ms_count" not in text:
            problems.append(f"span histogram {base} missing from "
                            "exposition")
    return len(text.splitlines()), problems


def run(device=None, engines=None) -> dict:
    """The checks on ``device`` (the card by default); the verifier the
    resolve ran on is appended to ``engines`` when a list is given, for a
    caller that reads its health after."""
    att, wall_ms, v = synthetic_resolve(device)
    if engines is not None:
        engines.append(v)
    problems = check_attribution(att)
    prom_lines, prom_problems = check_prometheus()
    problems += prom_problems
    return {
        "ok": not problems,
        "coverage": att.get("coverage"),
        "blocking_wall_ms": round(wall_ms, 3),
        "span_sum_per_rep_ms": att.get("span_sum_per_rep_ms"),
        "prometheus_lines": prom_lines,
        "device": str(v.device),
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
