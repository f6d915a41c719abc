"""HOT_SIGNER_OK self-check: the hot-signer partition end to end — the
port of ``tools/hot_signer_selfcheck.py``.

A ``BatchVerifier`` at bucket ``BUCKET`` over ``N_DEV`` device entries
(the card named four times, or ``["cpu"] * 4`` with ``--device cpu``;
sub-chunks of ``SUB`` rows) runs K1 for first sights and K2 for repeats:

1. **ledger delta**: the plain versions' multiply ledger
   (``tools/kernel_cost.py`` ``trace_stages(128)["dsm"]``) must show the
   hot arm >= 20% under the cold one;
2. **zipf replicas**: a stream over ``N_SIGNERS`` distinct signers (6
   first sights and 2 zipf-head repeats a batch; two invalid rows in
   batch 0), run twice from an empty table cache (replica A / B), must
   give identical verdict streams and identical hot/cold partition
   tallies, every verdict the ``ed25519_ref`` oracle's;
3. **build and launch-shape reuse**: the sweep builds and loads no
   kernel library (``ops/_build.py`` ``loaded_libraries``), and every K1
   and K2 launch is at the sub-chunk's ``SUB`` rows. The port has no
   per-shape executable to count and no donated operand (the
   ``donate`` list is empty);
4. **zero redundant bytes**: with the resident cache on, steady-state
   re-dispatches of the cached zipf head ship zero redundant constant
   bytes, with resident hits > 0, and the transfer ledger reconciles
   (>= ``MIN_RECONCILE``) with the engine's own byte tallies;
5. **eviction under pressure**: a 10-table budget forces LRU evictions
   while the zipf head keeps hitting, every verdict still the oracle's.

Each replica starts from ``batch_engine._reset_dispatch_state_for_
testing()`` and an explicit reset of the signer-table cache (the port's
engine reset leaves that cache alone). The port's resident cache starts
off: check 4 turns it on, as the reference's production default has it,
and puts back the process's setting after (``resident_cache`` in the
record). ``--signers`` lowers ``N_SIGNERS`` (at least 12: two batches
and more tables than the pressure budget) for a run on the CPU.

Prints one JSON line; exit 0 only when every check passed.

    python -m stellar_tpu_torch.tools.hot_signer_selfcheck
        [--device cpu] [--signers N]
"""

from __future__ import annotations

import argparse
import json
import sys

N_DEV = 4
BUCKET = 8
SUB = BUCKET // N_DEV
N_SIGNERS = 1008          # > 1000: the acceptance floor
FRESH_PER_BATCH = 6       # 6 first-sight + 2 zipf-head rows per batch
HOT_HEAD = 8              # the zipf head the repeats draw from
MIN_RECONCILE = 0.95
PRESSURE_TABLES = 10
MIN_SIGNERS = 2 * FRESH_PER_BATCH


def _tally_launches(plugin, rows: dict) -> None:
    """Count the rows of every launch of ``plugin``'s kernel into
    ``rows`` ({rows: launches}): its ``kernel_fn`` is wrapped on this
    instance only, so no other engine pays for the count."""
    kernel_fn = plugin.kernel_fn

    def counted():
        kernel = kernel_fn()

        def launch(*ops):
            n = int(ops[0].shape[0])
            rows[n] = rows.get(n, 0) + 1
            return kernel(*ops)
        return launch
    plugin.kernel_fn = counted


def _corpus(n_signers: int = N_SIGNERS):
    """``n_signers`` distinct signers, one signed message each, with the
    oracle verdict of every row; two structured invalid rows ride in
    the zipf head, so gate-decided rows flow through the partition
    too."""
    import numpy as np

    from stellar_tpu_torch.crypto import ed25519_ref as ref
    pool = []
    for i in range(n_signers):
        seed = (i + 1).to_bytes(4, "little") * 8
        pk = ref.secret_to_public(seed)
        msg = b"hot-selfcheck-%d" % i
        pool.append((pk, msg, ref.sign(seed, msg)))
    pk0, m0, s0 = pool[0]
    pool.append((pk0, m0 + b"!", s0))     # tampered message
    pool.append((pk0[:31], m0, s0))       # bad pk length
    want = np.array([ref.verify(p, m, s) for p, m, s in pool])
    return pool, want


def _batches(n_signers: int = N_SIGNERS):
    """The deterministic zipf-flavored batch stream: every batch carries
    ``FRESH_PER_BATCH`` first sights plus repeats drawn from the zipf
    head; the two invalid rows ride batch 0's head slots."""
    batches = []
    for b in range(n_signers // FRESH_PER_BATCH):
        idx = [b * FRESH_PER_BATCH + j for j in range(FRESH_PER_BATCH)]
        for j in range(BUCKET - FRESH_PER_BATCH):
            if b == 0:
                idx.append(n_signers + j)          # invalid rows
            else:
                idx.append((b * 3 + j * 5) % HOT_HEAD)
        batches.append(idx)
    return batches


def _run_stream(v, pool, want, batches):
    """One replica pass: every batch resolved; the concatenated verdict
    stream and the pass's partition and cache tallies."""
    import numpy as np

    from stellar_tpu_torch.parallel import signer_tables
    from stellar_tpu_torch.utils.metrics import registry
    hot0 = registry.meter("crypto.verify.signer_table.hot_rows").count
    cold0 = registry.meter("crypto.verify.signer_table.cold_rows").count
    got, exp = [], []
    for idx in batches:
        got.append(v.verify_batch([pool[k] for k in idx]))
        exp.append(want[idx])
    st = signer_tables.signer_table_cache.snapshot()
    return {
        "verdicts": np.concatenate(got),
        "expected": np.concatenate(exp),
        "hot_rows": registry.meter(
            "crypto.verify.signer_table.hot_rows").count - hot0,
        "cold_rows": registry.meter(
            "crypto.verify.signer_table.cold_rows").count - cold0,
        "hits": st["hits"],
        "misses": st["misses"],
        "installs": st["installs"],
        "entries": st["entries"],
    }


def _ratio(a, b):
    return min(a, b) / max(a, b) if max(a, b) else None


def run(device=None, n_signers: int = N_SIGNERS, engines=None) -> dict:
    """The checks on ``device`` (the card by default) over ``n_signers``
    signers; the verifier they ran on is appended to ``engines`` when a
    list is given, for a caller that reads its health after."""
    import numpy as np

    from stellar_tpu_torch.crypto import batch_verifier as bv
    from stellar_tpu_torch.ops import _build
    from stellar_tpu_torch.parallel import batch_engine, signer_tables
    from stellar_tpu_torch.parallel.residency import resident_cache
    from stellar_tpu_torch.tools import kernel_cost
    from stellar_tpu_torch.utils.device import resolve_device
    from stellar_tpu_torch.utils.metrics import registry
    from stellar_tpu_torch.utils.transfer_ledger import transfer_ledger

    if n_signers < MIN_SIGNERS:
        raise ValueError(f"--signers must be at least {MIN_SIGNERS}")
    dev = resolve_device(device)
    cache = signer_tables.signer_table_cache
    problems = []

    # ---- check 1: the ledger's hot arm >= 20% under cold ----
    kc = kernel_cost.trace_stages(128)
    cold_macs = kc["dsm"]["cold"]["executed_macs_per_call"]
    hot_macs = kc["dsm"]["hot"]["executed_macs_per_call"]
    savings = 1.0 - hot_macs / cold_macs
    if hot_macs > 0.80 * cold_macs:
        problems.append(
            f"hot dsm arm {hot_macs} MACs/call is not >=20% under "
            f"cold {cold_macs} — the acceleration regressed")

    def reset():
        batch_engine._reset_dispatch_state_for_testing()
        cache._reset_for_testing()
        bv.configure_dispatch(
            deadline_ms=30_000, dispatch_retries=0,
            failure_threshold=8, backoff_min_s=0.3, backoff_max_s=0.6,
            audit_rate=0.05)

    v = bv.BatchVerifier(devices=[dev] * N_DEV, bucket_sizes=(BUCKET,))
    if engines is not None:
        engines.append(v)
    v.health.configure(failure_threshold=2, backoff_min_s=0.2,
                       backoff_max_s=0.5)
    reset()
    # build and load both kernels' libraries before the sweep (nothing
    # on the CPU)
    for plugin in (bv.Ed25519Workload(), bv.Ed25519HotWorkload()):
        plugin.prepare(dev)
    libraries = _build.loaded_libraries()
    launch_rows = {"cold": {}, "hot": {}}
    _tally_launches(v._plugin, launch_rows["cold"])
    _tally_launches(v._hot, launch_rows["hot"])

    # ---- checks 2 and 3: zipf replicas, build and shape reuse ----
    pool, want = _corpus(n_signers)
    batches = _batches(n_signers)
    rep_a = _run_stream(v, pool, want, batches)
    # replica B: empty table cache and fresh dispatch state, the same
    # traffic. The reset zeroes the transfer ledger, so the engine's
    # cumulative byte tallies are read HERE: the reconciliation below
    # compares the same window.
    reset()
    tallies = v.health_snapshot()
    shipped0, fetched0 = tallies["shipped_bytes"], tallies["fetched_bytes"]
    rep_b = _run_stream(v, pool, want, batches)

    for name, rep in (("A", rep_a), ("B", rep_b)):
        if not (rep["verdicts"] == rep["expected"]).all():
            bad = int((rep["verdicts"] != rep["expected"]).sum())
            problems.append(
                f"replica {name}: {bad} verdicts mismatched the "
                "ed25519_ref oracle")
        if rep["hot_rows"] == 0:
            problems.append(
                f"replica {name}: zipf stream never rode the hot "
                "kernel")
        if rep["installs"] < n_signers:
            problems.append(
                f"replica {name}: only {rep['installs']} installs "
                f"for {n_signers} distinct signers")
    if not np.array_equal(rep_a["verdicts"], rep_b["verdicts"]):
        problems.append("replica verdict streams DIVERGED")
    part_keys = ("hot_rows", "cold_rows", "hits", "misses", "installs")
    if any(rep_a[k] != rep_b[k] for k in part_keys):
        problems.append(
            "replica partitions diverged: "
            f"A={ {k: rep_a[k] for k in part_keys} } "
            f"B={ {k: rep_b[k] for k in part_keys} } — the hot/cold "
            "split is not deterministic")

    launch_rows = {k: dict(r) for k, r in launch_rows.items()}
    cold_shapes = sorted(launch_rows["cold"])
    hot_shapes = sorted(launch_rows["hot"])
    built = sorted(set(_build.loaded_libraries()) - set(libraries))
    if built:
        problems.append(f">1000-signer sweep built or loaded {built}")
    if cold_shapes != [SUB] or hot_shapes != [SUB]:
        problems.append(
            f">1000-signer sweep launched beyond the sub-chunk's {SUB} "
            f"rows: cold={cold_shapes} hot={hot_shapes}")

    # ---- check 4: steady-state cached-table re-dispatches ship zero
    # redundant bytes, ledger reconciled ----
    head = [pool[k] for k in range(HOT_HEAD)]   # all cached by now
    was_enabled = resident_cache.enabled
    resident_cache.configure(enabled=True)
    try:
        v.verify_batch(head)      # seeds residency for these operands
        before = transfer_ledger.totals()
        for _ in range(2):
            got = v.verify_batch(head)
            if not (got == want[:HOT_HEAD]).all():
                problems.append("steady-state hot batch verdicts broke")
        after = transfer_ledger.totals()
    finally:
        resident_cache.configure(enabled=was_enabled)
    delta = {k: after[k] - before[k]
             for k in ("round_trips", "bytes_h2d",
                       "redundant_constant_bytes", "resident_hits")}
    if delta["round_trips"] == 0:
        problems.append("steady-state window recorded zero round "
                        "trips")
    if delta["redundant_constant_bytes"] != 0:
        problems.append(
            f"steady-state re-dispatches shipped "
            f"{delta['redundant_constant_bytes']} redundant constant "
            "bytes — cached tables must upload once per placement")
    if delta["resident_hits"] == 0:
        problems.append("steady-state re-dispatches never hit the "
                        "resident cache")
    tallies = v.health_snapshot()
    shipped = tallies["shipped_bytes"] - shipped0
    fetched = tallies["fetched_bytes"] - fetched0
    rec_h2d = _ratio(after["bytes_h2d"], shipped)
    rec_d2h = _ratio(after["bytes_d2h"], fetched)
    reconciliation = min(x for x in (rec_h2d, rec_d2h)
                         if x is not None) \
        if (rec_h2d or rec_d2h) else None
    if reconciliation is None or reconciliation < MIN_RECONCILE:
        problems.append(
            f"ledger/engine byte reconciliation {reconciliation} < "
            f"{MIN_RECONCILE} (ledger h2d={after['bytes_h2d']} vs "
            f"engine {shipped}; d2h={after['bytes_d2h']} vs "
            f"{fetched})")

    # ---- check 5: eviction under pressure ----
    budget = PRESSURE_TABLES * signer_tables.TABLE_BYTES
    st_before = cache.snapshot()
    cache.configure(max_bytes=budget)
    try:
        press = _run_stream(v, pool, want, batches[:24])
        snap = cache.snapshot()
    finally:
        cache.configure(max_bytes=signer_tables.DEFAULT_CACHE_BYTES)
    evictions = snap["evictions"] - st_before["evictions"]
    press_hits = snap["hits"] - st_before["hits"]
    if not (press["verdicts"] == press["expected"]).all():
        problems.append("verdicts broke under cache pressure")
    if evictions == 0:
        problems.append("tiny byte budget forced zero evictions — "
                        "the LRU pressure valve is dead")
    if snap["bytes"] > budget:
        problems.append(
            f"cache bytes {snap['bytes']} exceed the configured "
            f"budget {budget}")
    if press_hits == 0:
        problems.append("zipf head stopped hitting under pressure")

    prom = registry.to_prometheus()
    if "crypto_verify_signer_table_hits" not in prom:
        problems.append("signer-table counters missing from the "
                        "Prometheus exposition")

    return {
        "ok": not problems,
        "devices": N_DEV,
        "device": str(dev),
        "bucket": BUCKET,
        "distinct_signers": n_signers,
        "ledger_version": kc["ledger_version"],
        "dsm_macs": {"cold": cold_macs, "hot": hot_macs,
                     "savings_frac": round(savings, 4)},
        "replica_a": {k: rep_a[k] for k in part_keys},
        "replica_b": {k: rep_b[k] for k in part_keys},
        "kernel_shapes": {"cold": cold_shapes, "hot": hot_shapes,
                          "donate": []},
        "launches_by_rows": launch_rows,
        "libraries": list(libraries),
        "steady_state": delta,
        "resident_cache": {"on_in_window": True,
                           "restored_to": was_enabled},
        "reconciliation": round(reconciliation, 4)
        if reconciliation is not None else None,
        "pressure": {"entries": snap["entries"],
                     "bytes": snap["bytes"],
                     "evictions": evictions,
                     "hits": press_hits},
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda[:N] (default: the first card) or cpu")
    ap.add_argument("--signers", type=int, default=N_SIGNERS,
                    help=f"distinct signers (default {N_SIGNERS})")
    args = ap.parse_args(argv)
    rec = run(args.device, args.signers)
    print(json.dumps(rec, default=str))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
