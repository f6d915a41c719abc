"""The five BASELINE scenarios through the port's load generator, with
one table of their numbers.

Runs ``simulation.load_generator``'s harnesses with the reference's
arguments (``tools/run_benchmarks.py``): config 1's payment closes
(``apply_load``), config 2's multi-signer sets (``multisig_apply_load``),
config 3's catchup replay (``catchup_replay_bench``), config 4's
16-validator consensus rounds (``scp_storm_bench``), and config 5's
Soroban closes and the compute-bound Soroban load, each as an
interleaved, order-alternating best-of-N A/B of the SCVal program
against the compiled wasm. Every row names the verify backend that
produced it.

``--verify device`` puts the card behind ``keys.verify_sig`` (raises
with no card), ``--verify host`` the host oracle, and ``--verify auto``
(the default) the card wherever one answers, as the port's
``apply-load`` does. The port writes ``build/torch_benchmarks.json`` and
``build/torch_benchmarks.md`` under the repository root, where the
reference rewrites its ``docs/benchmarks.*``; the last line printed is
one JSON object naming them.

    python -m stellar_tpu_torch.tools.run_benchmarks [--quick]
        [--verify auto|device|host]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
from datetime import date
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
OUT_JSON = REPO / "build" / "torch_benchmarks.json"
OUT_MD = REPO / "build" / "torch_benchmarks.md"

BEGIN = "<!-- BENCH_TABLE_BEGIN (tools/run_benchmarks.py) -->"
END = "<!-- BENCH_TABLE_END -->"


def run_all(quick: bool, verify: str = "auto") -> dict:
    """Every scenario's record by name; ``quick`` runs about 30% of the
    ledgers and transactions."""
    from stellar_tpu_torch.crypto.batch_verifier import select_verifier
    from stellar_tpu_torch.crypto.keys import get_verifier_backend_name
    from stellar_tpu_torch.simulation.load_generator import (
        apply_load, catchup_replay_bench, multisig_apply_load,
        scp_storm_bench, soroban_apply_load,
    )
    select_verifier(verify)
    scale = 0.3 if quick else 1.0

    def n(x):
        return max(1, int(x * scale))
    out = {}
    print("[1/5] close (payment ledgers)...", file=sys.stderr)
    out["close"] = apply_load(n_ledgers=n(130), txs_per_ledger=100)
    print("[2/5] multisig...", file=sys.stderr)
    out["multisig"] = multisig_apply_load(n_ledgers=n(5),
                                          txs_per_ledger=n(1000))
    print("[3/5] catchup replay...", file=sys.stderr)
    out["catchup"] = catchup_replay_bench(n_ledgers=max(63, n(130)),
                                          txs_per_ledger=10)
    print("[4/5] scp storm...", file=sys.stderr)
    out["scp_storm"] = scp_storm_bench(n_validators=16,
                                       n_rounds=n(5))

    # engine A/B pairs run interleaved, order-alternating, best-of-N: one
    # sequential run a side mis-ranks engines whose difference is a few
    # percent under the host's noise and the first runner's penalty
    def ab(fn, runs=1 if quick else 3, **kw):
        best = {}
        for i in range(runs):
            order = (False, True) if i % 2 == 0 else (True, False)
            for wasm in order:
                r = fn(use_wasm=wasm, **kw)
                k = "wasm" if wasm else "scval"
                if k not in best or \
                        r["txs_per_sec"] > best[k]["txs_per_sec"]:
                    best[k] = r
        for r in best.values():
            r["ab_runs"] = runs
            r["ab_method"] = "interleaved order-alternating best-of-N"
        return best["scval"], best["wasm"]

    print("[5/5] soroban A/B (scval vs wasm, interleaved)...",
          file=sys.stderr)
    out["soroban"], out["soroban_wasm"] = ab(
        soroban_apply_load, n_ledgers=n(3), txs_per_ledger=n(500))
    print("[5c] soroban compute-bound A/B (interleaved)...",
          file=sys.stderr)
    from stellar_tpu_torch.simulation.load_generator import (
        soroban_compute_load,
    )
    out["soroban_compute_scval"], out["soroban_compute_wasm"] = ab(
        soroban_compute_load, n_ledgers=n(3), txs_per_ledger=n(100))
    # every row names the verify backend that produced it
    backend = get_verifier_backend_name()
    for row in out.values():
        row["verify_backend"] = backend
    return out


def render_table(results: dict) -> str:
    c = results["close"]
    m = results["multisig"]
    r = results["catchup"]
    s = results["scp_storm"]
    b = results["soroban"]
    rows = [
        ("close (#1)",
         f"{c['close_mean_ms']} ms mean / {c['close_p99_ms']} ms p99 "
         f"close, {c['tx_apply_per_sec']} tx/s, deep-spill worst "
         f"{c.get('deep_spill_over_p50', '-')}x p50"),
        ("multisig (#2)",
         f"{m.get('sigs_per_sec', m.get('consumed_sigs_per_sec', '-'))}"
         f" consumed sigs/s over {m['ledgers']} closes"),
        ("catchup (#3)",
         f"{r['ledgers_per_sec']} ledgers/s replayed "
         f"({r['replayed_ledgers']} ledgers, {r['txs_per_sec']} tx/s)"),
        ("scp-storm (#4)",
         f"{s.get('rounds_per_sec', '-')} rounds/s, "
         f"{s.get('total_statements', '-')} SCP statements"),
        ("soroban (#5)",
         f"{b['close_mean_ms']} ms mean close, {b['txs_per_sec']} tx/s"
         f" ({b['signatures_per_ledger']} sigs/ledger)"),
        ("soroban #5, compiled wasm",
         f"{results['soroban_wasm']['close_mean_ms']} ms mean close, "
         f"{results['soroban_wasm']['txs_per_sec']} tx/s "
         f"({results['soroban_wasm']['engine']})"),
        ("soroban compute-bound",
         f"{results['soroban_compute_wasm']['txs_per_sec']} tx/s "
         f"wasm-native vs "
         f"{results['soroban_compute_scval']['txs_per_sec']} tx/s "
         f"scval ({results['soroban_compute_wasm']['loop_iterations']}"
         "-iteration loop)"),
    ]
    lines = [BEGIN, "",
             f"Generated {date.today()} on {platform.machine()} "
             f"({os.cpu_count()} cpus) by `tools/run_benchmarks.py`; "
             "full JSON in `docs/benchmarks.json`.", "",
             "| scenario | result |", "|---|---|"]
    for name, desc in rows:
        lines.append(f"| {name} | {desc} |")
    lines += ["", END]
    return "\n".join(lines)


def write(results: dict) -> list:
    """The records as JSON and the table as markdown, under ``build/``;
    returns the paths written, from the repository root."""
    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    OUT_JSON.write_text(json.dumps(results, indent=1, sort_keys=True) + "\n")
    OUT_MD.write_text("## Measured scenario numbers\n\n" +
                      render_table(results) + "\n")
    return [str(p.relative_to(REPO)) for p in (OUT_JSON, OUT_MD)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="~30%% scale for smoke runs")
    ap.add_argument("--verify", choices=("auto", "device", "host"),
                    default="auto",
                    help="verification backend for every scenario")
    args = ap.parse_args(argv)
    results = run_all(args.quick, verify=args.verify)
    print(json.dumps({"wrote": write(results),
                      "scenarios": sorted(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
