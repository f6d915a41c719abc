"""Static analysis gate of the port: the overflow prover, the hot-path,
lock, lock-order and nondeterminism lints, and the kernel proof-coverage
gate.

Runs the whole ``stellar_tpu_torch.analysis`` suite on the CPU (no card,
no JAX) and exits nonzero on ANY open finding, stale allowlist entry or
golden diff:

  python -m stellar_tpu_torch.tools.analyze                  # report
  python -m stellar_tpu_torch.tools.analyze --json           # one line
  python -m stellar_tpu_torch.tools.analyze --buckets=1,2,3
  python -m stellar_tpu_torch.tools.analyze --lint-only      # AST only
  python -m stellar_tpu_torch.tools.analyze --overflow-only  # prover only
  python -m stellar_tpu_torch.tools.analyze --write-golden   # refresh the
      # port's goldens (a DELIBERATE act: the diff is the proof change)

The overflow prover interprets the plain versions' stages at each batch
of ``--buckets`` (default ``overflow.DEFAULT_BUCKETS``) and proves every
integer intermediate fits its dtype with the loose-limb headroom; the
proven envelope must match the committed goldens
``stellar_tpu_torch/analysis/limb_bounds.json`` and ``sha256_bounds.json``.
The ``--json`` line carries each envelope's ``envelope_sha256``.
"""

from __future__ import annotations

import json
import os
import sys

from stellar_tpu_torch.analysis.lint_base import repo_root

_REPO = str(repo_root())


def run_lints() -> dict:
    from stellar_tpu_torch.analysis import hotpath, lockorder, locks, nondet
    return {rep.name: rep.to_dict()
            for rep in (hotpath.run(), locks.run(), nondet.run(),
                        lockorder.run())}


def run_proof_coverage() -> dict:
    """Every registered Workload variant maps to a proven envelope stage
    in a committed golden."""
    from stellar_tpu_torch.analysis import coverage
    return coverage.run()


def _check_golden(rec: dict, golden, path: str) -> dict:
    from stellar_tpu_torch.analysis import overflow
    if golden is None:
        rec["golden"] = "missing"
        rec["golden_diff"] = [
            f"{path} not committed — run python -m stellar_tpu_torch."
            "tools.analyze --write-golden and review the envelope"]
        rec["ok"] = False
    else:
        diff = overflow.diff_golden(rec["envelope"], golden)
        rec["golden"] = "match" if not diff else "MISMATCH"
        rec["golden_diff"] = diff
        rec["golden_sha256"] = overflow.envelope_sha256(golden)
        rec["ok"] = rec["ok"] and not diff
    return rec


def run_overflow(buckets) -> dict:
    from stellar_tpu_torch.analysis import overflow
    rec = overflow.prove_buckets(buckets)
    return _check_golden(rec, overflow.load_golden(_REPO),
                         overflow.GOLDEN_PATH)


def run_overflow_sha256(buckets) -> dict:
    """Prove K3's plain version — a golden of its own, so the ed25519
    envelope diffs apart from it."""
    from stellar_tpu_torch.analysis import overflow
    rec = overflow.prove_sha256_buckets(buckets)
    return _check_golden(rec, overflow.load_sha_golden(_REPO),
                         overflow.SHA_GOLDEN_PATH)


def main(argv) -> int:
    as_json = "--json" in argv
    lint_only = "--lint-only" in argv
    overflow_only = "--overflow-only" in argv
    write_golden = "--write-golden" in argv
    from stellar_tpu_torch.analysis.overflow import (
        DEFAULT_BUCKETS, GOLDEN_PATH, SHA_GOLDEN_PATH)
    buckets = list(DEFAULT_BUCKETS)
    for a in argv:
        if a.startswith("--buckets="):
            buckets = [int(b) for b in a.split("=", 1)[1].split(",")]

    def _maybe_write_golden(rec, path):
        if not write_golden:
            return rec
        with open(os.path.join(_REPO, path), "w") as f:
            json.dump(rec["envelope"], f, indent=1, sort_keys=True)
            f.write("\n")
        rec["golden"] = "written"
        rec["golden_diff"] = []
        rec["ok"] = (not rec["violations"]
                     and not rec["contract_breaches"]
                     and not rec["unsupported"]
                     and not rec["envelope_mismatch_buckets"])
        return rec

    out = {"ok": True}
    if not overflow_only:
        lints = run_lints()
        out["lints"] = lints
        out["ok"] &= all(rep["ok"] for rep in lints.values())
    if not lint_only and not overflow_only:
        cov = run_proof_coverage()
        out["proof_coverage"] = cov
        out["ok"] &= cov["ok"]
    if not lint_only:
        for key, run, path in (
                ("overflow", run_overflow, GOLDEN_PATH),
                ("overflow_sha256", run_overflow_sha256, SHA_GOLDEN_PATH)):
            rec = _maybe_write_golden(run(buckets), path)
            # the full envelope rides the golden file, not the record
            out[key] = {k: v for k, v in rec.items() if k != "envelope"}
            out["ok"] &= rec["ok"]

    if as_json:
        print(json.dumps(out, default=str))
    else:
        _pretty(out)
    return 0 if out["ok"] else 1


def _pretty(out: dict) -> None:
    for name, rep in out.get("lints", {}).items():
        status = "ok" if rep["ok"] else "FAIL"
        print(f"[{status}] lint:{name}  files={rep['files_scanned']} "
              f"open={len(rep['findings'])} "
              f"allowlisted={len(rep['allowlisted'])} "
              f"stale={len(rep['stale_allowlist'])}")
        for f in rep["findings"]:
            print(f"    {f['file']}:{f['line']}: [{f['key']}] "
                  f"{f['message']}")
        for e in rep["stale_allowlist"]:
            print(f"    stale allowlist entry (delete it): {e}")
    for key in ("overflow", "overflow_sha256"):
        ov = out.get(key)
        if not ov:
            continue
        status = "ok" if ov["ok"] else "FAIL"
        print(f"[{status}] {key}  buckets={ov.get('buckets')} "
              f"violations={len(ov['violations'])} "
              f"contract={len(ov['contract_breaches'])} "
              f"golden={ov.get('golden')}")
        for v in ov["violations"][:20]:
            print(f"    {v['path']}[{v['eqn_index']}] {v['primitive']} -> "
                  f"[{v['lo']}, {v['hi']}] escapes {v['dtype']} at "
                  f"{v['where']}")
        for c in ov["contract_breaches"][:20]:
            print(f"    {c}")
        for u in ov["unsupported"][:20]:
            print(f"    unsupported: {u}")
        for d in ov.get("golden_diff", [])[:20]:
            print(f"    golden: {d}")
        print(f"    envelope_sha256={ov.get('envelope_sha256')}")
    cov = out.get("proof_coverage")
    if cov:
        status = "ok" if cov["ok"] else "FAIL"
        print(f"[{status}] proof-coverage  kernels={cov['files_scanned']} "
              f"proven={cov['proven']} open={len(cov['findings'])} "
              f"stale={len(cov['stale_allowlist'])}")
        for f in cov["findings"]:
            print(f"    {f['file']}: [{f['key']}] {f['message']}")
        for e in cov["stale_allowlist"]:
            print(f"    stale allowlist entry (delete it): {e}")
    print("ANALYSIS_OK" if out["ok"] else "ANALYSIS_FAIL")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
