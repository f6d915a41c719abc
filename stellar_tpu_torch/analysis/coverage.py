"""Proof-coverage gate: every engine kernel variant carries a proof.

The interval prover (:mod:`stellar_tpu_torch.analysis.overflow`) proves
per-stage overflow envelopes of the kernels' plain versions and pins them
in committed goldens (``stellar_tpu_torch/analysis/limb_bounds.json`` and
``sha256_bounds.json``). This gate makes a NEW kernel variant show up
there: it enumerates every ``Workload`` plugin registered with the
engine (cold, hot, sha256, and any future subclass) and asserts each maps
to a proven envelope stage in a committed golden — an unproven kernel
fails ``python -m stellar_tpu_torch.tools.analyze`` instead of shipping.

Coverage is keyed ``(metrics_ns, variant_name)``, the pair the engine
counts a plugin's rows under, so a variant cannot reach the dispatch tier
without also being visible here. A new workload joins by proving its
stages (``--write-golden``) and adding its mapping to
:data:`PROOF_STAGES`; the gate makes forgetting either a hard failure.
"""

from __future__ import annotations

import importlib
import json
from typing import Dict, List, Optional, Tuple

from stellar_tpu_torch.analysis.lint_base import (
    Allowlist, Finding, finish_report, repo_root,
)

__all__ = ["run", "check", "enumerate_kernels", "PROOF_STAGES",
           "PLUGIN_MODULES", "ALLOWLIST"]

#: modules whose import registers Workload subclasses with the engine
PLUGIN_MODULES = [
    "stellar_tpu_torch.crypto.batch_verifier",
    "stellar_tpu_torch.crypto.batch_hasher",
]

#: (metrics_ns, variant_name) -> (committed golden, proven stage)
PROOF_STAGES: Dict[Tuple[str, Optional[str]], Tuple[str, str]] = {
    ("crypto.verify", None): ("stellar_tpu_torch/analysis/limb_bounds.json",
                              "kernel_total"),
    ("crypto.verify", "hot"): (
        "stellar_tpu_torch/analysis/limb_bounds.json", "kernel_hot_total"),
    ("crypto.hash", None): ("stellar_tpu_torch/analysis/sha256_bounds.json",
                            "sha256_kernel"),
}

# No entries by design: an unproven kernel is fixed by PROVING it, not
# by arguing it away — the Allowlist exists only so the stale sweep
# and report wiring stay uniform across every gate family.
ALLOWLIST = Allowlist({})


def enumerate_kernels() -> List[Tuple[str, Optional[str], str]]:
    """Every kernel variant registered with the engine:
    ``(metrics_ns, variant_name, class name)``, base class excluded,
    sorted for stable reports."""
    from stellar_tpu_torch.parallel import batch_engine
    for mod in PLUGIN_MODULES:
        importlib.import_module(mod)

    def walk(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from walk(sub)

    out = []
    for cls in walk(batch_engine.Workload):
        # only shipped kernels are gated — Workload subclasses defined
        # by test modules are fixtures, not dispatchable variants
        mod = cls.__module__ or ""
        if not (mod == "stellar_tpu_torch" or mod.startswith("stellar_tpu_torch.")):
            continue
        out.append((cls.metrics_ns, cls.variant_name, cls.__name__))
    return sorted(out, key=lambda k: (k[0], k[1] or "", k[2]))


def _load_goldens(root) -> Dict[str, Optional[dict]]:
    goldens: Dict[str, Optional[dict]] = {}
    for _ns_variant, (rel, _stage) in PROOF_STAGES.items():
        if rel in goldens:
            continue
        path = root / rel
        if not path.exists():
            goldens[rel] = None
            continue
        try:
            goldens[rel] = json.loads(path.read_text())
        except (ValueError, OSError):
            goldens[rel] = None
    return goldens


def check(kernels: List[Tuple[str, Optional[str], str]],
          goldens: Dict[str, Optional[dict]],
          proof_stages: Optional[dict] = None
          ) -> Tuple[List[Finding], List[dict]]:
    """Pure coverage check (unit-test hook): returns (findings, one
    row per kernel). A kernel is proven iff its ``(ns, variant)`` maps
    to a stage present, with a recorded envelope, in a loaded golden."""
    stages = PROOF_STAGES if proof_stages is None else proof_stages
    findings: List[Finding] = []
    rows: List[dict] = []
    for ns, variant, cname in kernels:
        row = {"metrics_ns": ns, "variant": variant, "class": cname,
               "proven": False, "golden": None, "stage": None}
        mapped = stages.get((ns, variant))
        if mapped is None:
            findings.append(Finding(
                file="stellar_tpu_torch/analysis/coverage.py", line=1,
                rule="proof-coverage",
                symbol=f"{ns}:{variant or 'cold'}",
                message=f"kernel variant {cname} ({ns}, "
                        f"variant={variant!r}) has no proven "
                        "overflow-envelope stage mapped in "
                        "coverage.PROOF_STAGES — prove its stages "
                        "and commit the golden before shipping"))
            rows.append(row)
            continue
        rel, stage = mapped
        row["golden"], row["stage"] = rel, stage
        golden = goldens.get(rel)
        entry = (golden or {}).get("stages", {}).get(stage)
        if not entry or "max_abs" not in entry:
            findings.append(Finding(
                file=rel, line=1, rule="proof-coverage",
                symbol=f"{ns}:{variant or 'cold'}",
                message=f"kernel variant {cname} maps to stage "
                        f"{stage!r} but the committed golden {rel} "
                        "has no proven envelope for it — re-run "
                        "python -m stellar_tpu_torch.tools.analyze "
                        "--write-golden after proving the stage"))
            rows.append(row)
            continue
        row["proven"] = True
        rows.append(row)
    return findings, rows


def run(allowlist: Optional[Allowlist] = None) -> dict:
    """The gate over the real engine + committed goldens. Returns a
    LintReport dict plus the per-kernel rows (``kernels``) and the
    proven count (``proven``)."""
    root = repo_root()
    kernels = enumerate_kernels()
    findings, rows = check(kernels, _load_goldens(root))
    rep = finish_report("proof_coverage", len(kernels), findings,
                        allowlist or ALLOWLIST)
    out = rep.to_dict()
    out["kernels"] = rows
    out["proven"] = sum(1 for r in rows if r["proven"])
    return out
