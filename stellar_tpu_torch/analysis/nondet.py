"""Consensus nondeterminism lint, on the shared lint framework.

The consensus-critical packages of the port must not consult wall clocks,
unseeded RNGs or per-process hash salts: any of those is a divergence
hazard between nodes (the node's own ``check-nondet`` rule, a CI grep
banning unseeded randomness from consensus code). The pass walks the
port's consensus packages and its crypto host-oracle modules: a verdict
re-verified on the host must be exactly as deterministic as the packages
that consume it.
"""

from __future__ import annotations

import re
from typing import List, Optional

from stellar_tpu_torch.analysis.lint_base import (
    Allowlist, Finding, LintReport, finish_report, repo_root, walk_py,
)
# quote-aware '#' stripping: a '#' inside a string literal must not
# truncate the line before a banned call that follows it
from stellar_tpu_torch.utils.toml_compat import _strip_comment

__all__ = ["run", "lint_source", "drift_findings", "CONSENSUS_DIRS",
           "HOST_ORACLE_FILES", "DRIFT_ROOTS", "ALLOWLIST", "BANNED",
           "TRACING_SANCTIONED"]

# packages whose behavior must be bit-identical across nodes
CONSENSUS_DIRS = ["stellar_tpu_torch/scp", "stellar_tpu_torch/ledger",
                  "stellar_tpu_torch/tx", "stellar_tpu_torch/bucket",
                  "stellar_tpu_torch/soroban", "stellar_tpu_torch/xdr"]

# crypto host-oracle modules: the host half of every verify decision
# (policy gates, SHA-512 prep, the audit's oracle) plus the pure
# primitives under them — one nondeterministic branch here and the
# device and host halves of a verdict could disagree
HOST_ORACLE_FILES = [
    # the audit sampler and the quarantine registry gate WHICH backend
    # serves a verdict: the sample must be content-derived and the
    # quarantine logic clock- and RNG-free
    "stellar_tpu_torch/crypto/audit.py",
    "stellar_tpu_torch/parallel/device_health.py",
    # the verify service decides which queued work verifies and which
    # sheds: the shed rule stays content-seeded and the scheduler
    # sequence-based
    "stellar_tpu_torch/crypto/verify_service.py",
    # the tenant layer's quotas, weighted-fair virtual time and shed
    # fractions, and the controller's knob moves, are pure functions of
    # their inputs: no allowlist entry
    "stellar_tpu_torch/crypto/tenant.py",
    "stellar_tpu_torch/crypto/controller.py",
    # the fleet router's routing, probation and conviction are SHA-256
    # rendezvous draws over event counts: no allowlist entry
    "stellar_tpu_torch/crypto/fleet.py",
    # what arrived on the wire, and the journal's merge, are pure
    # functions of the bytes and logs handed in: no allowlist entry
    "stellar_tpu_torch/crypto/ingress.py",
    "stellar_tpu_torch/utils/wire.py",
    "stellar_tpu_torch/utils/journal.py",
    # the batch engine owns dispatch, the audit sample and the moves of a
    # part for every workload
    "stellar_tpu_torch/parallel/batch_engine.py",
    # the SHA-256 workload's host helpers and plugin feed bucket-list and
    # header hashes that must be bit-identical across nodes
    "stellar_tpu_torch/ops/sha256.py",
    "stellar_tpu_torch/crypto/batch_hasher.py",
    # the transfer ledger's fingerprints, the resident cache's keys and
    # the signer-table cache's hot/cold split are content-derived
    "stellar_tpu_torch/utils/transfer_ledger.py",
    "stellar_tpu_torch/parallel/residency.py",
    "stellar_tpu_torch/parallel/signer_tables.py",
    # the trickle batcher and verify collector: one clock (the trickle
    # window) decides WHEN a batch dispatches, never a verdict
    "stellar_tpu_torch/crypto/batch_verifier.py",
    "stellar_tpu_torch/crypto/nacl_box.py",
    "stellar_tpu_torch/crypto/ed25519_ref.py",
    "stellar_tpu_torch/crypto/curve25519.py",
    "stellar_tpu_torch/crypto/keys.py",
    "stellar_tpu_torch/crypto/native_prep.py",
    "stellar_tpu_torch/crypto/native_verify.py",
    "stellar_tpu_torch/crypto/sha.py",
    "stellar_tpu_torch/crypto/keccak.py",
    "stellar_tpu_torch/crypto/shorthash.py",
    "stellar_tpu_torch/crypto/strkey.py",
    "stellar_tpu_torch/crypto/secp256.py",
    "stellar_tpu_torch/crypto/h2c.py",
    "stellar_tpu_torch/crypto/bls12_381.py",
    # the seeded traffic and test vectors: they sign through the oracle,
    # and every draw comes from a caller-seeded numpy Generator, so a run
    # repeats exactly: no allowlist entry
    "stellar_tpu_torch/crypto/vectors.py",
]

BANNED = [
    # (key, pattern, why)
    ("random", re.compile(
        r"\brandom\.(random|randint|randrange|choice|shuffle|"
        r"getrandbits)\b"),
     "unseeded process RNG in consensus code"),
    ("os.urandom", re.compile(r"\bos\.urandom\b"),
     "CSPRNG output must not influence consensus state"),
    ("secrets", re.compile(
        r"\bsecrets\.(token_bytes|randbits|randbelow)\b"),
     "CSPRNG output must not influence consensus state"),
    ("clock", re.compile(
        r"\btime\.time\(\)|\btime\.monotonic\(\)|"
        r"\btime\.perf_counter\(\)"),
     "wall/monotonic clock reads diverge between nodes"),
    ("wallclock", re.compile(
        r"\bdatetime\.now\(\)|\bdatetime\.utcnow\(\)"),
     "wall clock reads diverge between nodes"),
    # bare builtin hash( — NOT .hash() methods (content hashes)
    ("hash", re.compile(r"(?<![.\w])hash\("),
     "builtin hash() is salted per-process (PYTHONHASHSEED)"),
]

# ---------------- tracing fence ----------------
# stellar_tpu_torch/utils/tracing.py is clock-bearing BY DESIGN (perf_counter
# pairs, span records, the flight recorder). Consensus/host-oracle
# modules may use only its duration-blind context managers — zone/span
# etc. time a scope but never EXPOSE a duration to the caller, so their
# clock reads cannot influence a decision. Importing the module itself
# (or any other name, e.g. ``flight_recorder`` or ``span_totals``)
# would hand consensus code readable clock state and is banned.
TRACING_SANCTIONED = frozenset({
    "zone", "span", "LogSlowExecution", "current_zones", "frame_mark",
})

_TRACING_MODULE = re.compile(
    r"^\s*import\s+stellar_tpu_torch\.utils\.tracing\b")
# from stellar_tpu_torch.utils import a, (tracing), ... — names checked
# after paren accumulation, so the parenthesized spelling can't slip
# the module in
_UTILS_FROM = re.compile(
    r"^\s*from\s+stellar_tpu_torch\.utils\s+import\s+(.*)$")
_TRACING_FROM = re.compile(
    r"^\s*from\s+stellar_tpu_torch\.utils\.tracing\s+import\s+(.*)$")


def _lint_tracing_imports(text: str, rel: str) -> List[Finding]:
    """Fence tracing out of consensus modules: only the sanctioned
    duration-blind names may be imported. Handles parenthesized
    multi-line from-imports (the ``ledger_manager`` spelling)."""
    out: List[Finding] = []

    def emit(lineno: int, what: str):
        out.append(Finding(
            file=rel, line=lineno, rule="nondet", symbol="tracing-import",
            message=f"{what} — tracing is clock-bearing by design; "
                    "consensus modules may import only its "
                    "duration-blind context managers "
                    f"({', '.join(sorted(TRACING_SANCTIONED))})"))

    lines = text.splitlines()

    def gather_names(first: str, i: int) -> tuple:
        """Imported names of one from-import, accumulating BOTH
        continuation spellings — parenthesized and backslash-continued
        lines; returns (names, next_i)."""
        src = first
        while i + 1 < len(lines) and (
                ("(" in src and ")" not in src)
                or src.rstrip().endswith("\\")):
            i += 1
            src = src.rstrip().rstrip("\\") + " " + \
                _strip_comment(lines[i])
        names = [tok.split(" as ")[0].strip()
                 for tok in src.replace("(", " ").replace(")", " ")
                 .replace("\\", " ").split(",")]
        return [nm for nm in names if nm], i

    i = 0
    while i < len(lines):
        lineno = i + 1
        line = _strip_comment(lines[i])
        if _TRACING_MODULE.match(line):
            emit(lineno, "module-level tracing import")
            i += 1
            continue
        m = _TRACING_FROM.match(line)
        if m is not None:
            names, i = gather_names(m.group(1), i)
            bad = [nm for nm in names
                   if nm not in TRACING_SANCTIONED]
            if bad:
                emit(lineno, "import of non-sanctioned tracing "
                             f"names {bad}")
            i += 1
            continue
        m = _UTILS_FROM.match(line)
        if m is not None:
            names, i = gather_names(m.group(1), i)
            if "tracing" in names:
                emit(lineno, "module-level tracing import")
        i += 1
    return out

ALLOWLIST = Allowlist({
    "stellar_tpu_torch/crypto/keys.py": {
        "nondet:clock":
            "sign_ops_per_second / verify_ops_per_second time their own "
            "benchmark loop with perf_counter pairs (the node's "
            "benchmarkOpsPerSecond): the rate goes back to the operator "
            "only; no verify decision or ledger state ever reads it.",
        "nondet:os.urandom":
            "SecretKey.random(): key MATERIAL, where randomness is the "
            "point; a verify decision depends only on the resulting "
            "public bytes, never on how the seed was drawn.",
        "nondet:random":
            "SecretKey.pseudo_random_for_testing draws a test key from "
            "the process random stream (the node's test-only "
            "generator): fixtures only, never ledger state.",
    },
    "stellar_tpu_torch/crypto/curve25519.py": {
        "nondet:os.urandom":
            "X25519 ephemeral keypairs for overlay transport encryption: "
            "key material used only by the local handshake, never "
            "consensus state.",
    },
    "stellar_tpu_torch/crypto/shorthash.py": {
        "nondet:os.urandom":
            "the per-process siphash key (the node's shortHash::"
            "initialize): short hashes seed process-local maps only and "
            "never cross the wire or enter consensus state.",
    },
    "stellar_tpu_torch/crypto/verify_service.py": {
        "nondet:clock":
            "time.monotonic() stamps admission and completion for the "
            "lanes' wait histograms and the SLO accounting (dashboards "
            "only), and ages the adopter cool-down that picks WHICH "
            "path serves a check (service lane or direct verify_sig), "
            "both pinned to the same bits by the tests. Admission reads "
            "bounded queue and byte budgets, the order reads priorities "
            "and sequence numbers, shedding reads the content-seeded "
            "rule in crypto/audit.py: no clock decides a verdict.",
    },
    "stellar_tpu_torch/crypto/batch_verifier.py": {
        "nondet:clock":
            "TrickleBatcher.verify_sig's perf_counter pair paces the "
            "leader's window (how long it waits for co-riders): the "
            "clock decides WHEN a batch goes to the device, never a "
            "row's verdict, which comes from the kernel or the host "
            "oracle, held to the same bits by the tests and the audit.",
        "nondet:tracing-import":
            "the verifier opens its collection and dispatch spans and "
            "notes trace events for the flight recorder: durations land "
            "in observability records only; verdicts are composed from "
            "device and oracle bits, never from a span reading.",
    },
    "stellar_tpu_torch/parallel/batch_engine.py": {
        "nondet:clock":
            "time.monotonic() ages the device-probe thread "
            "(device_available: a probe older than its timeout is "
            "accounted hung): local liveness deciding only WHETHER the "
            "card is offered, never a row's verdict, which the kernel "
            "and the host oracle give bit for bit and the audit checks.",
        "nondet:tracing-import":
            "the engine is the instrumentation owner the fence protects "
            "consensus code from: it opens the resolve spans, dumps the "
            "flight recorder on breaker, quarantine and deadline "
            "events, and feeds dispatch_attribution; durations land in "
            "observability records only, never in a verdict.",
    },
})


def _lint_lines(text: str, rel: str) -> List[Finding]:
    out: List[Finding] = []
    in_dunder_hash = False
    for lineno, line in enumerate(text.splitlines(), 1):
        if "def " in line:
            # hash() inside __hash__ feeds per-process dict/set
            # identity only — never consensus state
            in_dunder_hash = "def __hash__" in line
        elif line and not line[0].isspace():
            # any module-level statement ends the __hash__ body
            in_dunder_hash = False
        stripped = _strip_comment(line)  # ignore comments (quote-aware)
        for key, pat, why in BANNED:
            m = pat.search(stripped)
            if not m:
                continue
            if key == "hash" and (in_dunder_hash or
                                  re.match(r"\s*def hash\(", stripped)):
                continue
            out.append(Finding(
                file=rel, line=lineno, rule="nondet", symbol=key,
                message=f"{m.group(0)!r} — {why}"))
    return out


def lint_source(src: str, rel: str) -> List[Finding]:
    """Lint one source text (unit-test hook)."""
    return _lint_lines(src, rel) + _lint_tracing_imports(src, rel)


# Where the scope-drift meta-lint looks: the host-oracle package
# itself. A crypto module that composes other host-oracle modules is
# part of the oracle and must be scoped; importers OUTSIDE the package
# (overlay auth, tx validation) consume verdicts, they don't produce
# them, so they stay out of this rule.
DRIFT_ROOTS = ["stellar_tpu_torch/crypto"]

_ORACLE_IMPORT = re.compile(
    r"^\s*(?:from\s+stellar_tpu_torch\.crypto\s+import\s+(?P<names>.+)|"
    r"(?:from\s+)?(?:import\s+)?stellar_tpu_torch\.crypto\.(?P<dotted>\w+))")


def drift_findings(scope: Optional[List[str]] = None) -> List[Finding]:
    """Scope-drift meta-lint: a module in ``stellar_tpu_torch/crypto`` that
    imports a host-oracle crypto module but is itself absent from
    :data:`HOST_ORACLE_FILES` composes oracle primitives outside the
    nondeterminism fence — new crypto files can no longer silently
    escape the lint. One finding per offending module, at its first
    oracle import."""
    scoped = set(HOST_ORACLE_FILES if scope is None else scope)
    oracle_stems = {f.rsplit("/", 1)[-1][:-3] for f in scoped
                    if f.startswith("stellar_tpu_torch/crypto/")}
    root = repo_root()
    out: List[Finding] = []
    for path in walk_py(DRIFT_ROOTS, root):
        rel = str(path.relative_to(root))
        if rel in scoped:
            continue
        for lineno, line in enumerate(
                path.read_text().splitlines(), 1):
            m = _ORACLE_IMPORT.match(_strip_comment(line))
            if not m:
                continue
            if m.group("dotted"):
                names = [m.group("dotted")]
            else:
                names = [tok.split(" as ")[0].strip() for tok in
                         m.group("names").split(",")]
            hit = sorted(set(names) & oracle_stems)
            if hit:
                out.append(Finding(
                    file=rel, line=lineno, rule="scope-drift",
                    symbol="host-oracle-import",
                    message=f"imports host-oracle module(s) {hit} "
                            "but is not in nondet.HOST_ORACLE_FILES "
                            "— add it (with written allowlist "
                            "arguments for any clock/RNG use) so new "
                            "crypto composition stays inside the "
                            "nondeterminism fence"))
                break
    return out


def run(allowlist: Optional[Allowlist] = None) -> LintReport:
    allowlist = allowlist or ALLOWLIST
    root = repo_root()
    findings: List[Finding] = []
    files = 0
    for path in walk_py(CONSENSUS_DIRS + HOST_ORACLE_FILES, root):
        rel = str(path.relative_to(root))
        files += 1
        text = path.read_text()
        findings.extend(_lint_lines(text, rel))
        findings.extend(_lint_tracing_imports(text, rel))
    findings.extend(drift_findings())
    return finish_report("nondet", files, findings, allowlist)
