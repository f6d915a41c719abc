"""Lock-discipline lint: shared mutable state must mutate under its lock.

The port's copy of the reference's lock lint, over the port's threaded
modules: the verify boundary's resolve watchdogs, probe threads, the
trickle-batch leader, the service dispatcher, the fleet and the wire. This
AST pass makes the locking convention checkable:

* **instance state** (``unlocked-attr``): in a class that owns a lock
  (an ``__init__`` attribute assigned from ``threading.Lock/RLock/
  Condition``), every mutation of ``self.<attr>`` outside ``__init__``
  — assignment, augmented assignment, subscript store, or a mutating
  container-method call — must sit lexically inside ``with
  self.<lock>:``.
* **module globals** (``unlocked-global``): a function that declares
  ``global X`` and assigns ``X`` in a module that owns module-level
  locks must do so inside ``with <lock>:``.

Convention the lint encodes rather than flags: functions/methods whose
name ends in ``_locked`` are called with the lock already held and are
exempt; ``__init__``/``__new__`` run before the object is shared and
are exempt. Lexical containment is the whole analysis — a lock taken in
a caller does not count, which is exactly why the ``_locked`` suffix
contract exists.

Limitation: a class with NO lock attribute is invisible to this pass, and
so is a lock held in a container (``ops/_build.py``'s per-library
``_locks`` dict): such a module is scoped so that the drift rule and the
lock-order prover read it, but its ``with _locks[name]:`` regions are not
seen as lock regions.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from stellar_tpu_torch.analysis.lint_base import (
    Allowlist, Finding, LintReport, finish_report, repo_root, walk_py,
)

__all__ = ["run", "lint_source", "drift_findings", "SCOPE",
           "DRIFT_ROOTS", "ALLOWLIST"]

# The port's threaded modules: verify dispatch, the resilience primitives
# (the watchdog pool among them), the per-device health registry, the
# metrics registry they all mark into (reservoir replacement is a
# read-modify-write), the tracing layer's flight-recorder ring, the verify
# service and its tenant and control layers, the fleet and the wire, the
# caches on the dispatch path, the native-library loaders and the kernel
# build (one lock a CUDA library).
SCOPE = [
    "stellar_tpu_torch/crypto/batch_verifier.py",
    "stellar_tpu_torch/crypto/batch_hasher.py",
    "stellar_tpu_torch/crypto/verify_service.py",
    # the tenant layer: policy table and per-tenant SLO windows mutate
    # from caller and dispatcher threads under the module's own locks
    # (the lane queues are service-internal, touched with the service cv
    # held: the _locked convention)
    "stellar_tpu_torch/crypto/tenant.py",
    # the closed-loop controller: trajectory log and knob state mutate
    # from the dispatcher thread while admin routes read snapshots
    "stellar_tpu_torch/crypto/controller.py",
    # the fleet router: replica states, conservation counters and
    # submission ledgers mutate from every submitting thread under the
    # router's one lock
    "stellar_tpu_torch/crypto/fleet.py",
    # the wire ingress: connection registry and counters mutate from
    # accept, reader, responder and snapshot threads under one cv; the
    # lock-order prover holds that no lock is held across a socket op
    "stellar_tpu_torch/crypto/ingress.py",
    # the frame codec and the journal are lock-free by design; scoped so
    # that a lock sneaking in is seen, not argued
    "stellar_tpu_torch/utils/wire.py",
    "stellar_tpu_torch/utils/journal.py",
    # the receive-buffer pool: free list and lease refcounts
    "stellar_tpu_torch/parallel/hostbuf.py",
    "stellar_tpu_torch/parallel/batch_engine.py",
    "stellar_tpu_torch/parallel/device_health.py",
    # the resident operand cache and the signer-table cache: LRUs that
    # mutate from every dispatching or partitioning thread
    "stellar_tpu_torch/parallel/residency.py",
    "stellar_tpu_torch/parallel/signer_tables.py",
    "stellar_tpu_torch/utils/resilience.py",
    "stellar_tpu_torch/utils/metrics.py",
    # the background worker pool: pool pointer and mode flag mutate from
    # setup, tests and shutdown while crank threads submit
    "stellar_tpu_torch/utils/workers.py",
    # the fault-injection registry: armed from tests while every
    # dispatch-path thread consults it
    "stellar_tpu_torch/utils/faults.py",
    # the verify cache and backend selector
    "stellar_tpu_torch/crypto/keys.py",
    # the native-library loaders: a module lock serializing a one-shot
    # g++ compile-and-dlopen (lockorder.ALLOWLIST argues the hold)
    "stellar_tpu_torch/utils/native.py",
    "stellar_tpu_torch/crypto/native_prep.py",
    "stellar_tpu_torch/crypto/native_verify.py",
    "stellar_tpu_torch/soroban/native_wasm.py",
    # the XDR pack-tree compiler's RLock
    "stellar_tpu_torch/xdr/runtime.py",
    "stellar_tpu_torch/utils/tracing.py",
    "stellar_tpu_torch/utils/transfer_ledger.py",
    # the pipeline timeline's tokens and ring
    "stellar_tpu_torch/utils/timeline.py",
    # the CUDA kernels' build and load: one lock a library serializes
    # nvcc and the dlopen, and the loaded libraries are a module cache
    "stellar_tpu_torch/ops/_build.py",
]

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_MUTATORS = {"append", "extend", "insert", "add", "update", "pop",
             "popleft", "popitem", "clear", "remove", "discard",
             "setdefault", "appendleft", "sort", "reverse"}


def _expr_calls(node: ast.AST):
    """Every Call in the EXPRESSION children of one STATEMENT — never
    descending into nested sub-statements (an `if` body's statements
    are visited separately) and yielding nothing for non-statement
    nodes, so each call is seen exactly once."""
    if not isinstance(node, ast.stmt):
        return
    for sub in ast.iter_child_nodes(node):
        if isinstance(sub, ast.expr):
            for n in ast.walk(sub):
                if isinstance(n, ast.Call):
                    yield n

# Where the scope-drift meta-lint looks for lock constructors that
# escaped SCOPE: the whole port package.
DRIFT_ROOTS = ["stellar_tpu_torch"]

ALLOWLIST = Allowlist({
    "stellar_tpu_torch/main/command_handler.py": {
        "scope-drift:lock-ctor":
            "QueryServer's BoundedSemaphore only bounds the in-flight "
            "ledger-entry queries (a concurrency throttle), it guards no "
            "shared mutable state: no attribute for the mutation lint to "
            "bind it to, and the handler's shared state lives behind "
            "module locks already in SCOPE.",
    },
    "stellar_tpu_torch/utils/timer.py": {
        "scope-drift:lock-ctor":
            "VirtualClock is single-threaded by crank discipline: every "
            "mutation happens on the crank thread, and its one lock "
            "guards only the cross-thread post_to_main queue (posts "
            "under the lock, the crank drains under the lock). The "
            "every-attr-under-lock contract does not describe it.",
    },
    "stellar_tpu_torch/parallel/batch_engine.py": {
        "unlocked-global:configure_dispatch.DEADLINE_MS":
            "one store of an immutable float, no read-modify-write: a "
            "racing _wait reads the old or the new deadline, both valid, "
            "and Application pushes the knob once at setup, before any "
            "dispatch thread exists.",
        "unlocked-global:configure_dispatch.DISPATCH_RETRIES":
            "one store of an immutable int, clamped before the store, no "
            "read-modify-write: a racing launch loop reads the old or the "
            "new count, both valid; pushed once at setup like "
            "DEADLINE_MS.",
        "unlocked-global:configure_dispatch.AUDIT_RATE":
            "one store of an immutable float, no read-modify-write: a "
            "racing resolve samples with the old or the new rate, and "
            "audit.sample_rows draws from the rows' content either way, "
            "so replicas stay deterministic; pushed once at setup.",
    },
})


def _is_lock_ctor(node: ast.AST) -> bool:
    """threading.Lock() / threading.RLock() / Condition() etc."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS:
        return True
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
        return True
    return False


class _ClassLinter:
    """Check one class body for unlocked self-attribute mutations."""

    def __init__(self, cnode: ast.ClassDef, rel: str,
                 findings: List[Finding]):
        self.cnode = cnode
        self.rel = rel
        self.findings = findings
        self.locks: Set[str] = set()
        self._collect_locks()

    def _collect_locks(self):
        for node in ast.walk(self.cnode):
            if isinstance(node, ast.Assign) and \
                    _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        self.locks.add(t.attr)

    def _is_with_lock(self, node: ast.With) -> bool:
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Attribute) and \
                    isinstance(e.value, ast.Name) and \
                    e.value.id == "self" and e.attr in self.locks:
                return True
        return False

    def run(self):
        if not self.locks:
            return  # lock-free class: outside this pass's contract
        for node in self.cnode.body:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self._check_func(node, top_name=node.name)

    def _check_func(self, fnode, top_name: str):
        if top_name in ("__init__", "__new__") or \
                top_name.endswith("_locked"):
            return
        self._scan(fnode, guarded=False, func=top_name)

    def _scan(self, node: ast.AST, guarded: bool, func: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.With):
                g = guarded or self._is_with_lock(child)
                self._scan(child, g, func)
                continue
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                if child.name.endswith("_locked"):
                    continue
                # nested defs (resolver closures) still touch self
                self._scan(child, False, f"{func}.{child.name}")
                continue
            if not guarded:
                self._check_stmt(child, func)
            self._scan(child, guarded, func)

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        """The self-rooted attribute a target/receiver mutates:
        ``self.a``, ``self.a[...]``, ``self.a.b[...].c`` all resolve to
        ``a`` — mutating a nested object still mutates state reached
        through self."""
        first_attr = None
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            if isinstance(node, ast.Attribute):
                first_attr = node.attr
            node = node.value
        if isinstance(node, ast.Name) and node.id == "self":
            return first_attr
        return None

    def _iter_targets(self, t: ast.AST):
        """Flatten tuple/list/starred unpacking targets."""
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from self._iter_targets(e)
        elif isinstance(t, ast.Starred):
            yield from self._iter_targets(t.value)
        else:
            yield t

    def _emit(self, node: ast.AST, func: str, attr: str, what: str):
        self.findings.append(Finding(
            file=self.rel, line=node.lineno, rule="unlocked-attr",
            symbol=f"{self.cnode.name}.{func}.{attr}",
            message=f"{what} outside `with self.<lock>` in a "
                    f"lock-owning class ({sorted(self.locks)})"))

    def _check_stmt(self, node: ast.AST, func: str):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for raw in targets:
                for t in self._iter_targets(raw):
                    attr = self._self_attr(t)
                    if attr and attr not in self.locks:
                        self._emit(node, func, attr,
                                   f"self.{attr} mutated")
        # mutator calls count wherever they appear in THIS statement's
        # expressions — bare statement, assigned result, or inside an
        # if/while/for/assert/raise head (sub-statements are handled by
        # _scan's own recursion, so only expression children are walked
        # here to avoid double counting)
        for call in _expr_calls(node):
            fn = call.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
                attr = self._self_attr(fn.value)
                if attr and attr not in self.locks:
                    self._emit(node, func, attr,
                               f"self.{attr}.{fn.attr}()")


_MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                  "OrderedDict", "Counter"}


class _ModuleLinter:
    """Check module-global mutations against module-level locks.

    Two mutation spellings, because only the first needs ``global``:

    * rebinding a declared global (``global X; X = ...``);
    * in-place mutation of a module-level mutable (``_CACHE[k] = v``,
      ``_EVENTS.append(e)``) — the common shared-dict/list idiom, which
      never declares ``global`` at all.
    """

    def __init__(self, tree: ast.Module, rel: str,
                 findings: List[Finding]):
        self.tree = tree
        self.rel = rel
        self.findings = findings
        self.locks: Set[str] = set()
        self.mutables: Set[str] = set()
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            if _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.locks.add(t.id)
            elif self._is_mutable_literal(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.mutables.add(t.id)

    @staticmethod
    def _is_mutable_literal(node: ast.AST) -> bool:
        if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else ""
            return name in _MUTABLE_CTORS
        return False

    def _is_with_lock(self, node: ast.With) -> bool:
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Name) and e.id in self.locks:
                return True
        return False

    def run(self):
        if not self.locks:
            return  # module owns no locks: single-threaded by design
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                if node.name.endswith("_locked"):
                    continue
                declared: Set[str] = set()
                local_shadows: Set[str] = set()
                for n in ast.walk(node):
                    if isinstance(n, ast.Global):
                        declared.update(n.names)
                    elif isinstance(n, ast.Assign):
                        for t in n.targets:
                            if isinstance(t, ast.Name):
                                local_shadows.add(t.id)
                watched = declared | (self.mutables -
                                      (local_shadows - declared))
                if not watched:
                    continue
                self._scan(node, False, node.name, declared, watched)

    def _emit(self, node: ast.AST, func: str, name: str, what: str):
        self.findings.append(Finding(
            file=self.rel, line=node.lineno, rule="unlocked-global",
            symbol=f"{func}.{name}",
            message=f"{what} outside `with <module lock>` "
                    f"({sorted(self.locks)})"))

    def _scan(self, node: ast.AST, guarded: bool, func: str,
              declared: Set[str], watched: Set[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.With):
                self._scan(child, guarded or self._is_with_lock(child),
                           func, declared, watched)
                continue
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue  # nested defs get their own scan
            if not guarded and isinstance(
                    child, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = child.targets if isinstance(
                    child, ast.Assign) else [child.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in declared:
                        self._emit(child, func, t.id,
                                   f"global {t.id} assigned")
                    elif isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in watched:
                        self._emit(child, func, t.value.id,
                                   f"{t.value.id}[...] stored")
            if not guarded:
                for call in _expr_calls(child):
                    fn = call.func
                    if isinstance(fn, ast.Attribute) and \
                            fn.attr in _MUTATORS and \
                            isinstance(fn.value, ast.Name) and \
                            fn.value.id in watched:
                        self._emit(child, func, fn.value.id,
                                   f"{fn.value.id}.{fn.attr}()")
            self._scan(child, guarded, func, declared, watched)


def lint_source(src: str, rel: str) -> List[Finding]:
    """Lint one source text (unit-test / mutation-test hook)."""
    findings: List[Finding] = []
    tree = ast.parse(src)
    _ModuleLinter(tree, rel, findings).run()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            _ClassLinter(node, rel, findings).run()
    return findings


def drift_findings(scope: Optional[List[str]] = None,
                   roots: Optional[List[str]] = None) -> List[Finding]:
    """Scope-drift meta-lint: a module under ``stellar_tpu_torch/`` that
    constructs a ``threading`` lock but is absent from :data:`SCOPE`
    escapes both the mutation lint and the lock-order prover — new
    threaded files can no longer do that silently. One finding per
    offending module, at its first lock constructor."""
    scoped = set(SCOPE if scope is None else scope)
    root = repo_root()
    out: List[Finding] = []
    for path in walk_py(roots or DRIFT_ROOTS, root):
        rel = str(path.relative_to(root))
        if rel in scoped:
            continue
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:  # pragma: no cover - tree is parseable
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and \
                    _is_lock_ctor(node.value):
                out.append(Finding(
                    file=rel, line=node.lineno, rule="scope-drift",
                    symbol="lock-ctor",
                    message="module constructs a threading lock but "
                            "is not in locks.SCOPE — add it (mutation "
                            "lint + lock-order prover) or write a "
                            "safety argument in locks.ALLOWLIST"))
                break
    return out


def run(allowlist: Optional[Allowlist] = None) -> LintReport:
    allowlist = allowlist or ALLOWLIST
    root = repo_root()
    findings: List[Finding] = []
    files = 0
    for path in walk_py(SCOPE, root):
        rel = str(path.relative_to(root))
        files += 1
        findings.extend(lint_source(path.read_text(), rel))
    findings.extend(drift_findings())
    return finish_report("locks", files, findings, allowlist)
