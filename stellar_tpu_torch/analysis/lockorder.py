"""Whole-program lock-order prover: cycle detection + hold-and-block.

The lock lint (:mod:`stellar_tpu_torch.analysis.locks`) proves
mutation-under-lock inside one module; this pass machine-checks lock
ORDERING across the port's fleet -> verify_service -> batch_engine ->
device_health/metrics/tracing call chain, and flags blocking work done
while a lock is held, over the full ``locks.SCOPE``:

1. **Lock recovery** — every module-level ``threading.Lock/RLock/
   Condition`` and every ``self.<attr>`` lock assigned in a class body
   becomes a graph node (instance locks unify per class: two
   VerifyService replicas share the node ``VerifyService._cv``).
2. **Call resolution** — calls made lexically inside a ``with <lock>``
   region resolve across module boundaries: ``self.method``,
   module-level functions, imported-module functions, module-level
   singletons (``registry.meter``, ``slo_monitor.note_completion``) and
   the known engine/service/fleet seams (``rep["service"].submit``,
   ``self._verifier.submit``) via :data:`RECEIVER_HINTS`. Unresolvable
   calls are skipped: the documented soundness limit.
3. **Acquisition graph** — holding L and (directly, or transitively
   through resolved calls) acquiring M adds the edge ``L -> M`` with
   its full call path. Any cycle is a deadlock finding printing every
   edge's acquisition path.
4. **Hold-and-block** — known-blocking operations (``cv.wait()``
   without a timeout, ``Queue.get()``/``join()`` without a timeout,
   ``time.sleep``, subprocess calls, socket I/O, device waits —
   ``torch.cuda.synchronize()``, ``Event.synchronize()``, ``.cpu()`` and
   ``.item()`` — and ``Executor.shutdown(wait=True)``) reachable while
   ANY lock is held are findings; each needs a written safety argument
   in :data:`ALLOWLIST` or a fix.

Deliberate lexical conventions shared with the lock lint: nested
``def``/``lambda`` bodies run later, possibly outside the lock, so they
are analyzed as separate functions with nothing held; ``*_locked``
helpers are entered with their lock already held by the caller, which is
exactly how the call-through analysis reaches them.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from stellar_tpu_torch.analysis.lint_base import (
    Allowlist, Finding, LintReport, finish_report, repo_root,
)
from stellar_tpu_torch.analysis.locks import SCOPE, _LOCK_CTORS

__all__ = ["run", "run_sources", "build_graph", "SCOPE",
           "ALLOWLIST", "RECEIVER_HINTS", "BLOCKING_KINDS"]

# ---------------- known seams ----------------
# Receiver-name → (module rel path, class) typing for attribute calls
# the pure syntactic resolver cannot see through. These are the
# engine/service/fleet seams the threaded tier actually crosses; the
# table is part of the pass's documented contract (§5) — a new seam
# must be added here to be traversed.
RECEIVER_HINTS: Dict[str, Tuple[str, str]] = {
    # VerifyService / FleetRouter hold a verifier; in the fleet it is
    # the SharedVerifier adapter, whose own module edge covers the
    # engine side — the direct hint covers the single-service wiring.
    "_verifier": ("stellar_tpu_torch/crypto/batch_verifier.py",
                  "BatchVerifier"),
    # fleet replica records and the service module's own helpers pass
    # services around as `svc` / rep["service"]
    "svc": ("stellar_tpu_torch/crypto/verify_service.py", "VerifyService"),
    "service": ("stellar_tpu_torch/crypto/verify_service.py",
                "VerifyService"),
}

BLOCKING_KINDS = ("wait-untimed", "join-untimed", "queue-get", "sleep",
                  "subprocess", "socket", "device-fetch",
                  "executor-shutdown")

_SOCKET_OPS = {"recv", "recvfrom", "accept", "sendall",
               "create_connection"}
_SUBPROCESS_OPS = {"run", "Popen", "call", "check_call",
                   "check_output", "communicate"}
# The port's device waits: torch.cuda.synchronize(), Event.synchronize()
# and Stream.synchronize() block the host until the card drains, and
# .cpu() / .item() of a CUDA tensor copy a result back, waiting for it.
# A call on a CPU tensor cannot be told apart from here: it is flagged
# all the same, and argued in ALLOWLIST if it is one.
_DEVICE_FETCH_OPS = {"synchronize", "cpu", "item"}

ALLOWLIST = Allowlist({
    "stellar_tpu_torch/utils/resilience.py": {
        "hold-and-block:WatchdogPool._loop.wait-untimed":
            "an IDLE pool worker parking on its own condition until a "
            "job arrives: Condition.wait releases the cv while parked, "
            "the daemon worker holds no other lock, and submit() "
            "notifies under the same cv; an unbounded park here is the "
            "pool's steady state, not a hang.",
    },
    "stellar_tpu_torch/utils/native.py": {
        "hold-and-block:_load.build_library.subprocess":
            "one-shot compile-and-dlopen serialization: the module lock "
            "exists so that one thread runs g++ while late arrivals wait "
            "for the cached library; build_library bounds the compile "
            "(subprocess timeout) and it runs once a process.",
    },
    "stellar_tpu_torch/crypto/native_prep.py": {
        "hold-and-block:_load.build_library.subprocess":
            "the same one-shot compile serialization as utils/native.py: "
            "the module lock makes the bounded g++ build happen once; "
            "every later call returns the cached library and never "
            "blocks.",
    },
    "stellar_tpu_torch/crypto/native_verify.py": {
        "hold-and-block:_load.build_library.subprocess":
            "the same one-shot compile serialization as utils/native.py, "
            "for the host oracle: a bounded g++ build once a process, a "
            "cached library after.",
    },
    "stellar_tpu_torch/soroban/native_wasm.py": {
        "hold-and-block:_load._build_lib.subprocess":
            "one-shot compile serialization (build_library's file lock "
            "and rename protect concurrent PROCESSES; this lock "
            "serializes threads): the bounded g++ build runs once a "
            "process.",
        "hold-and-block:_load_ext._build_lib.subprocess":
            "the same one-shot compile serialization as _load, for the "
            "CPython extension: bounded, once a process, before any "
            "dispatch thread can contend.",
    },
})


def _name_of(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    return _name_of(node.func) in _LOCK_CTORS


# ---------------- module model ----------------

class _Module:
    """Syntactic model of one scoped module: its locks, functions,
    classes, singletons, and import aliases."""

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.tree = tree
        self.module_locks: Set[str] = set()
        self.funcs: Dict[str, ast.AST] = {}       # qual -> def node
        self.func_class: Dict[str, Optional[str]] = {}
        self.class_locks: Dict[str, Set[str]] = {}
        self.instances: Dict[str, str] = {}       # global -> class name
        self.mod_aliases: Dict[str, str] = {}     # alias -> module rel
        self.obj_aliases: Dict[str, Tuple[str, str]] = {}  # name ->
        #                                   (module rel, name there)
        self._collect()

    def _collect(self) -> None:
        classes = [n for n in self.tree.body
                   if isinstance(n, ast.ClassDef)]
        class_names = {c.name for c in classes}
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                if _is_lock_ctor(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks.add(t.id)
                elif isinstance(node.value, ast.Call):
                    ctor = _name_of(node.value.func)
                    if ctor in class_names:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                self.instances[t.id] = ctor
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.funcs[node.name] = node
                self.func_class[node.name] = None
        for cnode in classes:
            locks: Set[str] = set()
            for node in ast.walk(cnode):
                if isinstance(node, ast.Assign) and \
                        _is_lock_ctor(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            locks.add(t.attr)
            self.class_locks[cnode.name] = locks
            for node in cnode.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    qual = f"{cnode.name}.{node.name}"
                    self.funcs[qual] = node
                    self.func_class[qual] = cnode.name

    def index_imports(self, world: Dict[str, "_Module"]) -> None:
        """Map import aliases to scoped modules / their objects. Only
        names that land on another module in the analyzed world
        resolve; everything else is out of scope by design."""
        by_tail: Dict[str, str] = {}
        for rel in world:
            by_tail[rel[:-3].replace("/", ".")] = rel
            by_tail.setdefault(
                pathlib.PurePosixPath(rel).stem, rel)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    rel = by_tail.get(a.name)
                    if rel:
                        self.mod_aliases[a.asname or
                                         a.name.split(".")[0]] = rel
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    local = a.asname or a.name
                    rel = by_tail.get(full)
                    if rel:
                        self.mod_aliases[local] = rel
                        continue
                    src_rel = by_tail.get(node.module)
                    if src_rel:
                        self.obj_aliases[local] = (src_rel, a.name)


# ---------------- the interprocedural pass ----------------

class _World:
    """The analyzed program: every scoped module, the acquisition
    graph, and the per-function acquire/block summaries."""

    def __init__(self, sources: Dict[str, str]):
        self.modules: Dict[str, _Module] = {}
        self.parse_errors: List[str] = []
        for rel, src in sources.items():
            try:
                self.modules[rel] = _Module(rel, ast.parse(src))
            except SyntaxError as e:  # pragma: no cover - guard
                self.parse_errors.append(f"{rel}: {e}")
        for m in self.modules.values():
            m.index_imports(self.modules)
        # fkey = (rel, qual)
        self._acq: Dict[tuple, Dict[str, list]] = {}
        self._blk: Dict[tuple, Dict[str, tuple]] = {}
        # lock -> lock -> example path (list of strings)
        self.edges: Dict[str, Dict[str, list]] = {}
        self.findings: List[Finding] = []

    # ---------- naming ----------

    def lock_id(self, rel: str, owner: Optional[str],
                attr: str) -> str:
        short = rel.rsplit("/", 1)[-1][:-3]
        return f"{short}.{owner}.{attr}" if owner else f"{short}.{attr}"

    # ---------- resolution ----------

    def resolve_receiver(self, node: ast.AST, mod: _Module,
                         cls: Optional[str]
                         ) -> Optional[Tuple[str, str]]:
        """(module rel, class name) a receiver expression denotes."""
        if isinstance(node, ast.Name):
            if node.id == "self" and cls:
                return (mod.rel, cls)
            if node.id in mod.instances:
                return (mod.rel, mod.instances[node.id])
            if node.id in mod.obj_aliases:
                src_rel, name = mod.obj_aliases[node.id]
                src = self.modules.get(src_rel)
                if src and name in src.instances:
                    return (src_rel, src.instances[name])
            if node.id in RECEIVER_HINTS:
                return RECEIVER_HINTS[node.id]
            return None
        if isinstance(node, ast.Attribute):
            # alias.obj  (tenant_mod.tenant_slo)
            if isinstance(node.value, ast.Name) and \
                    node.value.id in mod.mod_aliases:
                src = self.modules.get(mod.mod_aliases[node.value.id])
                if src and node.attr in src.instances:
                    return (src.rel, src.instances[node.attr])
            if node.attr in RECEIVER_HINTS:
                return RECEIVER_HINTS[node.attr]
            return None
        if isinstance(node, ast.Subscript):
            # rep["service"]
            sl = node.slice
            if isinstance(sl, ast.Constant) and \
                    isinstance(sl.value, str) and \
                    sl.value in RECEIVER_HINTS:
                return RECEIVER_HINTS[sl.value]
        return None

    def resolve_call(self, call: ast.Call, mod: _Module,
                     cls: Optional[str]) -> Optional[tuple]:
        """(module rel, qualname) of a call target, or None."""
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in mod.funcs:
                return (mod.rel, fn.id)
            if fn.id in mod.obj_aliases:
                src_rel, name = mod.obj_aliases[fn.id]
                src = self.modules.get(src_rel)
                if src and name in src.funcs:
                    return (src_rel, name)
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        recv = fn.value
        # module-level function via module alias
        if isinstance(recv, ast.Name) and recv.id in mod.mod_aliases:
            src = self.modules.get(mod.mod_aliases[recv.id])
            if src and fn.attr in src.funcs and \
                    src.func_class.get(fn.attr) is None:
                return (src.rel, fn.attr)
        target = self.resolve_receiver(recv, mod, cls)
        if target is not None:
            t_rel, t_cls = target
            t_mod = self.modules.get(t_rel)
            if t_mod is not None:
                qual = f"{t_cls}.{fn.attr}"
                if qual in t_mod.funcs:
                    return (t_rel, qual)
        return None

    def lock_of_with_item(self, expr: ast.AST, mod: _Module,
                          cls: Optional[str]) -> Optional[str]:
        if isinstance(expr, ast.Name) and expr.id in mod.module_locks:
            return self.lock_id(mod.rel, None, expr.id)
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Name) and \
                    recv.id in mod.mod_aliases:
                src = self.modules.get(mod.mod_aliases[recv.id])
                if src and expr.attr in src.module_locks:
                    return self.lock_id(src.rel, None, expr.attr)
            target = self.resolve_receiver(recv, mod, cls)
            if target is not None:
                t_rel, t_cls = target
                t_mod = self.modules.get(t_rel)
                if t_mod and expr.attr in \
                        t_mod.class_locks.get(t_cls, set()):
                    return self.lock_id(t_rel, t_cls, expr.attr)
        return None

    # ---------- blocking-op classification ----------

    @staticmethod
    def blocking_kind(call: ast.Call) -> Optional[str]:
        fn = call.func
        name = _name_of(fn)
        has_args = bool(call.args) or bool(call.keywords)
        kw = {k.arg for k in call.keywords}
        if name == "wait" and isinstance(fn, ast.Attribute) and \
                not call.args and "timeout" not in kw:
            return "wait-untimed"
        if name == "join" and isinstance(fn, ast.Attribute) and \
                not has_args:
            return "join-untimed"
        if name == "get" and isinstance(fn, ast.Attribute) and \
                not call.args and not kw:
            return "queue-get"
        if name == "sleep" and isinstance(fn, ast.Attribute) and \
                _name_of(fn.value) in ("time", "_time"):
            return "sleep"
        if isinstance(fn, ast.Attribute) and (
                (_name_of(fn.value) == "subprocess"
                 and name in _SUBPROCESS_OPS)
                or name == "communicate"):
            return "subprocess"
        if name in _SOCKET_OPS:
            return "socket"
        if isinstance(fn, ast.Attribute) and name in _DEVICE_FETCH_OPS \
                and not call.args:
            return "device-fetch"
        if name == "shutdown" and isinstance(fn, ast.Attribute):
            waits = True
            for k in call.keywords:
                if k.arg == "wait" and \
                        isinstance(k.value, ast.Constant):
                    waits = bool(k.value.value)
            if call.args and isinstance(call.args[0], ast.Constant):
                waits = bool(call.args[0].value)
            if waits:
                return "executor-shutdown"
        return None

    # ---------- per-function summaries ----------

    def _fnode(self, fkey: tuple):
        mod = self.modules.get(fkey[0])
        return mod, (mod.funcs.get(fkey[1]) if mod else None)

    def _stmt_calls(self, node: ast.AST):
        """Calls in this statement's expressions, skipping nested
        defs/lambdas (deferred execution — analyzed separately)."""
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.expr):
                yield from self._expr_calls(sub)

    def _expr_calls(self, node: ast.AST):
        if isinstance(node, (ast.Lambda,)):
            return
        if isinstance(node, ast.Call):
            yield node
        for sub in ast.iter_child_nodes(node):
            yield from self._expr_calls(sub)

    def summaries(self, fkey: tuple, stack: frozenset = frozenset()
                  ) -> Tuple[Dict[str, list], Dict[str, tuple]]:
        """(acquires, blocks) reachable from calling ``fkey``:
        acquires maps lock -> example path; blocks maps blocking kind
        -> (example path, line)."""
        if fkey in self._acq:
            return self._acq[fkey], self._blk[fkey]
        if fkey in stack:  # recursion
            return {}, {}
        mod, node = self._fnode(fkey)
        if node is None:
            return {}, {}
        stack = stack | {fkey}
        acq: Dict[str, list] = {}
        blk: Dict[str, tuple] = {}
        cls = mod.func_class.get(fkey[1])
        here = f"{mod.rel}:{fkey[1]}"

        def visit(n: ast.AST):
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue  # deferred body: separate analysis
                if isinstance(child, ast.With):
                    for item in child.items:
                        lk = self.lock_of_with_item(
                            item.context_expr, mod, cls)
                        if lk is not None:
                            acq.setdefault(lk, [
                                f"{here}:{child.lineno} acquires "
                                f"{lk}"])
                if isinstance(child, ast.stmt):
                    for call in self._stmt_calls(child):
                        kind = self.blocking_kind(call)
                        if kind is not None:
                            blk.setdefault(kind, (
                                [f"{here}:{call.lineno} {kind}"],
                                call.lineno))
                        tgt = self.resolve_call(call, mod, cls)
                        if tgt is not None:
                            a2, b2 = self.summaries(tgt, stack)
                            step = (f"{here}:{call.lineno} calls "
                                    f"{tgt[1]}")
                            for lk, path in a2.items():
                                acq.setdefault(lk, [step] + path)
                            for kd, (path, ln) in b2.items():
                                blk.setdefault(kd,
                                               ([step] + path, ln))
                visit(child)

        visit(node)
        self._acq[fkey] = acq
        self._blk[fkey] = blk
        return acq, blk

    # ---------- the main walk ----------

    def analyze(self) -> None:
        for rel, mod in sorted(self.modules.items()):
            for qual, node in sorted(mod.funcs.items()):
                self._analyze_function(mod, qual, node)

    def _edge(self, src: str, dst: str, path: List[str]) -> None:
        self.edges.setdefault(src, {}).setdefault(dst, path)

    def _analyze_function(self, mod: _Module, qual: str,
                          fnode: ast.AST) -> None:
        cls = mod.func_class.get(qual)
        here = f"{mod.rel}:{qual}"

        def scan(node: ast.AST, held: List[tuple]):
            # held: [(lock id, with line)]
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue  # deferred body, runs with nothing held
                inner = held
                if isinstance(child, ast.With):
                    got = []
                    for item in child.items:
                        lk = self.lock_of_with_item(
                            item.context_expr, mod, cls)
                        if lk is not None:
                            got.append((lk, child.lineno))
                    for lk, ln in got:
                        for hl, hln in held:
                            if hl != lk:
                                self._edge(hl, lk, [
                                    f"{here}:{hln} holds {hl}",
                                    f"{here}:{ln} acquires {lk}"])
                    inner = held + got
                if isinstance(child, ast.stmt) and held:
                    self._check_stmt(child, mod, cls, qual, here,
                                     held)
                scan(child, inner)

        scan(fnode, [])

    def _check_stmt(self, stmt: ast.stmt, mod: _Module,
                    cls: Optional[str], qual: str, here: str,
                    held: List[tuple]) -> None:
        held_names = [h for h, _ in held]
        for call in self._stmt_calls(stmt):
            kind = self.blocking_kind(call)
            if kind is not None and not self._wait_on_own_cv_timed(
                    call):
                self.findings.append(Finding(
                    file=mod.rel, line=call.lineno,
                    rule="hold-and-block",
                    symbol=f"{qual}.{kind}",
                    message=f"{kind} while holding "
                            f"{held_names} — blocking work under a "
                            f"lock wedges every contender"))
            tgt = self.resolve_call(call, mod, cls)
            if tgt is None:
                continue
            acq, blk = self.summaries(tgt)
            step = f"{here}:{call.lineno} calls {tgt[1]}"
            for lk, path in acq.items():
                for hl, hln in held:
                    if hl != lk:
                        self._edge(hl, lk, [
                            f"{here}:{hln} holds {hl}", step] + path)
            for kd, (path, _ln) in blk.items():
                self.findings.append(Finding(
                    file=mod.rel, line=call.lineno,
                    rule="hold-and-block",
                    symbol=f"{qual}.{tgt[1]}.{kd}",
                    message=f"{kd} reachable while holding "
                            f"{held_names} via "
                            f"{' -> '.join([step] + path)}"))

    @staticmethod
    def _wait_on_own_cv_timed(call: ast.Call) -> bool:
        """cv.wait(timeout) is bounded AND releases its own cv — never
        a finding (the untimed spelling is classified upstream)."""
        return False

    # ---------- cycles ----------

    def cycle_findings(self) -> List[Finding]:
        out: List[Finding] = []
        seen: Set[tuple] = set()
        for start in sorted(self.edges):
            cyc = self._find_cycle(start)
            if not cyc:
                continue
            canon = tuple(sorted(cyc))
            if canon in seen:
                continue
            seen.add(canon)
            parts = []
            for i, src in enumerate(cyc):
                dst = cyc[(i + 1) % len(cyc)]
                path = self.edges[src][dst]
                parts.append(f"[{src} -> {dst}] " + " -> ".join(path))
            sym = "->".join(cyc + [cyc[0]])
            out.append(Finding(
                file=self._lock_file(cyc[0]), line=1,
                rule="lock-cycle", symbol=sym,
                message="lock-acquisition cycle (potential "
                        "deadlock): " + " ; ".join(parts)))
        return out

    def _lock_file(self, lock: str) -> str:
        short = lock.split(".", 1)[0]
        for rel in self.modules:
            if rel.rsplit("/", 1)[-1][:-3] == short:
                return rel
        return short

    def _find_cycle(self, start: str) -> Optional[List[str]]:
        stack: List[str] = []
        on_stack: Set[str] = set()
        visited: Set[str] = set()

        def dfs(n: str) -> Optional[List[str]]:
            stack.append(n)
            on_stack.add(n)
            for m in sorted(self.edges.get(n, {})):
                if m == n:
                    return [n]  # self-cycle (re-entrant acquire)
                if m in on_stack:
                    return stack[stack.index(m):]
                if m not in visited:
                    got = dfs(m)
                    if got:
                        return got
            stack.pop()
            on_stack.discard(n)
            visited.add(n)
            return None

        return dfs(start)

    def graph(self) -> dict:
        locks: Set[str] = set(self.edges)
        for dsts in self.edges.values():
            locks.update(dsts)
        for mod in self.modules.values():
            for name in mod.module_locks:
                locks.add(self.lock_id(mod.rel, None, name))
            for cname, lset in mod.class_locks.items():
                for name in lset:
                    locks.add(self.lock_id(mod.rel, cname, name))
        return {
            "modules": sorted(self.modules),
            "locks": sorted(locks),
            "edges": {src: sorted(dsts)
                      for src, dsts in sorted(self.edges.items())},
        }


# ---------------- entry points ----------------

def run_sources(sources: Dict[str, str]
                ) -> Tuple[List[Finding], dict]:
    """Analyze a source map (rel path -> text); unit-test hook.
    Returns (raw findings, acquisition graph)."""
    world = _World(sources)
    world.analyze()
    findings = world.findings + world.cycle_findings()
    return findings, world.graph()


def _scope_sources(scope: Sequence[str]) -> Dict[str, str]:
    root = repo_root()
    out: Dict[str, str] = {}
    for rel in scope:
        p = root / rel
        if p.exists():
            out[rel] = p.read_text()
    return out


def build_graph(scope: Optional[Sequence[str]] = None) -> dict:
    """The acquisition graph of the real tree (tests / --json)."""
    world = _World(_scope_sources(scope or SCOPE))
    world.analyze()
    return world.graph()


def run(allowlist: Optional[Allowlist] = None) -> LintReport:
    allowlist = allowlist or ALLOWLIST
    sources = _scope_sources(SCOPE)
    findings, _graph = run_sources(sources)
    return finish_report("lockorder", len(sources), findings,
                         allowlist)
