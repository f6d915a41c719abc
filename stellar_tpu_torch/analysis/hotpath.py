"""Hot-path sync/setup lint: AST pass over the kernel wrappers, the plain
versions and the dispatch layer.

Two hazard families the port's verify and hash paths must stay free of:

* **host-sync hazards** (device files, ``stellar_tpu_torch/ops/``): a
  kernel wrapper promises to launch "on the current stream (no
  synchronise)", and a plain version must compute without reading its
  data back, or the interval prover (:mod:`.intervals`) cannot interpret
  it. The rule flags ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``np.asarray``/``np.array`` of a tensor and
  ``float()/int()/bool()`` of a tensor, and Python control flow
  (``if``/``while``/``for range()``/``assert``) that branches on tensor
  data. An explicit device wait, ``torch.cuda.synchronize()`` or
  ``Event.synchronize()``, is flagged wherever it sits, in the device
  files and in the dispatch files alike: it stalls the host until the
  card drains.
* **per-call setup** (device + dispatch files): the counterpart of the
  reference's retrace hazard, a ``jax.jit`` wrapper built inside a
  function body. Here it is loading a kernel library (``_build.library``,
  ``ctypes.CDLL``) or compiling a function (``torch.compile``,
  ``torch.jit.script``/``trace``) inside a function body: unless a
  module-level cache keeps the result, every call pays the load or the
  compile again.

Taint model, as the reference's: function parameters are tensors of
unknown value unless they carry a constant default (static config); names
assigned from tainted expressions become tainted; shape-carrying
accessors (``.shape``/``.ndim``/``.dtype``/``.device``, ``.size()``,
``.dim()``, ``.numel()``, ``len()``, ``is None``, ``isinstance``)
launder taint — branching on shapes is static and safe.

Findings are filtered through the reviewed allowlist below; every entry
carries a written safety argument.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from stellar_tpu_torch.analysis.lint_base import (
    Allowlist, Finding, LintReport, finish_report, repo_root, walk_py,
)

__all__ = ["run", "lint_source", "SCOPE_DEVICE", "SCOPE_HOST",
           "ALLOWLIST"]

# Files whose function bodies are the kernel wrappers, the plain versions
# and their host helpers.
SCOPE_DEVICE = ["stellar_tpu_torch/ops"]
# The dispatch layer: the generic batch engine, its two plugin modules,
# and the kernels' build and launch (host code under ops/, taken out of
# the device files). Device waits and per-call setup only.
SCOPE_HOST = [
    "stellar_tpu_torch/crypto/batch_verifier.py",
    "stellar_tpu_torch/crypto/batch_hasher.py",
    "stellar_tpu_torch/parallel/batch_engine.py",
    "stellar_tpu_torch/ops/_build.py",
]

_SYNC_NP_FUNCS = {"asarray", "array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_BUILTINS = {"float", "int", "bool"}
_WAIT_METHODS = {"synchronize"}
_SHAPEISH_ATTRS = {"ndim", "shape", "dtype", "device", "size", "dim",
                   "numel", "is_cuda", "layout"}
_LAUNDER_CALLS = {"len", "isinstance", "hasattr", "getattr", "type"}
# the wrappers' operand check returns (device, rows), read off the
# operands' .device and .shape: static, like a shape accessor
_SHAPE_HELPERS = {"check_operands"}
# torch.<name>(...) makes a tensor — device data, as a parameter is —
# except these, which make no tensor
_TORCH_NON_TENSOR = {"device", "Size", "Generator", "get_default_dtype",
                     "is_tensor"}
_COMPILE_ATTRS = {("torch", "compile"), ("jit", "script"),
                  ("jit", "trace")}
_LOAD_CALLS = {("_build", "library"), ("ctypes", "CDLL")}

# file -> {finding-key: written safety argument}
ALLOWLIST = Allowlist({
    "stellar_tpu_torch/ops/field25519.py": {
        "traced-branch:_pow2k.k":
            "k is a Python int at every call site (the literal exponents "
            "of the inversion chain): the loop count is fixed by the "
            "code, not by any tensor's value.",
        "host-sync:to_int.cpu":
            "to_int is the documented test helper that turns limbs into "
            "Python ints AFTER a result is computed; no kernel path and "
            "no plain version calls it.",
        "host-sync:to_int.numpy":
            "the same test helper as to_int.cpu: it reads a finished "
            "result on the host, outside every kernel path.",
        "host-sync:to_int.np.asarray":
            "the same test helper as to_int.cpu, for a numpy operand: a "
            "host array already, no device copy.",
        "host-sync:from_int.np.array":
            "from_int is the documented host helper turning a Python int "
            "into a limb vector: its operand is a Python int (module "
            "constants and host values), never a tensor.",
    },
    "stellar_tpu_torch/ops/edwards.py": {
        "traced-branch:_unstack_points.n":
            "n is a Python int, the stack width, a literal at every call "
            "site: a fixed unrolling, not data-dependent control flow.",
        "traced-branch:_extended_multiples.entries":
            "entries is the table size, a module constant "
            "(TABLE_ENTRIES32) at every call site, and the ladder's "
            "rounds and lists are Python ints from it: fixed by the "
            "code, never a tensor's value.",
        "traced-branch:_extended_multiples.dbl_src":
            "dbl_src lists the Python int multiples still to double, "
            "drawn from the table size: the same fixed ladder as "
            "_extended_multiples.entries.",
        "traced-branch:_extended_multiples.add_src":
            "add_src lists the Python int multiples still to add, drawn "
            "from the table size: the same fixed ladder as "
            "_extended_multiples.entries.",
        "traced-branch:_affine_multiples_host.entries":
            "the host-side function that builds the constant B-table: entries is "
            "a module constant and the loop runs on Python ints before "
            "any launch.",
    },
    "stellar_tpu_torch/ops/verify.py": {
        "traced-branch:verify_kernel_sharded.devs":
            "devs is the list of device names K4's factory is given, "
            "checked once when the callable is made: no tensor's value.",
    },
    "stellar_tpu_torch/ops/sha256.py": {
        "traced-branch:pack_messages.max_blocks":
            "pack_messages is the host-side packing helper: it walks "
            "Python bytes before any launch, and max_blocks is the "
            "plugin's Python int block capacity.",
        "host-sync:digest_words_to_bytes.np.asarray":
            "the host-side decoder of a digest row the engine has already "
            "fetched: its operand is a numpy row, so the asarray is a "
            "dtype view of host memory, not a device copy.",
    },
    "stellar_tpu_torch/ops/_build.py": {
        "setup-in-func:_load.ctypes.CDLL":
            "_load IS the module-level cache's fill: library() calls it "
            "once a library under that library's lock and keeps the "
            "handle in _libs, so the dlopen runs once a process.",
    },
    "stellar_tpu_torch/parallel/batch_engine.py": {
        "setup-in-func:prepare._build.library":
            "Workload.prepare runs once a (plugin, device) pair: the "
            "engine remembers it in _prepared, and _build.library "
            "returns the cached handle on any later call.",
        "host-sync:_fetch.synchronize":
            "the engine's one deliberate wait: _fetch runs on a "
            "WatchdogPool worker under the deadline (DEADLINE_MS), never "
            "on the launching thread, so the launch path stays "
            "asynchronous and a wedged card costs a missed deadline, not "
            "a hang.",
    },
})


def _is_shapeish(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and node.attr in _SHAPEISH_ATTRS)


def _dotted(node: ast.AST) -> Optional[tuple]:
    """``a.b`` -> ("a", "b"), for the last two parts of an attribute."""
    if isinstance(node, ast.Attribute):
        base = node.value
        if isinstance(base, ast.Name):
            return (base.id, node.attr)
        if isinstance(base, ast.Attribute):
            return (base.attr, node.attr)
    return None


class _FuncLinter:
    """Intraprocedural taint pass over one function body."""

    def __init__(self, fname: str, rel: str, device_file: bool,
                 findings: List[Finding]):
        self.fname = fname
        self.rel = rel
        self.device = device_file
        self.findings = findings
        self.taint: Set[str] = set()

    # --- taint of an expression ---

    def _expr_tainted(self, node: ast.AST) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.taint
        if _is_shapeish(node):
            return False  # shapes are static
        if isinstance(node, ast.Attribute):
            return self._expr_tainted(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in _LAUNDER_CALLS:
                return False
            if _is_shapeish(fn):
                return False  # x.size(), x.dim(), x.numel()
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _SHAPE_HELPERS:
                return False
            if isinstance(fn, ast.Attribute) and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id == "torch":
                return fn.attr not in _TORCH_NON_TENSOR
            parts = [fn] + list(node.args) + \
                [kw.value for kw in node.keywords]
            return any(self._expr_tainted(p) for p in parts)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False  # `x is None` guards are structural
            return any(self._expr_tainted(c)
                       for c in [node.left] + list(node.comparators))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.comprehension)):
                if self._expr_tainted(child):
                    return True
        return False

    # --- rules ---

    def _emit(self, node: ast.AST, rule: str, symbol: str, msg: str):
        self.findings.append(Finding(
            file=self.rel, line=getattr(node, "lineno", 0), rule=rule,
            symbol=symbol, message=msg))

    def _check_wait_call(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _WAIT_METHODS:
            self._emit(node, "host-sync", f"{self.fname}.{fn.attr}",
                       f".{fn.attr}() waits for the card to drain: the "
                       "host stalls and the launch pipeline empties")

    def _check_sync_call(self, node: ast.Call):
        fn = node.func
        args_tainted = any(self._expr_tainted(a) for a in node.args)
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "np" \
                and fn.attr in _SYNC_NP_FUNCS and args_tainted:
            self._emit(node, "host-sync",
                       f"{self.fname}.np.{fn.attr}",
                       f"np.{fn.attr} of a tensor copies it to the host "
                       "(a CUDA tensor waits for the card first)")
        elif isinstance(fn, ast.Attribute) and \
                fn.attr in _SYNC_METHODS and \
                self._expr_tainted(fn.value):
            self._emit(node, "host-sync",
                       f"{self.fname}.{fn.attr}",
                       f".{fn.attr}() of a tensor copies it to the host "
                       "and waits for the card")
        elif isinstance(fn, ast.Name) and fn.id in _SYNC_BUILTINS and \
                args_tainted:
            self._emit(node, "host-sync",
                       f"{self.fname}.{fn.id}",
                       f"{fn.id}() of a tensor reads its value on the "
                       "host and waits for the card")

    def _check_setup_call(self, node: ast.Call):
        dotted = _dotted(node.func)
        if dotted in _LOAD_CALLS:
            what = "loads a kernel library"
        elif dotted in _COMPILE_ATTRS:
            what = "compiles a function"
        else:
            return
        self._emit(node, "setup-in-func",
                   f"{self.fname}.{dotted[0]}.{dotted[1]}",
                   f"{dotted[0]}.{dotted[1]}() inside a function body "
                   f"{what} on every call unless a module-level cache "
                   "keeps the result")

    def _check_setup_decorators(self, fnode) -> None:
        """A nested def decorated with ``@torch.compile`` or
        ``@torch.jit.script`` compiles anew each time the enclosing
        function runs."""
        for dec in fnode.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            dotted = _dotted(target)
            if dotted in _COMPILE_ATTRS:
                self._emit(dec, "setup-in-func",
                           f"{self.fname}.{fnode.name}.{dotted[0]}."
                           f"{dotted[1]}",
                           "decorated nested def compiles anew on every "
                           "call of the enclosing function")

    def run(self, fnode: ast.FunctionDef):
        # parameters without a constant default are tensors of unknown
        # value
        args = fnode.args
        all_args = (args.posonlyargs + args.args + args.kwonlyargs)
        defaults = ([None] * (len(args.posonlyargs) + len(args.args)
                              - len(args.defaults))
                    + list(args.defaults) + list(args.kw_defaults))
        for a, d in zip(all_args, defaults):
            if a.arg in ("self", "cls"):
                continue
            if d is not None and isinstance(d, ast.Constant):
                continue  # static config default
            if d is not None and isinstance(d, ast.Tuple) and \
                    all(isinstance(e, ast.Constant) for e in d.elts):
                continue
            self.taint.add(a.arg)
        if args.vararg:
            self.taint.add(args.vararg.arg)
        if args.kwarg:
            self.taint.add(args.kwarg.arg)

        # two forward passes so loop-carried taint converges
        for _ in range(2):
            for node in self._walk_own(fnode):
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    value = getattr(node, "value", None)
                    if value is None or not self._expr_tainted(value):
                        continue
                    targets = node.targets if isinstance(
                        node, ast.Assign) else [node.target]
                    for t in targets:
                        self._taint_target(t)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    if self._expr_tainted(node.iter):
                        self._taint_target(node.target)

        for node in self._walk_own(fnode):
            if isinstance(node, ast.Call):
                self._check_wait_call(node)
                if self.device:
                    self._check_sync_call(node)
                self._check_setup_call(node)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                # nested def: its body is the nested linter's scope, but
                # ITS decorators evaluate in THIS scope, per call
                self._check_setup_decorators(node)
            elif self.device and isinstance(node, (ast.If, ast.While)):
                if self._expr_tainted(node.test):
                    sym = self._cond_symbol(node.test)
                    self._emit(
                        node, "traced-branch", f"{self.fname}.{sym}",
                        "Python branch on a tensor's value: reads it on "
                        "the host (a CUDA tensor waits for the card), and "
                        "the interval prover cannot interpret it")
            elif self.device and isinstance(node, ast.Assert):
                if self._expr_tainted(node.test):
                    sym = self._cond_symbol(node.test)
                    self._emit(
                        node, "traced-branch", f"{self.fname}.{sym}",
                        "assert on a tensor's value in device code")
            elif self.device and isinstance(node, ast.For):
                if self._range_tainted(node.iter):
                    sym = self._cond_symbol(node.iter)
                    self._emit(
                        node, "traced-branch", f"{self.fname}.{sym}",
                        "Python loop with a data-dependent trip count "
                        "(range over a tensor's value) in device code")
            elif self.device and isinstance(
                    node, (ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp)):
                for comp in node.generators:
                    if self._range_tainted(comp.iter):
                        sym = self._cond_symbol(comp.iter)
                        self._emit(
                            node, "traced-branch",
                            f"{self.fname}.{sym}",
                            "comprehension with a data-dependent trip "
                            "count (range over a tensor's value) in "
                            "device code")

    def _range_tainted(self, it: ast.AST) -> bool:
        """True for ``range(<tainted>)``-shaped iterators: the trip count
        itself is data-dependent. Iterating a tuple or zip of tensors is
        a fixed-width unrolling and is NOT flagged."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("range", "reversed"):
            return any(self._expr_tainted(a) for a in it.args)
        return False

    @staticmethod
    def _walk_own(fnode: ast.FunctionDef):
        """Walk a function body in SOURCE ORDER without descending into
        nested function definitions (each nested def gets its own linter
        scope). Source order matters: the taint passes are forward
        dataflow."""
        stack = list(reversed(list(ast.iter_child_nodes(fnode))))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue
            stack.extend(reversed(list(ast.iter_child_nodes(node))))

    def _taint_target(self, t: ast.AST):
        """Taint assignment-target names: a subscripted target taints its
        base container, never the index expression's names."""
        if isinstance(t, ast.Name):
            self.taint.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._taint_target(e)
        elif isinstance(t, ast.Starred):
            self._taint_target(t.value)
        elif isinstance(t, (ast.Subscript, ast.Attribute)):
            base = t.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name):
                self.taint.add(base.id)

    def _cond_symbol(self, node: ast.AST) -> str:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in self.taint:
                return n.id
        return "<expr>"


def _lint_tree(tree: ast.Module, rel: str, device_file: bool,
               findings: List[Finding]):
    # every function, nested defs included, each with its own taint scope
    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                _FuncLinter(child.name, rel, device_file,
                            findings).run(child)
            visit(child)
    visit(tree)


def lint_source(src: str, rel: str,
                device_file: bool = True) -> List[Finding]:
    """Lint one source text (unit-test hook)."""
    findings: List[Finding] = []
    _lint_tree(ast.parse(src), rel, device_file, findings)
    return findings


def run(allowlist: Optional[Allowlist] = None) -> LintReport:
    allowlist = allowlist or ALLOWLIST
    root = repo_root()
    findings: List[Finding] = []
    files = 0
    for paths, device in ((SCOPE_DEVICE, True), (SCOPE_HOST, False)):
        for path in walk_py(paths, root):
            rel = str(path.relative_to(root))
            if device and rel in SCOPE_HOST:
                continue  # host code under ops/: linted as host
            files += 1
            _lint_tree(ast.parse(path.read_text()), rel, device, findings)
    return finish_report("hotpath", files, findings, allowlist)
