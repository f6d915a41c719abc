"""Helpers shared by the port's node-slice tests (``test_torch_ledger.py``,
``test_torch_tx_frame.py``, ``test_torch_tx_set.py``,
``test_torch_bucket.py``, ``test_torch_ledger_close.py``,
``test_torch_txmeta.py``, ``test_torch_catchup.py``,
``test_torch_persistence.py``, ``test_torch_scp.py``,
``test_torch_overlay.py``, ``test_torch_soroban.py``,
``test_torch_wasm.py``, ``test_torch_load_generator.py``): the source
comparison of a copied module
with the reference's, the carrying of XDR values and ledgers from the
port to the reference through their bytes (objects never cross the two
packages), ``chip_smoke.py``'s pinned constants, and the load
generator's harnesses run with each close recorded."""

import ast
import hashlib
import importlib
import re
from pathlib import Path

from stellar_tpu.ledger import ledger_txn as jlt
from stellar_tpu.xdr import ledger as jledger
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu_torch.xdr import ledger as pledger
from stellar_tpu_torch.xdr import runtime as prt

ROOT = Path(__file__).resolve().parent.parent

# What each partial copy leaves out, by top-level name and
# ``Class.method``; ROADMAP.md's queue 1 lists the same names.
PARTIAL = {
    "soroban/native_wasm.py": {"_LIB", "_ext_lib_path", "_build_lib"},
    "main/application.py": {
        "Application._apply_global_config", "Application._verify_health"},
    "main/fuzz.py": {"WasmFuzzer.__init__"},
    "main/cli.py": {"cmd_apply_load"},
    # the analysis gates: scope lists and allowlists name the port's files
    # and argue the port's code; the lock-order prover's device waits are
    # PyTorch's; the coverage gate maps to the port's goldens and names
    # the port's tool in its finding
    "analysis/locks.py": {"SCOPE", "ALLOWLIST"},
    "analysis/nondet.py": {"HOST_ORACLE_FILES", "ALLOWLIST"},
    "analysis/lockorder.py": {"ALLOWLIST", "_DEVICE_FETCH_OPS",
                              "_World.blocking_kind"},
    "analysis/coverage.py": {"PROOF_STAGES", "check"},
}

# The partial copies that define every name of their ``PARTIAL`` entry
# anew, the port's own version in place of the reference's (ROADMAP.md's
# divergences say why); those names are taken out of both sides.
REPLACED = {"main/application.py", "main/cli.py", "main/fuzz.py",
            "soroban/native_wasm.py", "analysis/locks.py",
            "analysis/nondet.py", "analysis/lockorder.py",
            "analysis/coverage.py"}

# The copies whose string constants name files and modules of the package
# (scopes, drift roots, import patterns, finding paths): with
# ``check_copy(rel, strings=True)`` the reference's package name is read
# as the port's in string constants too, as it is in imports.
_PACKAGE_WORD = re.compile(r"\bstellar_tpu\b")


class _Normalize(ast.NodeTransformer):
    """Drops docstrings and names the reference's package as the port's
    in import statements and in ``__import__`` calls (and, with
    ``strings``, in every string constant)."""

    def __init__(self, strings: bool = False):
        self.strings = strings

    def visit_Constant(self, node):
        if self.strings and isinstance(node.value, str):
            node.value = _PACKAGE_WORD.sub("stellar_tpu_torch", node.value)
        return node

    @staticmethod
    def _strip(node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    @staticmethod
    def _rename(name):
        if name == "stellar_tpu" or name.startswith("stellar_tpu."):
            return "stellar_tpu_torch" + name[len("stellar_tpu"):]
        return name

    def visit_Module(self, node):
        self.generic_visit(node)
        return self._strip(node)

    def visit_ClassDef(self, node):
        self.generic_visit(node)
        return self._strip(node)

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        return self._strip(node)

    def visit_ImportFrom(self, node):
        if node.module is not None:
            node.module = self._rename(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._rename(alias.name)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and \
                node.func.id == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            node.args[0].value = self._rename(node.args[0].value)
        return node


def chip_smoke_constants():
    """``chip_smoke.py``'s module-level literal constants, read with
    ``ast`` (the script is not imported)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def normalized(path: Path, strings: bool = False) -> ast.Module:
    return _Normalize(strings).visit(ast.parse(path.read_text()))


def module_paths(rel: str):
    return ROOT / "stellar_tpu" / rel, ROOT / "stellar_tpu_torch" / rel


def to_ref(t_port, t_ref, v):
    """A port XDR value as the reference's, through its bytes."""
    return jrt.from_bytes(t_ref, prt.to_bytes(t_port, v))


def header_to_ref(header):
    return to_ref(pledger.LedgerHeader, jledger.LedgerHeader, header)


def ref_root(port_root):
    """The reference's ``LedgerTxnRoot`` over the port root's store, byte
    for byte, and its header through its bytes."""
    store = jlt.InMemoryLedgerStore()
    store.entries = dict(port_root.store.entries)
    return jlt.LedgerTxnRoot(store, header_to_ref(port_root.header()))


def _names(node):
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _without(tree: ast.Module, names: set) -> ast.Module:
    """``tree`` less the top-level definitions and ``Class.method``s in
    ``names``, and less those names in ``__all__``; each must be there."""
    removed = set()

    def keep(node, prefix):
        gone = {prefix + n for n in _names(node)} & names
        removed.update(gone)
        return not gone

    tree.body = [n for n in tree.body if keep(n, "")]
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            node.body = [m for m in node.body if keep(m, node.name + ".")]
        elif _names(node) == ["__all__"]:
            node.value.elts = [e for e in node.value.elts
                               if e.value not in names]
    assert removed == names, sorted(names - removed)
    return tree


def _take_imports(tree: ast.Module) -> set:
    """The ``(module, name, alias)`` of each top-level import, the imports
    taken out of ``tree``."""
    out, body = set(), []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(getattr(node, "module", None), a.name, a.asname)
                    for a in node.names}
        else:
            body.append(node)
    tree.body = body
    return out


def check_copy(rel: str, strings: bool = False):
    """The copy's source equals the reference's once docstrings are
    dropped and imports (with ``strings``, string constants too) name the
    port. For a partial copy the
    definitions ``PARTIAL[rel]`` names are first taken out of the
    reference's (and out of its ``__all__``), and its top-level imports
    need only be some of the reference's: it leaves out those that only
    the lacking definitions use. Where ``rel`` is in ``REPLACED``, the
    same names are taken out of the copy too."""
    ref_path, port_path = module_paths(rel)
    ref = normalized(ref_path, strings)
    port = normalized(port_path, strings)
    if rel in PARTIAL:
        ref = _without(ref, PARTIAL[rel])
        if rel in REPLACED:
            port = _without(port, PARTIAL[rel])
        assert _take_imports(port) <= _take_imports(ref), rel
    assert ast.dump(port) == ast.dump(ref), rel


# what a harness returns that depends on the clock
_TIMING_KEYS = ("_ms", "_per_sec", "over_p50")


def harness_closes(package: str, harness: str, **kwargs):
    """``simulation.load_generator.<harness>(**kwargs)`` of ``package``
    with the harness's ``LedgerManager`` (a name in its module) recording
    each close: the result less its timings, the header hashes (hex) in
    close order, and SHA-256 (hex) over the closes' ``LedgerCloseMeta``
    bytes joined, as ``chip_smoke.py`` phase 25 pins them."""
    lg = importlib.import_module(f"{package}.simulation.load_generator")
    xl = importlib.import_module(f"{package}.xdr.ledger")
    rt = importlib.import_module(f"{package}.xdr.runtime")
    hashes, metas = [], []

    class Recording(lg.LedgerManager):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.close_meta_stream.append(lambda m: metas.append(
                rt.to_bytes(xl.LedgerCloseMeta, m)))

        def close_ledger(self, lcd):
            res = super().close_ledger(lcd)
            hashes.append(res.header_hash.hex())
            return res

    saved = lg.LedgerManager
    lg.LedgerManager = Recording
    try:
        out = getattr(lg, harness)(**kwargs)
    finally:
        lg.LedgerManager = saved
    out = {k: v for k, v in out.items()
           if not any(t in k for t in _TIMING_KEYS)}
    return out, hashes, hashlib.sha256(b"".join(metas)).hexdigest()
