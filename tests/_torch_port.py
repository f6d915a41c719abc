"""Helpers shared by the port's node-slice tests (``test_torch_ledger.py``,
``test_torch_tx_frame.py``, ``test_torch_tx_set.py``): the source
comparison of a copied module with the reference's, and the carrying of
XDR values and ledgers from the port to the reference through their
bytes (objects never cross the two packages)."""

import ast
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
    "ledger/network_config.py": {"effective_cost_params"},
    "tx/ops/soroban_ops.py": {
        "_load_with_ttl", "_extend_entry_ttl", "_write_ttl",
        "_SorobanBase", "InvokeHostFunctionOpFrame",
        "ExtendFootprintTTLOpFrame", "RestoreFootprintOpFrame"},
    "tx/transaction_frame.py": {
        "HALT_ON_INTERNAL_ERROR", "OP_APPLY_SLEEP", "_OP_SLEEP_TICK",
        "_op_apply_sleep",
        "TransactionFrame.process_fee_seq_num",
        "TransactionFrame.process_seq_num",
        "TransactionFrame.remove_one_time_signers",
        "TransactionFrame.process_signatures", "TransactionFrame.apply",
        "TransactionFrame.soroban_refund_amount",
        "TransactionFrame._process_soroban_refund",
        "TransactionFrame._apply_operations",
        "FeeBumpTransactionFrame.process_fee_seq_num",
        "FeeBumpTransactionFrame.apply"},
}


class _Normalize(ast.NodeTransformer):
    """Drops docstrings and names the reference's package as the port's
    in import statements."""

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


def normalized(path: Path) -> ast.Module:
    return _Normalize().visit(ast.parse(path.read_text()))


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


def check_copy(rel: str):
    """The copy's source equals the reference's once docstrings are
    dropped and imports name the port. For a partial copy the
    definitions ``PARTIAL[rel]`` names are first taken out of the
    reference's (and out of its ``__all__``), and its top-level imports
    need only be some of the reference's: it leaves out those that only
    the lacking definitions use."""
    ref_path, port_path = module_paths(rel)
    ref, port = normalized(ref_path), normalized(port_path)
    if rel in PARTIAL:
        ref = _without(ref, PARTIAL[rel])
        assert _take_imports(port) <= _take_imports(ref), rel
    assert ast.dump(port) == ast.dump(ref), rel
