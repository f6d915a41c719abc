"""The port's wasm stack (``soroban/wasm.py``, ``wasm_builder.py``,
``example_contracts.py`` and the native engine of ``native_wasm.py``)
against the reference's.

Every contract of ``example_contracts``, built by each package's
``wasm_builder``, is byte-equal. ``tests/test_native_wasm.py``'s module
(arithmetic, loops, memory, traps, ``br_table``, ``call_indirect``,
globals, ``memory.grow``) is built by each package and each of its
exports runs on the reference's Python interpreter, the port's Python
interpreter and the port's native engine (``native/wasm_exec.cpp`` and
its CPython extension, built with ``g++`` under the build lock into
``build/torch_native/``): the same values, the same traps and the same
budget consumed, to the exhaustion point. Nothing crosses between the
packages but bytes and ints.
"""

import importlib
import os

import pytest

from stellar_tpu_torch.soroban import native_wasm as pnative

from tests._torch_port import ROOT

CONTRACTS = [("counter_wasm", {}), ("counter_wasm", {"with_burst": True}),
             ("sum_wasm", {}), ("sum_scval_program", {}), ("ttl_wasm", {}),
             ("custom_account_wasm", {})]

# tests/test_native_wasm.py's cases over its module
CASES = [
    ("add", [5, 7]), ("add", [(1 << 64) - 1, 2]),
    ("sum", [0]), ("sum", [1]), ("sum", [1000]), ("sum", [63]),
    ("sum", [64]), ("sum", [65]),
    ("lowbyte", [0xdeadbeef]), ("lowbyte", [0x80]),
    ("divs", [-7 & ((1 << 64) - 1), 2]), ("divs", [7, 0]),
    ("divs", [1 << 63, (1 << 64) - 1]),
    ("table", [0]), ("table", [1]), ("table", [2]), ("table", [99]),
    ("dispatch", [0]), ("dispatch", [1]), ("dispatch", [2]),
    ("dispatch", [9]),
    ("gread", []), ("grow", []), ("rot8", [3]), ("rot8", [(1 << 57)]),
    ("data1", []),
]
CPU = 4


def _mods(package):
    return (importlib.import_module(f"{package}.soroban.wasm"),
            importlib.import_module(f"{package}.soroban.wasm_builder"))


def _module_bytes(package) -> bytes:
    """``tests/test_native_wasm.py``'s ``_module`` built by ``package``."""
    _wasm, wb = _mods(package)
    Code, I64 = wb.Code, wb.I64
    b = wb.ModuleBuilder()
    b.add_memory(1, 2)
    b.add_func([I64, I64], [I64],
               [], Code().local_get(0).local_get(1).i64_add(),
               export="add")
    c = Code()
    c.block(0x40).loop(0x40)
    c.local_get(2).local_get(0).i64_ge_u().br_if(1)
    c.local_get(2).i64_const(1).i64_add().local_tee(2)
    c.local_get(1).i64_add().local_set(1)
    c.br(0).end().end()
    c.local_get(1)
    b.add_func([I64], [I64], [I64, I64], c, export="sum")
    c = Code().i32_const(64).local_get(0).i64_store() \
        .i32_const(64).i64_load8_u()
    b.add_func([I64], [I64], [], c, export="lowbyte")
    c = Code().local_get(0).local_get(1).i64_div_s()
    b.add_func([I64, I64], [I64], [], c, export="divs")
    c = Code().block(0x40).block(0x40).block(0x40)
    c.local_get(0).i32_wrap_i64().br_table([0, 1], 2)
    c.end().i64_const(100).return_()
    c.end().i64_const(200).return_()
    c.end().i64_const(300)
    b.add_func([I64], [I64], [], c, export="table")
    f1 = b.add_func([], [I64], [], Code().i64_const(11))
    f2 = b.add_func([], [I64], [], Code().i64_const(22))
    f3 = b.add_func([I64], [I64], [], Code().local_get(0))
    b.add_table(3).add_elem(0, [f1, f2, f3])
    ti = b.type_idx([], [I64])
    c = Code().local_get(0).i32_wrap_i64().call_indirect(ti)
    b.add_func([I64], [I64], [], c, export="dispatch")
    g = b.add_global(I64, True, 5)
    sf = b.add_func([], [], [], Code().global_get(g).i64_const(2)
                    .i64_mul().global_set(g))
    b.set_start(sf)
    b.add_func([], [I64], [], Code().global_get(g), export="gread")
    c = Code().i32_const(1).memory_grow().drop() \
        .i32_const(9).memory_grow().i64_extend_i32_u()
    b.add_func([], [I64], [], c, export="grow")
    c = Code().local_get(0).i64_const(7).i64_rotl() \
        .i64_extend8_s()
    b.add_func([I64], [I64], [], c, export="rot8")
    b.add_data(100, b"\x99\x88\x77")
    c = Code().i32_const(101).i64_load8_u()
    b.add_func([], [I64], [], c, export="data1")
    return b.build()


class _Budget:
    def __init__(self, trap, cpu_limit):
        self.trap, self.cpu_limit = trap, cpu_limit
        self.cpu = self.mem = 0

    def charge(self, cpu, mem=0):
        self.cpu += cpu
        self.mem += mem
        if self.cpu > self.cpu_limit:
            raise self.trap("budget exceeded")


def _outcome(run, trap, budget):
    """('value' | 'trap' | 'budget', the value or the message, cpu)."""
    try:
        return ("value", run(), budget.cpu)
    except trap as e:
        kind = "budget" if "budget" in str(e) else "trap"
        return (kind, str(e), budget.cpu)


def _python(package, raw, fn, args, cpu_limit=10**9):
    """``fn(*args)`` on ``package``'s Python interpreter."""
    wasm, _wb = _mods(package)
    bud = _Budget(wasm.Trap, cpu_limit)

    def run():
        inst = wasm.WasmInstance(wasm.parse_module(raw), {},
                                 lambda n: bud.charge(n * CPU),
                                 lambda n: bud.charge(0, n))
        return inst.invoke(fn, list(args))
    return _outcome(run, wasm.Trap, bud)


def _native(raw, fn, args, cpu_limit=10**9):
    """``fn(*args)`` on the port's native engine."""
    wasm, _wb = _mods("stellar_tpu_torch")
    bud = _Budget(wasm.Trap, cpu_limit)
    return _outcome(lambda: pnative.run_export(
        wasm.parse_module(raw), {}, bud, CPU, fn, list(args)),
        wasm.Trap, bud)


@pytest.mark.parametrize("name,kwargs", CONTRACTS)
def test_example_contract_bytes_equal_reference(name, kwargs):
    got = getattr(importlib.import_module(
        "stellar_tpu_torch.soroban.example_contracts"), name)(**kwargs)
    want = getattr(importlib.import_module(
        "stellar_tpu.soroban.example_contracts"), name)(**kwargs)
    assert got == want and len(got) > 0


def test_builder_module_bytes_equal_reference():
    assert _module_bytes("stellar_tpu_torch") == _module_bytes("stellar_tpu")


def test_native_engine_builds_into_torch_native():
    """The port's libraries build from the checkout's sources into
    ``build/torch_native/``, apart from the reference's, and load."""
    assert pnative.available()
    assert pnative._load_ext() is not None
    out = os.path.join(str(ROOT), "build", "torch_native")
    for path in (pnative._LIB, pnative._ext_lib_path()):
        assert os.path.dirname(path) == out and os.path.exists(path)
        assert os.path.exists(path + ".sha256")


@pytest.mark.parametrize("fn,args", CASES)
def test_export_equals_reference_on_both_engines(fn, args):
    raw = _module_bytes("stellar_tpu_torch")
    want = _python("stellar_tpu", raw, fn, args)
    assert _python("stellar_tpu_torch", raw, fn, args) == want
    assert _native(raw, fn, args) == want


@pytest.mark.parametrize("limit", [256, 1024, 4096, 10_000])
def test_budget_exhaustion_point_equals_reference(limit):
    raw = _module_bytes("stellar_tpu_torch")
    want = _python("stellar_tpu", raw, "sum", [100_000], cpu_limit=limit)
    assert want[0] == "budget"
    assert _python("stellar_tpu_torch", raw, "sum", [100_000],
                   cpu_limit=limit) == want
    assert _native(raw, "sum", [100_000], cpu_limit=limit) == want
