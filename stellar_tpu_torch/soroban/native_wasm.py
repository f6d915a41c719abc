"""ctypes bridge to the native wasm execution engine
(``native/wasm_exec.cpp``) — the C++ runtime component playing wasmi's
role behind ``invoke_host_function``. The Python side keeps decode +
validation (``soroban/wasm.py``); this hands the flattened op lists to
the native interpreter, with host imports bouncing back through a
callback and ALL budget charges flowing through the real soroban
budget. Both engines share one charge-stream contract (64-op ticks,
flush before calls/grows, HOST_CALL_COST on crossings), so consumed
cpu and budget-exhaustion points are bit-identical — a node may run
either engine without consensus divergence (differential tests pin
this).

The port's copy of ``stellar_tpu/soroban/native_wasm.py`` but for its
build: ``_LIB``, ``_ext_lib_path`` and ``_build_lib`` build the two C++
sources with ``g++`` through
:func:`stellar_tpu_torch.ops._build.build_library` into
``build/torch_native/``, apart from the JAX package's libraries (the
build holds a file lock and lands by rename). This is host code, not a
device kernel: where the libraries cannot be built, ``soroban/wasm.py``'s
Python interpreter stays the engine.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

from stellar_tpu_torch.soroban.wasm import (
    HOST_CALL_COST, MAX_PAGES, Trap, WasmModule,
)

__all__ = ["available", "run_export"]

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_HERE, "native", "wasm_exec.cpp")
_LIB = os.path.join(_HERE, "build", "torch_native", "libwasmexec.so")
_EXT_SRC = os.path.join(_HERE, "native", "wasm_ext.cpp")


def _ext_lib_path() -> str:
    # ABI-tagged: the extension links against a specific CPython's
    # internals (unlike libwasmexec.so, which is Python-free), so a
    # library built for another interpreter version is never loaded
    import sys
    return os.path.join(_HERE, "build", "torch_native",
                        f"wasm_ext.{sys.implementation.cache_tag}.so")


_lock = threading.Lock()
_lib = None
_tried = False
_ext = None
_ext_tried = False


def _build_lib(srcs, out_path: str, extra_flags=(), timeout: int = 180):
    """Build ``srcs[0]`` (which includes the rest) into ``out_path``
    unless a build from the same sources and flags is there; concurrent
    processes never load a half-written library. ``timeout`` is the
    reference's signature: the port's builder bounds every build."""
    from stellar_tpu_torch.ops._build import build_library
    build_library(out_path, list(srcs),
                  ["g++", "-O2", "-shared", "-fPIC", *extra_flags, srcs[0]])

ST_OK, ST_TRAP, ST_BUDGET, ST_HOST = 0, 1, 2, 3

_TRAP_MESSAGES = {
    1: "unreachable executed",
    2: "memory access out of bounds",
    3: "integer divide by zero",
    4: "integer overflow",
    5: "call stack exhausted",
    6: "uninitialized table element",
    7: "indirect call type mismatch",
    8: "data segment out of bounds",
}

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

_HOST_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, _i64p,
    ctypes.c_int32, _i64p, _i64p, ctypes.c_int64, _u8p,
    ctypes.c_int64)
_MEM_CB = ctypes.CFUNCTYPE(ctypes.c_int32,
                           ctypes.c_void_p, ctypes.c_int64)


class _FuncDesc(ctypes.Structure):
    _fields_ = [("ops_off", ctypes.c_int64),
                ("n_ops", ctypes.c_int64),
                ("n_locals", ctypes.c_int32),
                ("n_params", ctypes.c_int32),
                ("n_results", ctypes.c_int32),
                ("type_id", ctypes.c_int32),
                ("result_is32", ctypes.c_int32),
                ("_pad", ctypes.c_int32)]


class _ProgramDesc(ctypes.Structure):
    _fields_ = [("ops", _i32p), ("imm_a", _i64p), ("imm_b", _i64p),
                ("imm_c", _i64p), ("br_pool", _i64p),
                ("funcs", ctypes.POINTER(_FuncDesc)),
                ("n_funcs", ctypes.c_int32),
                ("import_nparams", _i32p),
                ("import_nresults", _i32p),
                ("import_result32", _i32p),
                ("n_imports", ctypes.c_int32),
                ("globals_init", _i64p),
                ("n_globals", ctypes.c_int32),
                ("table", _i32p), ("table_len", ctypes.c_int32),
                ("data_blob", _u8p), ("data_offs", _i64p),
                ("data_lens", _i64p), ("n_data", ctypes.c_int32),
                ("mem_min_pages", ctypes.c_int32),
                ("mem_max_pages", ctypes.c_int32),
                ("start_func", ctypes.c_int32),
                ("func_type_ids", _i32p)]


class _RunResult(ctypes.Structure):
    _fields_ = [("status", ctypes.c_int32),
                ("trap_code", ctypes.c_int32),
                ("value", ctypes.c_int64),
                ("has_value", ctypes.c_int32),
                ("executed", ctypes.c_int64),
                ("charged", ctypes.c_int64)]


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            _build_lib([_SRC], _LIB, timeout=120)
            lib = ctypes.CDLL(_LIB)
            lib.wasm_run.argtypes = [
                ctypes.POINTER(_ProgramDesc), ctypes.c_int32, _i64p,
                ctypes.c_int32, _HOST_CB, _MEM_CB, ctypes.c_void_p,
                ctypes.c_int64, ctypes.POINTER(_RunResult)]
            lib.wasm_run.restype = ctypes.c_int32
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _load_ext():
    """The CPython-extension trampoline (native/wasm_ext.cpp): same
    engine, ~5x cheaper host-call crossings than CFUNCTYPE. Falls back
    to the ctypes path when the toolchain can't build extensions."""
    global _ext, _ext_tried
    if _ext_tried:
        return _ext
    with _lock:
        if _ext_tried:
            return _ext
        _ext_tried = True
        try:
            import importlib.util
            import sysconfig
            lib_path = _ext_lib_path()
            inc = sysconfig.get_paths()["include"]
            _build_lib([_EXT_SRC, _SRC], lib_path,
                       extra_flags=[f"-I{inc}",
                                    f"-I{os.path.dirname(_SRC)}"])
            spec = importlib.util.spec_from_file_location(
                "wasm_ext", lib_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _ext = mod
        except Exception:
            _ext = None
        return _ext


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# flattening: WasmModule -> ProgramDesc (cached on the module)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _s64(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _compile(module: WasmModule):
    """Flatten the decoded module into the arrays the native engine
    consumes; kept alive as a tuple on the module."""
    cached = getattr(module, "_native_prog", None)
    if cached is not None:
        return cached
    # canonical type ids by STRUCTURE (call_indirect compares types
    # structurally, like the Python engine)
    type_ids: Dict[Tuple, int] = {}

    def tid(ft) -> int:
        key = (ft.params, ft.results)
        return type_ids.setdefault(key, len(type_ids))

    ops_l, ia_l, ib_l, ic_l = [], [], [], []
    pool = []
    funcs = (_FuncDesc * max(1, len(module.funcs)))()
    for i, f in enumerate(module.funcs):
        off = len(ops_l)
        for op, imm in f.ops:
            a = b = c = 0
            if op in (0x0C, 0x0D):
                a, b, c = imm
            elif op == 0x0E:
                a = len(pool)
                b = len(imm)
                pool.extend(imm)
            elif op == 0x11:
                a = tid(module.types[imm])
            elif isinstance(imm, int):
                a = _s64(imm)
            ops_l.append(op)
            ia_l.append(a)
            ib_l.append(b)
            ic_l.append(c)
        from stellar_tpu_torch.soroban.wasm import I32 as _I32
        funcs[i] = _FuncDesc(
            ops_off=off, n_ops=len(f.ops),
            n_locals=len(f.locals), n_params=len(f.type.params),
            n_results=len(f.type.results), type_id=tid(f.type),
            result_is32=1 if (f.type.results and
                              f.type.results[0] == _I32) else 0)

    n_ops = max(1, len(ops_l))
    ops = (ctypes.c_int32 * n_ops)(*ops_l)
    ia = (ctypes.c_int64 * n_ops)(*ia_l)
    ib = (ctypes.c_int64 * n_ops)(*ib_l)
    ic = (ctypes.c_int64 * n_ops)(*ic_l)
    pool_arr = (ctypes.c_int64 * max(1, len(pool) * 3))(
        *[x for tr in pool for x in tr])

    from stellar_tpu_torch.soroban.wasm import I32
    n_imp = max(1, len(module.imports))
    imp_np = (ctypes.c_int32 * n_imp)(
        *[len(t.params) for _m, _n, t in module.imports] or [0])
    imp_nr = (ctypes.c_int32 * n_imp)(
        *[len(t.results) for _m, _n, t in module.imports] or [0])
    imp_r32 = (ctypes.c_int32 * n_imp)(
        *[1 if (t.results and t.results[0] == I32) else 0
          for _m, _n, t in module.imports] or [0])

    n_glob = max(1, len(module.globals))
    globs = (ctypes.c_int64 * n_glob)(
        *[_s64(g[2]) for g in module.globals] or [0])

    table_init = [-1] * module.table_min
    for offt, idxs in module.elements:
        if offt < 0 or offt + len(idxs) > len(table_init):
            # the Python engine traps at instantiation; clamping here
            # would diverge
            raise Trap("element segment out of bounds")
        for j, fi in enumerate(idxs):
            table_init[offt + j] = fi
    table = (ctypes.c_int32 * max(1, len(table_init)))(
        *table_init or [0])

    blob = b"".join(d for _o, d in module.data)
    blob_arr = (ctypes.c_uint8 * max(1, len(blob)))(*blob or [0])
    n_data = max(1, len(module.data))
    doffs = (ctypes.c_int64 * n_data)(
        *[o for o, _d in module.data] or [0])
    dlens = (ctypes.c_int64 * n_data)(
        *[len(d) for _o, d in module.data] or [0])

    n_all = len(module.imports) + len(module.funcs)
    ftids = (ctypes.c_int32 * max(1, n_all))(
        *([tid(module.func_type(i)) for i in range(n_all)] or [0]))

    desc = _ProgramDesc(
        ops=ops, imm_a=ia, imm_b=ib, imm_c=ic, br_pool=pool_arr,
        funcs=funcs, n_funcs=len(module.funcs),
        import_nparams=imp_np, import_nresults=imp_nr,
        import_result32=imp_r32,
        n_imports=len(module.imports),
        globals_init=globs, n_globals=len(module.globals),
        table=table, table_len=len(table_init),
        data_blob=blob_arr, data_offs=doffs, data_lens=dlens,
        n_data=len(module.data),
        mem_min_pages=module.mem_min,
        mem_max_pages=(module.mem_max if module.mem_max is not None
                       else -1),
        start_func=(module.start if module.start is not None else -1),
        func_type_ids=ftids)
    # keep every array alive with the desc
    prog = (desc, ops, ia, ib, ic, pool_arr, funcs, imp_np, imp_nr,
            imp_r32, globs, table, blob_arr, doffs, dlens, ftids)
    module._native_prog = prog
    # the descriptor address is stable for the prog's lifetime; caching
    # it saves a ctypes.addressof per invoke on the hot path
    module._native_desc_addr = ctypes.addressof(desc)
    return prog


class _MemShim:
    """WasmInstance-compatible memory facade over the C++ engine's
    linear memory, valid for the duration of one host callback."""

    __slots__ = ("ptr", "size")

    def __init__(self):
        self.ptr = None
        self.size = 0

    def _base(self) -> Optional[int]:
        p = self.ptr
        if isinstance(p, int):  # extension path passes a raw address
            return p or None
        return ctypes.cast(p, ctypes.c_void_p).value if p else None

    def mem_read(self, ptr: int, n: int) -> bytes:
        if ptr < 0 or n < 0 or ptr + n > self.size:
            raise Trap("memory access out of bounds")
        if n == 0:
            return b""  # zero-length reads succeed even with no memory
        base = self._base()
        if base is None:
            raise Trap("memory access out of bounds")
        return ctypes.string_at(base + ptr, n)

    def mem_write(self, ptr: int, data: bytes):
        if ptr < 0 or ptr + len(data) > self.size:
            raise Trap("memory access out of bounds")
        if not data:
            return
        base = self._base()
        if base is None:
            raise Trap("memory access out of bounds")
        ctypes.memmove(base + ptr, data, len(data))


class _RunCtx:
    """Per-invocation state behind the PERSISTENT ctypes callbacks.
    Creating a CFUNCTYPE wrapper costs more than a typical 3-op
    contract's whole execution; instead one pair of callbacks per
    thread closes over a swappable context (stacked for reentrant
    ``call`` dispatch)."""

    __slots__ = ("host_fns", "budget", "cpu_per_insn", "shim",
                 "exc_box", "settled")

    def __init__(self, host_fns, budget, cpu_per_insn):
        self.host_fns = host_fns
        self.budget = budget
        self.cpu_per_insn = cpu_per_insn
        self.shim = _MemShim()
        self.exc_box = []
        self.settled = 0  # op-ticks already charged to the real budget

    def remaining_ticks(self) -> int:
        room = self.budget.cpu_limit - self.budget.cpu
        return max(0, room // self.cpu_per_insn)

    def settle(self, charged_so_far: int, extra_cpu: int = 0):
        """Charge the engine's op ticks into the REAL budget before any
        host-side charge decision, so host-fn charges and wasm ticks
        share ONE exhaustion point, exactly like the Python engine
        (which charges every tick chunk straight into the budget). By
        construction the engine only runs ticks it was granted, so a
        settle inside the grant never raises; the FINAL settle of a
        budget-trapped run carries the failing chunk and raises at the
        same point the Python engine's chunk charge does."""
        delta = charged_so_far - self.settled
        if delta:
            self.settled = charged_so_far
            self.budget.charge(delta * self.cpu_per_insn)
        if extra_cpu:
            # separate charge call: the budget value observable at an
            # exhaustion trap must match the Python engine's, which
            # charges tick chunks and the crossing cost independently
            self.budget.charge(extra_cpu)


_HOST_CALL_CPU = HOST_CALL_COST  # local alias for the dispatch hot path

_tls = threading.local()


def _thread_stack():
    """Per-thread context stack shared by BOTH dispatch paths; kept
    separate so the extension path never pays CFUNCTYPE construction."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _thread_cbs():
    """(ctx_stack, host_cb, mem_cb) — one persistent callback pair per
    thread; ``ctx_stack[-1]`` is the active invocation's context."""
    cbs = getattr(_tls, "cbs", None)
    if cbs is None:
        stack = _thread_stack()

        def host_cb(_c, import_idx, args_p, nargs, result_p,
                    ticks_left_p, charged_so_far, mem_p, mem_len):
            ctx = stack[-1]
            try:
                # one combined charge: settled ticks + crossing cost
                ctx.settle(charged_so_far,
                           HOST_CALL_COST * ctx.cpu_per_insn)
                shim = ctx.shim
                shim.ptr = mem_p
                shim.size = mem_len
                call_args = [args_p[i] & _M64 for i in range(nargs)]
                rv = ctx.host_fns[import_idx](shim, *call_args)
                result_p[0] = _s64(rv if rv is not None else 0)
                ticks_left_p[0] = ctx.remaining_ticks()
                return 0
            except BaseException as e:
                ctx.exc_box.append(e)
                return 1

        def mem_cb(_c, n_bytes):
            ctx = stack[-1]
            try:
                ctx.budget.charge(0, n_bytes)
                return 0
            except BaseException as e:
                ctx.exc_box.append(e)
                return 1

        cbs = (stack, _HOST_CB(host_cb), _MEM_CB(mem_cb))
        _tls.cbs = cbs
    return cbs


def _thread_dispatchers():
    """(ctx_stack, host_dispatch, mem_dispatch) for the extension
    trampoline — shares the ctx stack with the ctypes path. The
    dispatchers record exceptions in the active context and return
    None, mirroring the CFUNCTYPE path's exc_box control flow."""
    d = getattr(_tls, "disp", None)
    if d is None:
        stack = _thread_stack()

        def host_dispatch(import_idx, args_tup, charged,
                          mem_addr, mem_len):
            ctx = stack[-1]
            try:
                # settle + crossing charge, inlined: this runs for
                # EVERY host call of every contract — the two charge
                # calls below are the metering contract (tick chunk and
                # crossing cost charged separately, matching the Python
                # engine's observable exhaustion points)
                budget = ctx.budget
                cpi = ctx.cpu_per_insn
                delta = charged - ctx.settled
                ctx.settled = charged
                ticks_cpu = delta * cpi
                cross_cpu = _HOST_CALL_CPU * cpi
                new_cpu = budget.cpu + ticks_cpu + cross_cpu
                if new_cpu <= budget.cpu_limit:
                    budget.cpu = new_cpu  # fast path: no exhaustion
                else:
                    # slow path keeps the Python engine's exact two
                    # observable exhaustion points (tick chunk, then
                    # crossing cost)
                    if ticks_cpu:
                        budget.charge(ticks_cpu)
                    budget.charge(cross_cpu)
                shim = ctx.shim
                shim.ptr = mem_addr
                shim.size = mem_len
                rv = ctx.host_fns[import_idx](shim, *args_tup)
                room = budget.cpu_limit - budget.cpu
                return ((rv if rv is not None else 0) & _M64,
                        room // cpi if room > 0 else 0)
            except BaseException as e:
                ctx.exc_box.append(e)
                return None

        def mem_dispatch(n_bytes):
            ctx = stack[-1]
            try:
                ctx.budget.charge(0, n_bytes)
                return True
            except BaseException as e:
                ctx.exc_box.append(e)
                return None

        d = (stack, host_dispatch, mem_dispatch)
        _tls.disp = d
    return d


def run_export(module: WasmModule, imports: Dict, budget,
               cpu_per_insn: int, fn_name: str, args,
               cache_imports: bool = False) -> Optional[int]:
    """Execute ``fn_name(args)`` natively. Charges ride the REAL
    ``budget``; raises Trap (or re-raises whatever a host import
    raised) exactly like the Python engine.

    ``cache_imports=True`` memoizes the resolved import list on the
    module keyed by the imports dict's identity — pass it ONLY for
    pooled, process-lifetime import tables (the modern host env pool):
    caching an ad-hoc dict would pin its closed-over host graph alive
    on the globally cached module."""
    lib = _load()
    assert lib is not None
    # instantiation-order parity with the Python engine: initial
    # memory is charged FIRST (WasmInstance.__init__), then element
    # segments validate, then start runs, and only then do export /
    # arity checks trap — so budget-vs-trap classification matches
    if module.mem_min:
        budget.charge(0, module.mem_min * 65536)
    prog = _compile(module)  # raises the element-segment Trap
    desc = prog[0]
    func_idx = -1
    export_error = f"no exported function {fn_name!r}"
    exp = module.exports.get(fn_name)
    if exp is not None and exp[0] == "func":
        ft = module.func_type(exp[1])
        if len(args) != len(ft.params):
            export_error = f"{fn_name!r} expects {len(ft.params)} args"
            args = []
        else:
            func_idx = exp[1]

    # resolve the import table once per (module, imports-dict) pair —
    # the per-thread env pool reuses its imports dict, so steady-state
    # invokes skip the per-import lookups entirely
    cache = getattr(module, "_host_fns_cache", None)
    if cache is not None and cache[0] is imports:
        host_fns, gated = cache[1], cache[2]
        if gated:
            # the cached resolution skipped the full link checks, but
            # the frame's PROTOCOL can differ per invoke (pooled
            # imports serve many txs) — era refusal must re-run
            from stellar_tpu_torch.soroban.wasm import check_import_era
            for mod, name, fn in gated:
                check_import_era(mod, name, fn)
    else:
        host_fns = []
        gated = []
        from stellar_tpu_torch.soroban.wasm import (
            WasmError, check_import_binding,
        )
        for mod, name, t in module.imports:
            fn = imports.get((mod, name))
            if fn is None:
                raise WasmError(f"unresolved import {mod}.{name}")
            check_import_binding(mod, name, t, fn)
            host_fns.append(fn)
            if getattr(fn, "__min_protocol__", None) is not None:
                gated.append((mod, name, fn))
        if cache_imports:
            module._host_fns_cache = (imports, host_fns, gated)

    # reuse one ctx + result struct per thread depth-slot: allocation
    # (a _MemShim, an exc list, a ctypes struct) costs as much as a
    # small contract's whole host work. Reentrant ``call`` frames get
    # fresh objects (pool is per-depth via the stack length).
    pool = getattr(_tls, "ctx_pool", None)
    if pool is None:
        pool = _tls.ctx_pool = []
    depth = len(_thread_stack())
    while len(pool) <= depth:
        r = _RunResult()
        pool.append((_RunCtx([], None, 1), r, ctypes.addressof(r)))
    ctx, out, out_addr = pool[depth]
    ctx.host_fns = host_fns
    ctx.budget = budget
    ctx.cpu_per_insn = cpu_per_insn
    ctx.settled = 0
    out.charged = 0
    exc_box = ctx.exc_box
    try:
        if (ext := _load_ext()) is not None:
            stack, hd, md = _thread_dispatchers()
            stack.append(ctx)
            try:
                try:
                    ext.run(module._native_desc_addr, func_idx,
                            [a & _M64 for a in args],
                            ctx.remaining_ticks(), hd, md, out_addr)
                except BaseException as e:
                    # trampoline-internal failure: out is filled —
                    # settle like the normal path, then surface the
                    # recorded host exception if one exists
                    ctx.settle(out.charged)
                    if exc_box:
                        raise exc_box[0] from None
                    raise e
            finally:
                stack.pop()
            rc = out.status
        else:
            stack, hcb, mcb = _thread_cbs()
            stack.append(ctx)
            try:
                rc = lib.wasm_run(
                    ctypes.byref(desc), func_idx,
                    (ctypes.c_int64 * max(1, len(args)))(
                        *[_s64(a & _M64) for a in args] or [0]),
                    len(args), hcb, mcb, None,
                    ctx.remaining_ticks(), ctypes.byref(out))
            finally:
                stack.pop()

        # settle the remaining wasm-op charges; a budget-trapped run's
        # failing chunk raises here, mirroring the Python engine's
        # chunk charge exactly
        ctx.settle(out.charged)
        if rc == ST_OK:
            return (out.value & _M64) if out.has_value else None
        if rc == ST_HOST:
            raise exc_box[0] if exc_box else Trap("host call failed")
        if rc == ST_BUDGET:
            # charged included the failing chunk: budget.charge above
            # must have raised; reaching here means accounting drifted
            raise AssertionError("native budget accounting out of sync")
        if out.trap_code == 9:  # missing export / arity, post-start
            raise Trap(export_error)
        raise Trap(_TRAP_MESSAGES.get(out.trap_code,
                                      f"trap {out.trap_code}"))
    finally:
        # drop run references NOW, not at the next same-depth invoke: a
        # pooled ctx holding the last run's exception (whose traceback
        # pins the whole host/storage graph), budget, and import table
        # would otherwise retain them for the thread's lifetime
        ctx.host_fns = ()
        ctx.budget = None
        exc_box.clear()
