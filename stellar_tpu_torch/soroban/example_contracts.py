"""Canonical wasm example contracts, assembled in-process — the role
the reference's checked-in soroban test fixtures play
(``src/testdata/soroban/*.wasm``): real compiled modules for tests,
golden tx-meta scenarios, and the load generator to exercise the wasm
VM end-to-end (upload -> create -> invoke through the close pipeline).
"""

from __future__ import annotations

from stellar_tpu_torch.soroban.env import (
    TAG_TRUE, TAG_U32, TAG_VOID, sym_to_small,
)
from stellar_tpu_torch.soroban.wasm_builder import Code, I64, ModuleBuilder

__all__ = ["counter_wasm", "ttl_wasm", "custom_account_wasm",
           "KEY_COUNT_VAL"]


def _u32val(v: int) -> int:
    return ((v & 0xFFFFFFFF) << 8) | TAG_U32


KEY_COUNT_VAL = sym_to_small(b"count")
_SYM_INCR = sym_to_small(b"incr")
_T_PERSISTENT = _u32val(1)  # storage-type code: persistent


def counter_wasm(with_burst: bool = False) -> bytes:
    """The counter contract as a real wasm module.

    Exports:
      - ``incr()``       -> new count (U32 val): get/put persistent
        storage + emits an ``incr`` event
      - ``auth_incr(a)`` -> require_auth(a) then incr()
      - ``sha8(x)``      -> first byte of sha256(le64(x)) (U32 val);
        exercises linear memory + bytes objects + crypto
      - ``boom()``       -> traps (unreachable)
      - ``spin()``       -> infinite loop (budget-trap fodder)
    """
    b = ModuleBuilder()
    has_fn = b.import_func("l", "has_contract_data", [I64, I64], [I64])
    get_fn = b.import_func("l", "get_contract_data", [I64, I64], [I64])
    put_fn = b.import_func("l", "put_contract_data",
                           [I64, I64, I64], [I64])
    event_fn = b.import_func("x", "contract_event", [I64, I64], [I64])
    vec_new_fn = b.import_func("v", "vec_new", [], [I64])
    vec_push_fn = b.import_func("v", "vec_push_back",
                                [I64, I64], [I64])
    auth_fn = b.import_func("a", "require_auth", [I64], [I64])
    bytes_new_fn = b.import_func("b", "bytes_new_from_linear_memory",
                                 [I64, I64], [I64])
    bytes_get_fn = b.import_func("b", "bytes_get", [I64, I64], [I64])
    sha_fn = b.import_func("d", "compute_sha256", [I64], [I64])

    b.add_memory(1)

    # incr() -> i64 val; local 0 holds the new counter val
    c = Code()
    c.i64_const(KEY_COUNT_VAL).i64_const(_T_PERSISTENT).call(has_fn)
    c.i64_const(TAG_TRUE).i64_eq()
    c.if_(I64)
    c.i64_const(KEY_COUNT_VAL).i64_const(_T_PERSISTENT).call(get_fn)
    c.else_()
    c.i64_const(_u32val(0))
    c.end()
    # old val -> count -> count+1 -> new val
    c.i64_const(8).i64_shr_u().i64_const(1).i64_add()
    c.i64_const(8).i64_shl().i64_const(TAG_U32).i64_or()
    c.local_set(0)
    # put(key, new, persistent)
    c.i64_const(KEY_COUNT_VAL).local_get(0)
    c.i64_const(_T_PERSISTENT).call(put_fn).drop()
    # contract_event([sym "incr"], new)
    c.call(vec_new_fn).i64_const(_SYM_INCR).call(vec_push_fn)
    c.local_get(0).call(event_fn).drop()
    c.local_get(0).end()
    incr_idx = b.add_func([], [I64], [I64], c, export="incr")

    # auth_incr(addr) -> require_auth then incr
    c = Code()
    c.local_get(0).call(auth_fn).drop()
    c.call(incr_idx).end()
    b.add_func([I64], [I64], [], c, export="auth_incr")

    # sha8(x): mem[0:8] = le64(x); sha256(bytes); first byte as U32 val
    c = Code()
    c.i32_const(0).local_get(0).i64_const(8).i64_shr_u().i64_store()
    c.i64_const(_u32val(0)).i64_const(_u32val(8)).call(bytes_new_fn)
    c.call(sha_fn)
    c.i64_const(_u32val(0)).call(bytes_get_fn)
    c.end()
    b.add_func([I64], [I64], [], c, export="sha8")

    # boom(): trap
    b.add_func([], [I64], [], Code().unreachable().end(),
               export="boom")

    # spin(): infinite loop — must die by budget, not wall clock
    c = Code()
    c.loop(0x40).br(0).end()
    c.i64_const(TAG_VOID).end()
    b.add_func([], [I64], [], c, export="spin")

    if with_burst:
        # auth_incr_burst(addr, k) -> auth_incr + k extra ("burst",
        # countdown) events (the wasm twin of the scval variant;
        # APPLY_LOAD_EVENT_COUNT shaping). Appended AFTER the default
        # exports so the with_burst=False bytes — whose code hash the
        # golden metas pin — are untouched. local2 = remaining count,
        # local3 = incr result
        c = Code()
        c.local_get(0).call(auth_fn).drop()
        c.call(incr_idx).local_set(3)
        c.local_get(1).i64_const(8).i64_shr_u().local_set(2)  # raw k
        c.block(0x40)
        c.local_get(2).i64_eqz().br_if(0)
        c.loop(0x40)
        c.call(vec_new_fn).i64_const(sym_to_small(b"burst"))
        c.call(vec_push_fn)
        # data = current countdown as a U32 val (the scval twin)
        c.local_get(2).i64_const(8).i64_shl()
        c.i64_const(TAG_U32).i64_or()
        c.call(event_fn).drop()
        c.local_get(2).i64_const(1).i64_sub().local_tee(2)
        c.i64_const(0).i64_ne().br_if(0)
        c.end()
        c.end()
        c.local_get(3).end()
        b.add_func([I64, I64], [I64], [I64, I64], c,
                   export="auth_incr_burst")

    return b.build()


def sum_wasm() -> bytes:
    """Compute-bound contract: ``sum(n)`` iterates ``n`` times
    accumulating ``1 + 2 + ... + n`` in raw i64 arithmetic and returns
    it as a U32 val. No host calls inside the loop — this is the
    shape where a native engine's per-instruction cost dominates (the
    benchmark counterpart of the host-call-bound counter).
    ``sum_scval_program()`` is its semantic twin for the interpreter."""
    b = ModuleBuilder()
    b.add_memory(1)
    c = Code()
    # local0 = arg (U32Val n), local1 = i (raw), local2 = acc (raw)
    c.local_get(0).i64_const(8).i64_shr_u().local_set(1)
    c.block(0x40)
    c.local_get(1).i64_eqz().br_if(0)
    c.loop(0x40)
    c.local_get(2).local_get(1).i64_add().local_set(2)
    c.local_get(1).i64_const(1).i64_sub().local_tee(1)
    c.i64_const(0).i64_ne().br_if(0)
    c.end()
    c.end()
    # U32 val: (acc << 8) | 4 — same return arm as the scval twin
    c.local_get(2).i64_const(8).i64_shl().i64_const(4).i64_or()
    c.end()
    b.add_func([I64], [I64], [I64, I64], c, export="sum")
    return b.build()


def sum_scval_program() -> bytes:
    """The SCVal-interpreter twin of :func:`sum_wasm`: ``sum(n)``
    returns ``1 + 2 + ... + n`` as a U32. Loop invariant on the stack
    is ``[acc, i]`` with ``i`` counting down; 9 interpreted
    instructions per iteration."""
    from stellar_tpu_torch.soroban.host import assemble_program, ins, sym, u32
    from stellar_tpu_torch.xdr.contract import SCVal, SCValType
    return assemble_program({
        "sum": [
            ins("push", u32(0)),                     # 0: [acc]
            ins("arg", u32(0)),                      # 1: [acc, i=n]
            ins("dup"),                              # 2: loop top
            ins("jz", u32(7)),                       # 3: i==0 -> 11
            ins("swap"),                             # 4: [i, acc]
            ins("over"),                             # 5: [i, acc, i]
            ins("add"),                              # 6: [i, acc+i]
            ins("swap"),                             # 7: [acc', i]
            ins("push", u32(1)),                     # 8
            ins("sub"),                              # 9: [acc', i-1]
            ins("jmp", SCVal.make(SCValType.SCV_I32, -9)),  # 10 -> 2
            ins("drop"),                             # 11: [acc']
            ins("ret"),                              # 12
        ],
    })


def ttl_wasm() -> bytes:
    """TTL-exercising contract: ``setup()`` writes a persistent entry;
    ``bump(threshold, extend_to)`` extends that entry's TTL from inside
    the contract; ``bump_self(threshold, extend_to)`` extends the
    instance + code TTLs (reference extend_contract_data_ttl /
    extend_current_contract_instance_and_code_ttl host fns)."""
    b = ModuleBuilder()
    put_fn = b.import_func("l", "put_contract_data",
                           [I64, I64, I64], [I64])
    ext_fn = b.import_func("l", "extend_contract_data_ttl",
                           [I64, I64, I64, I64], [I64])
    self_fn = b.import_func("l", "extend_instance_and_code_ttl",
                            [I64, I64], [I64])
    key = KEY_COUNT_VAL  # rides the standard harness footprint

    c = Code()
    c.i64_const(key).i64_const(_u32val(1)).i64_const(_T_PERSISTENT)
    c.call(put_fn).end()
    b.add_func([], [I64], [], c, export="setup")

    c = Code()
    c.i64_const(key).i64_const(_T_PERSISTENT)
    c.local_get(0).local_get(1).call(ext_fn).end()
    b.add_func([I64, I64], [I64], [], c, export="bump")

    c = Code()
    c.local_get(0).local_get(1).call(self_fn).end()
    b.add_func([I64, I64], [I64], [], c, export="bump_self")
    return b.build()


def custom_account_wasm() -> bytes:
    """Minimal CUSTOM ACCOUNT (reference account abstraction): the
    host dispatches ``__check_auth(signature_payload, signatures)``
    for contract-address credentials; this one approves when the
    signature Val equals the symbol ``letmein``."""
    b = ModuleBuilder()
    c = Code()
    c.local_get(1).i64_const(sym_to_small(b"letmein")).i64_eq()
    c.if_(0x40).else_().unreachable().end()
    c.i64_const(TAG_VOID).end()
    b.add_func([I64, I64], [I64], [], c, export="__check_auth")
    return b.build()
