"""Soroban host: deterministic, metered contract execution behind the
same boundary the reference crosses into Rust (``src/rust/src/lib.rs``
``invoke_host_function``, :61-83,182-195 — declared entries + auth in,
modified entries + events + consumption out; the C++ side at
``src/transactions/InvokeHostFunctionOpFrame.cpp:489`` only marshals).

Two execution engines sit behind the boundary:

- **wasm** (the real thing): code beginning with ``\\0asm`` is a wasm
  binary, validated at upload and executed by the metered wasm-MVP
  interpreter in ``soroban/wasm.py`` through the tagged-Val host ABI
  in ``soroban/env.py`` — the same wasmi-shaped stack the reference
  links behind ``invoke_host_function``.
- **legacy SCVal programs**: the XDR of an SCVal map {function symbol
  -> instruction vector} over a small stack machine, kept for the
  auditable golden scenarios that predate the wasm VM.

Either way, everything is metered against the same cpu/mem budget
shape, storage is footprint-enforced, and auth entries verify real
ed25519 signatures over the canonical HashIDPreimage — fee, footprint,
auth-signature, and TTL semantics exercise the full reference surface.

The port's copy of ``stellar_tpu/soroban/host.py``, with the port's
imports."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.xdr.contract import (
    ContractDataDurability, ContractDataEntry, ContractEvent,
    ContractEventType, ContractEventV0, ContractExecutable,
    ContractExecutableType, ContractIDPreimageType, HashIDPreimageContractID,
    HostFunctionType, LedgerKeyContractCode, LedgerKeyContractData,
    SCAddress, SCAddressType, SCContractInstance, SCMapEntry, SCNonceKey,
    SCVal, SCValType, SorobanCredentialsType,
)
from stellar_tpu_torch.xdr.runtime import Packer, from_bytes, to_bytes
from stellar_tpu_torch.xdr.types import (
    EnvelopeType, ExtensionPoint, LedgerEntry, LedgerEntryType, LedgerKey,
    LedgerKeyTtl, TTLEntry, account_ed25519,
)

__all__ = ["HostError", "InvokeOutput", "invoke_host_function",
           "contract_data_key", "contract_code_key", "ttl_key_for",
           "derive_contract_id", "make_instance_val", "assemble_program",
           "ins", "sym", "u32", "i64", "scbytes", "scaddress_contract",
           "scaddress_account", "auth_payload_hash"]

T = SCValType


class HostError(Exception):
    TRAPPED = "trapped"
    BUDGET = "budget"
    ARCHIVED = "archived"
    AUTH = "auth"

    def __init__(self, kind: str, msg: str, error_sc=None):
        super().__init__(msg)
        self.kind = kind
        # SCVal (arm SCV_ERROR) when the failing frame raised a
        # specific contract error (fail_with_error); try_call returns
        # it to the caller
        self.error_sc = error_sc


# ---------------------------------------------------------------------------
# SCVal construction sugar (also used by tests / the loadgen)
# ---------------------------------------------------------------------------

def sym(s: str):
    return SCVal.make(T.SCV_SYMBOL, s.encode())


def u32(v: int):
    return SCVal.make(T.SCV_U32, v)


def i64(v: int):
    return SCVal.make(T.SCV_I64, v)


def scbytes(b: bytes):
    return SCVal.make(T.SCV_BYTES, b)


def scaddress_contract(contract_id: bytes):
    return SCAddress.make(SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                          contract_id)


def scaddress_account(account_id_v):
    return SCAddress.make(SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                          account_id_v)


def ins(op: str, *args):
    """One instruction: vec [op-symbol, args...]."""
    return SCVal.make(T.SCV_VEC, [sym(op)] + list(args))


def assemble_program(functions: Dict[str, List]) -> bytes:
    """{fn name: [instructions]} -> contract code bytes."""
    entries = [SCMapEntry(key=sym(name),
                          val=SCVal.make(T.SCV_VEC, body))
               for name, body in sorted(functions.items())]
    return to_bytes(SCVal, SCVal.make(T.SCV_MAP, entries))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def contract_data_key(contract: "SCAddress.Value", key, durability):
    return LedgerKey.make(
        LedgerEntryType.CONTRACT_DATA,
        LedgerKeyContractData(contract=contract, key=key,
                              durability=durability))


def contract_code_key(code_hash: bytes):
    return LedgerKey.make(LedgerEntryType.CONTRACT_CODE,
                          LedgerKeyContractCode(hash=code_hash))


def ttl_key_for(lk) -> "LedgerKey.Value":
    """TTL entries are keyed by the hash of the data/code key they
    guard (reference ``getTTLKey``)."""
    return LedgerKey.make(
        LedgerEntryType.TTL,
        LedgerKeyTtl(keyHash=sha256(to_bytes(LedgerKey, lk))))


def derive_contract_id(network_id: bytes, preimage) -> bytes:
    """SHA-256 of HashIDPreimage{ENVELOPE_TYPE_CONTRACT_ID, ...}
    (reference ``makeFullContractIdPreimage`` + xdrSha256)."""
    p = Packer()
    p.pack_int(EnvelopeType.ENVELOPE_TYPE_CONTRACT_ID)
    HashIDPreimageContractID.pack(
        p, HashIDPreimageContractID(networkID=network_id,
                                    contractIDPreimage=preimage))
    return sha256(p.bytes())


def auth_payload_hash(network_id: bytes, nonce: int,
                      expiration_ledger: int, invocation) -> bytes:
    """The signed payload of a SorobanAuthorizationEntry (reference
    HashIDPreimage ENVELOPE_TYPE_SOROBAN_AUTHORIZATION)."""
    from stellar_tpu_torch.xdr.contract import (
        HashIDPreimageSorobanAuthorization,
    )
    p = Packer()
    p.pack_int(EnvelopeType.ENVELOPE_TYPE_SOROBAN_AUTHORIZATION)
    HashIDPreimageSorobanAuthorization.pack(
        p, HashIDPreimageSorobanAuthorization(
            networkID=network_id, nonce=nonce,
            signatureExpirationLedger=expiration_ledger,
            invocation=invocation))
    return sha256(p.bytes())


def make_instance_val(code_hash: bytes):
    return SCVal.make(T.SCV_CONTRACT_INSTANCE, SCContractInstance(
        executable=ContractExecutable.make(
            ContractExecutableType.CONTRACT_EXECUTABLE_WASM, code_hash),
        storage=None))


# ---------------------------------------------------------------------------
# Budget + storage
# ---------------------------------------------------------------------------

# interpreter cost model (plays the role of the wasm cost types)
CPU_PER_INSTRUCTION = 500
CPU_PER_STORAGE_OP = 2_000
CPU_PER_BYTE = 2
MEM_PER_STACK_SLOT = 64
# one wasm instruction in budget cpu units (reference soroban cost
# model's WasmInsnExec ~ 4 cpu instructions per wasm instruction)
CPU_PER_WASM_INSN = 4

# record contract log/diagnostic calls into InvokeOutput.diagnostics
# (reference ENABLE_SOROBAN_DIAGNOSTIC_EVENTS; set by Application)
DIAGNOSTIC_EVENTS_ENABLED = False

# execute wasm through the native C++ engine when its build is
# available (identical semantics + charge stream; differential tests
# pin it) — False forces the pure-Python engine
USE_NATIVE_WASM = True


from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
from stellar_tpu_torch.soroban import cost_model as _cm

_DEFAULT_COST_PARAMS = None


def _default_cost_params():
    """Current-protocol initial tables, computed once per process (the
    fallback when a budget is built without explicit params)."""
    global _DEFAULT_COST_PARAMS
    if _DEFAULT_COST_PARAMS is None:
        _DEFAULT_COST_PARAMS = (
            _cm.initial_cost_params(CURRENT_LEDGER_PROTOCOL_VERSION,
                                    "cpu"),
            _cm.initial_cost_params(CURRENT_LEDGER_PROTOCOL_VERSION,
                                    "mem"))
    return _DEFAULT_COST_PARAMS


class _Budget:
    def __init__(self, cpu_limit: int, mem_limit: int,
                 cpu_params=None, mem_params=None):
        self.cpu_limit = cpu_limit
        self.mem_limit = mem_limit
        self.cpu = 0
        self.mem = 0
        # calibrated metered cost vectors [(const, linear)] indexed by
        # ContractCostType (soroban/cost_model.py); None = the
        # reference's initial tables for the current protocol
        self.cpu_params = cpu_params
        self.mem_params = mem_params

    def charge(self, cpu: int, mem: int = 0):
        self.cpu += cpu
        self.mem += mem
        if self.cpu > self.cpu_limit or self.mem > self.mem_limit:
            raise HostError(HostError.BUDGET, "budget exceeded")

    def wasm_insn_cost(self) -> int:
        """Per-wasm-instruction cpu price from the active cost table
        (WasmInsnExec const term) — upgradable consensus state, so the
        engines must read it here, never a compile-time constant."""
        if self.cpu_params is None:
            self.cpu_params, self.mem_params = _default_cost_params()
        return self.cpu_params[0][0] if self.cpu_params else \
            CPU_PER_WASM_INSN

    def charge_type(self, type_idx: int, input_size: int = 0,
                    iterations: int = 1):
        """Charge by ContractCostType through the calibrated linear
        model (reference: Budget::charge with a CostType — both the
        cpu-instructions and memory-bytes dimensions at once). Runs on
        the metered hot path: no per-call imports (_cm is bound at
        module load)."""
        if self.cpu_params is None:
            self.cpu_params, self.mem_params = _default_cost_params()
        cpu = _cm.eval_cost(self.cpu_params, type_idx, input_size)
        mem = _cm.eval_cost(self.mem_params, type_idx, input_size)
        if iterations != 1:
            cpu *= iterations
            mem *= iterations
        self.charge(cpu, mem)


class _Storage:
    """Footprint-enforced entry access with read/write accounting."""

    def __init__(self, entries: Dict[bytes, Tuple], read_only: set,
                 read_write: set, budget: _Budget, ledger_seq: int):
        # kb -> [LedgerEntry|None, live_until|None, dirty]
        self.entries = {kb: [e, lu, False]
                        for kb, (e, lu) in entries.items()}
        self.read_only = read_only
        self.read_write = read_write
        self.budget = budget
        self.ledger_seq = ledger_seq
        # declared-resource accounting charges each entry ONCE per axis
        # (reference: footprint entries load once / write once at the
        # end), however often the contract touches it
        self._read_charged: set = set()
        self._write_sizes: Dict[bytes, int] = {}
        # kb -> serialized LedgerEntry size; entries only change via
        # put() (which recomputes), so repeated gets reuse the size
        # instead of re-serializing the whole entry each access
        self._entry_sizes: Dict[bytes, int] = {}
        self.read_bytes = 0
        # kb -> new live_until from in-contract TTL extensions
        # (separate from dirty slots: a TTL-only bump must not rewrite
        # the data entry, mirroring ExtendFootprintTTLOp semantics)
        self.ttl_extensions: Dict[bytes, int] = {}

    @property
    def write_bytes(self) -> int:
        return sum(self._write_sizes.values())

    def _check_live(self, kb: bytes, slot):
        lu = slot[1]
        if slot[0] is not None and lu is not None and lu < self.ledger_seq:
            raise HostError(HostError.ARCHIVED, "entry is archived")

    def get(self, kb: bytes):
        if kb not in self.read_only and kb not in self.read_write:
            raise HostError(HostError.TRAPPED,
                            "read outside declared footprint")
        slot = self.entries.get(kb)
        if slot is None or slot[0] is None:
            return None
        self._check_live(kb, slot)
        size = self._entry_sizes.get(kb)
        if size is None:
            size = len(to_bytes(LedgerEntry, slot[0]))
            self._entry_sizes[kb] = size
        if kb not in self._read_charged:
            self._read_charged.add(kb)
            self.read_bytes += size
        self.budget.charge(CPU_PER_STORAGE_OP + CPU_PER_BYTE * size)
        return slot[0]

    def put(self, kb: bytes, entry: LedgerEntry,
            live_until: Optional[int]):
        if kb not in self.read_write:
            raise HostError(HostError.TRAPPED,
                            "write outside declared footprint")
        size = len(to_bytes(LedgerEntry, entry))
        self._write_sizes[kb] = size  # final size counts, once per key
        self._entry_sizes[kb] = size
        self.budget.charge(CPU_PER_STORAGE_OP + CPU_PER_BYTE * size, size)
        slot = self.entries.setdefault(kb, [None, None, False])
        slot[0] = entry
        if live_until is not None and \
                (slot[1] is None or slot[1] < live_until):
            slot[1] = live_until
        slot[2] = True

    def delete(self, kb: bytes):
        if kb not in self.read_write:
            raise HostError(HostError.TRAPPED,
                            "delete outside declared footprint")
        self.budget.charge(CPU_PER_STORAGE_OP)
        slot = self.entries.setdefault(kb, [None, None, False])
        slot[0] = None
        slot[2] = True
        self._entry_sizes.pop(kb, None)


# ---------------------------------------------------------------------------
# Auth
# ---------------------------------------------------------------------------

def _address_bytes(addr) -> bytes:
    return to_bytes(SCAddress, addr)


class _AuthContext:
    """Verified-but-unconsumed authorizations (reference host's
    require_auth against SorobanAuthorizationEntry trees; one level —
    no sub-invocations until cross-contract calls land).

    CONTRACT-address credentials are CUSTOM ACCOUNTS (reference
    account abstraction): their signatures are not checked here but by
    dispatching ``__check_auth(payload, signatures)`` on the contract
    itself, deferred to the first matching ``require`` (the host must
    exist to run contract code). A rejecting or trapping __check_auth
    fails authorization; reentrant dispatch is refused."""

    def __init__(self, auth_entries, source_account, network_id: bytes,
                 ledger_seq: int, storage: _Storage, verify_sig):
        # addr bytes -> [(fn, check_cell|None)]; a check cell is one
        # auth ENTRY's deferred __check_auth state, shared by every fn
        # the entry's invocation tree authorizes and dispatched only
        # when one of THOSE fns is actually required (unused entries
        # stay unchecked, like the reference)
        self.available: Dict[bytes, list] = {}
        self.source_addr = _address_bytes(
            scaddress_account(source_account))
        self.storage = storage
        self.host = None  # back-ref set by invoke_host_function
        self._checking_addr: Optional[bytes] = None
        for entry in auth_entries:
            cred = entry.credentials
            cell = None
            if cred.arm == \
                    SorobanCredentialsType.SOROBAN_CREDENTIALS_SOURCE_ACCOUNT:
                key = self.source_addr
            else:
                ac = cred.value  # SorobanAddressCredentials
                if ac.signatureExpirationLedger < ledger_seq:
                    raise HostError(HostError.AUTH,
                                    "auth signature expired")
                payload = auth_payload_hash(
                    network_id, ac.nonce, ac.signatureExpirationLedger,
                    entry.rootInvocation)
                key = _address_bytes(ac.address)
                if ac.address.arm == \
                        SCAddressType.SC_ADDRESS_TYPE_CONTRACT:
                    cell = {"ac": ac, "payload": payload,
                            "verified": False}
                else:
                    self._verify_address_signature(ac, payload,
                                                   verify_sig)
                self._consume_nonce(ac, ledger_seq)
            # the whole invocation tree is authorized: flatten root +
            # subInvocations (cross-contract calls consume sub-entries)
            fns: list = []
            self._flatten(entry.rootInvocation, fns)
            self.available.setdefault(key, []).extend(
                (fn, cell) for fn in fns)

    @staticmethod
    def _flatten(inv, out: list):
        out.append(inv.function)
        for sub in inv.subInvocations:
            _AuthContext._flatten(sub, out)

    def _verify_address_signature(self, ac, payload: bytes, verify_sig):
        """Signature SCVal: vec of maps {public_key: bytes, signature:
        bytes} — the account-contract format the reference host checks."""
        if ac.address.arm != SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            raise HostError(HostError.AUTH,
                            "only account addresses supported")
        want = account_ed25519(ac.address.value)
        sig_val = ac.signature
        if sig_val.arm != T.SCV_VEC or not sig_val.value:
            raise HostError(HostError.AUTH, "malformed auth signature")
        ok = False
        for item in sig_val.value:
            if item.arm != T.SCV_MAP:
                raise HostError(HostError.AUTH, "malformed auth signature")
            kv = {e.key.value: e.val.value for e in item.value}
            pk, sg = kv.get(b"public_key"), kv.get(b"signature")
            if pk is None or sg is None:
                raise HostError(HostError.AUTH, "malformed auth signature")
            from stellar_tpu_torch.crypto.keys import PublicKey
            if not verify_sig(PublicKey(pk), payload, sg):
                raise HostError(HostError.AUTH, "bad auth signature")
            if pk == want:
                ok = True
        if not ok:
            raise HostError(HostError.AUTH,
                            "no signature from the authorizing address")

    def _consume_nonce(self, ac, ledger_seq: int):
        """Replay protection: a TEMPORARY nonce entry must not already
        exist and is created to the signature's expiration (reference
        host ``consume_nonce``). The entry rides the declared
        footprint."""
        nonce_key = contract_data_key(
            ac.address, SCVal.make(T.SCV_LEDGER_KEY_NONCE,
                                   SCNonceKey(nonce=ac.nonce)),
            ContractDataDurability.TEMPORARY)
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        kb = key_bytes(nonce_key)
        if self.storage.get(kb) is not None:
            raise HostError(HostError.AUTH, "auth nonce already used")
        entry = ContractDataEntry(
            ext=ExtensionPoint.make(0), contract=ac.address,
            key=SCVal.make(T.SCV_LEDGER_KEY_NONCE,
                           SCNonceKey(nonce=ac.nonce)),
            durability=ContractDataDurability.TEMPORARY,
            val=SCVal.make(T.SCV_VOID))
        self.storage.put(kb, _wrap_entry(
            LedgerEntryType.CONTRACT_DATA, entry, ledger_seq),
            ac.signatureExpirationLedger)

    def require(self, addr_bytes: bytes, invoked_fn, depth: int = 0):
        """Consume one matching authorization or trap (reference
        require_auth semantics); a custom-account entry runs ITS
        __check_auth (once) before its first fn is consumed."""
        from stellar_tpu_torch.xdr.contract import SorobanAuthorizedFunction
        if self._checking_addr == addr_bytes:
            # require_auth for the account whose __check_auth is
            # currently running: refuse reentry (reference rule)
            raise HostError(HostError.AUTH,
                            "reentrant require_auth in __check_auth")
        want = to_bytes(SorobanAuthorizedFunction, invoked_fn)
        entries = self.available.get(addr_bytes, [])
        for i, (fn, cell) in enumerate(entries):
            if to_bytes(SorobanAuthorizedFunction, fn) == want:
                if cell is not None and not cell["verified"]:
                    self._run_check_auth(addr_bytes, cell, depth)
                    cell["verified"] = True
                # the list was not mutated by the dispatch: reentrant
                # requires for this address are refused above, and
                # other addresses touch their own lists only — but
                # re-locate defensively rather than pop a stale index
                try:
                    entries.remove((fn, cell))
                except ValueError:
                    raise HostError(HostError.AUTH,
                                    "authorization consumed reentrantly")
                return
        raise HostError(HostError.AUTH, "missing authorization")

    def _run_check_auth(self, addr_bytes: bytes, cell, depth: int):
        if self.host is None:
            raise HostError(HostError.AUTH,
                            "custom account auth unavailable")
        if self._checking_addr is not None:
            raise HostError(HostError.AUTH, "reentrant __check_auth")
        self._checking_addr = addr_bytes
        try:
            ac = cell["ac"]
            try:
                # depth continues the CURRENT chain: __check_auth does
                # not reset the shared call-depth budget
                self.host.call_contract(
                    ac.address, b"__check_auth",
                    [scbytes(cell["payload"]), ac.signature],
                    depth + 1)
            except HostError as e:
                if e.kind == HostError.BUDGET:
                    raise
                raise HostError(
                    HostError.AUTH,
                    f"__check_auth rejected authorization: {e}")
        finally:
            self._checking_addr = None


def _wrap_entry(t, body, ledger_seq: int) -> LedgerEntry:
    return LedgerEntry(
        lastModifiedLedgerSeq=ledger_seq,
        data=LedgerEntry._types[1].make(t, body),
        ext=LedgerEntry._types[2].make(0))


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

_DUR = {b"temporary": ContractDataDurability.TEMPORARY,
        b"persistent": ContractDataDurability.PERSISTENT}

_INT_ARMS = {T.SCV_U32: (0, 2**32 - 1), T.SCV_I32: (-2**31, 2**31 - 1),
             T.SCV_U64: (0, 2**64 - 1), T.SCV_I64: (-2**63, 2**63 - 1)}


def _truthy(v) -> bool:
    if v.arm == T.SCV_BOOL:
        return bool(v.value)
    if v.arm == T.SCV_VOID:
        return False
    if v.arm in _INT_ARMS:
        return v.value != 0
    return True


MAX_CALL_DEPTH = 10


class _Interp:
    def __init__(self, host: "_Host", contract_addr, program: Dict,
                 invocation=None, depth: int = 0):
        self.host = host
        self.contract_addr = contract_addr
        self.program = program  # fn name bytes -> list of instructions
        self.invocation = invocation  # SorobanAuthorizedFunction
        self.depth = depth

    def run(self, fn_name: bytes, args: List):
        body = self.program.get(fn_name)
        if body is None:
            raise HostError(HostError.TRAPPED,
                            f"no such function {fn_name!r}")
        stack: List = []
        budget = self.host.budget
        pc = 0
        n = len(body)
        while pc < n:
            budget.charge(CPU_PER_INSTRUCTION, MEM_PER_STACK_SLOT)
            instr = body[pc]
            pc += 1
            if instr.arm != T.SCV_VEC or not instr.value or \
                    instr.value[0].arm != T.SCV_SYMBOL:
                raise HostError(HostError.TRAPPED, "malformed instruction")
            op = instr.value[0].value
            a = instr.value[1:]
            if op == b"push":
                stack.append(a[0])
            elif op == b"arg":
                i = a[0].value
                if i >= len(args):
                    raise HostError(HostError.TRAPPED, "arg out of range")
                stack.append(args[i])
            elif op == b"dup":
                stack.append(stack[-1])
            elif op == b"drop":
                stack.pop()
            elif op == b"swap":
                stack[-1], stack[-2] = stack[-2], stack[-1]
            elif op == b"over":
                # copy the second item to the top: [a, b] -> [a, b, a]
                stack.append(stack[-2])
            elif op in (b"add", b"sub", b"mul", b"div", b"mod"):
                rhs, lhs = stack.pop(), stack.pop()
                stack.append(self._arith(op, lhs, rhs))
            elif op in (b"eq", b"lt", b"gt"):
                rhs, lhs = stack.pop(), stack.pop()
                stack.append(self._compare(op, lhs, rhs))
            elif op == b"not":
                stack.append(SCVal.make(T.SCV_BOOL,
                                        not _truthy(stack.pop())))
            elif op == b"jmp":
                pc += a[0].value
            elif op == b"jz":
                if not _truthy(stack.pop()):
                    pc += a[0].value
            elif op in (b"get", b"put", b"del", b"has"):
                self._storage_op(op, a, stack)
            elif op == b"require_auth":
                addr = stack.pop()
                self.host.require_auth(addr, self.invocation,
                                       self.depth)
            elif op == b"call":
                # cross-contract call: ["call", n_args]; stack holds
                # [addr, fn_symbol, arg1..argN]
                n_args = a[0].value if a else 0
                call_args = [stack.pop() for _ in range(n_args)][::-1]
                fn_sym = stack.pop()
                addr_val = stack.pop()
                if addr_val.arm != T.SCV_ADDRESS or \
                        fn_sym.arm != T.SCV_SYMBOL:
                    raise HostError(HostError.TRAPPED,
                                    "call needs (address, symbol)")
                stack.append(self.host.call_contract(
                    addr_val.value, fn_sym.value, call_args,
                    self.depth + 1))
            elif op == b"event":
                data = stack.pop()
                topic = stack.pop()
                self.host.emit_event(self.contract_addr, [topic], data)
            elif op == b"ret":
                return stack.pop() if stack else SCVal.make(T.SCV_VOID)
            elif op == b"fail":
                raise HostError(HostError.TRAPPED, "explicit trap")
            elif op == b"len":
                v = stack.pop()
                if v.arm not in (T.SCV_VEC, T.SCV_MAP, T.SCV_BYTES):
                    raise HostError(HostError.TRAPPED, "len on non-seq")
                stack.append(u32(len(v.value or ())))
            elif op == b"index":
                i, v = stack.pop(), stack.pop()
                if v.arm != T.SCV_VEC or i.value >= len(v.value or ()):
                    raise HostError(HostError.TRAPPED, "bad index")
                stack.append(v.value[i.value])
            else:
                raise HostError(HostError.TRAPPED,
                                f"unknown op {op!r}")
        return SCVal.make(T.SCV_VOID)

    def _arith(self, op, lhs, rhs):
        if lhs.arm != rhs.arm or lhs.arm not in _INT_ARMS:
            raise HostError(HostError.TRAPPED, "type mismatch")
        lo, hi = _INT_ARMS[lhs.arm]
        x, y = lhs.value, rhs.value
        if op in (b"div", b"mod") and y == 0:
            raise HostError(HostError.TRAPPED, "division by zero")
        r = {b"add": x + y, b"sub": x - y, b"mul": x * y,
             b"div": x // y if (x >= 0) == (y >= 0) else -((-x) // y)
             if y != 0 else 0,
             b"mod": x % y if y != 0 else 0}[op]
        if not (lo <= r <= hi):
            raise HostError(HostError.TRAPPED, "arithmetic overflow")
        return SCVal.make(lhs.arm, r)

    def _compare(self, op, lhs, rhs):
        if lhs.arm != rhs.arm:
            raise HostError(HostError.TRAPPED, "type mismatch")
        if lhs.arm in _INT_ARMS or lhs.arm in (T.SCV_BYTES, T.SCV_SYMBOL,
                                               T.SCV_STRING):
            x, y = lhs.value, rhs.value
        else:
            x, y = to_bytes(SCVal, lhs), to_bytes(SCVal, rhs)
        r = {b"eq": x == y, b"lt": x < y, b"gt": x > y}[op]
        return SCVal.make(T.SCV_BOOL, r)

    def _storage_op(self, op, a, stack):
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        if a and a[0].arm == T.SCV_SYMBOL and a[0].value == b"instance":
            return self._instance_storage_op(op, stack)
        dur = _DUR.get(a[0].value if a else b"persistent")
        if dur is None:
            raise HostError(HostError.TRAPPED, "bad durability")
        host = self.host
        if op == b"put":
            val = stack.pop()
            key = stack.pop()
            host.data_put(self.contract_addr, key, val, dur)
        else:
            key = stack.pop()
            kb = key_bytes(
                contract_data_key(self.contract_addr, key, dur))
            if op == b"get":
                v = host.data_get(kb)
                stack.append(v if v is not None
                             else SCVal.make(T.SCV_VOID))
            elif op == b"has":
                stack.append(SCVal.make(T.SCV_BOOL,
                                        host.data_get(kb) is not None))
            else:
                host.data_del(kb)

    def _instance_storage_op(self, op, stack):
        """Instance storage: the SCMap inside the contract's instance
        entry (reference host instance storage — shares the instance's
        lifetime and footprint slot)."""
        host = self.host
        val = stack.pop() if op == b"put" else None
        key = stack.pop()
        if op == b"get":
            v = host.instance_get(self.contract_addr, key)
            stack.append(v if v is not None else SCVal.make(T.SCV_VOID))
        elif op == b"has":
            stack.append(SCVal.make(
                T.SCV_BOOL,
                host.instance_get(self.contract_addr, key) is not None))
        elif op == b"put":
            host.instance_put(self.contract_addr, key, val)
        else:
            host.instance_del(self.contract_addr, key)


# ---------------------------------------------------------------------------
# The host entry point
# ---------------------------------------------------------------------------

@dataclass
class InvokeOutput:
    success: bool
    return_value: Optional[object] = None
    # kb -> (LedgerEntry|None, live_until|None) for dirtied slots
    modified: Dict[bytes, Tuple] = field(default_factory=dict)
    # kb -> new live_until for TTL-only extensions (entry untouched)
    ttl_extensions: Dict[bytes, int] = field(default_factory=dict)
    events: List = field(default_factory=list)
    # contract log/debug output (SCVals), populated only when
    # DIAGNOSTIC_EVENTS_ENABLED (never consensus-visible)
    diagnostics: List = field(default_factory=list)
    cpu_insns: int = 0
    mem_bytes: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    error: Optional[str] = None  # HostError kind


class _Prng:
    """Deterministic host PRNG (reference soroban ``prng`` module):
    counter-mode SHA-256 over a per-invocation seed. Every node
    derives the identical stream, so contract randomness is
    consensus-safe; each contract frame forks its own stream
    (reference: per-frame PRNGs forked from the base)."""

    __slots__ = ("_seed", "_counter", "_buf")

    def __init__(self, seed: bytes):
        self._seed = seed
        self._counter = 0
        self._buf = b""

    def take(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += sha256(
                self._seed + self._counter.to_bytes(8, "little"))
            self._counter += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def u64_in_range(self, lo: int, hi: int) -> int:
        if lo > hi:
            raise HostError(HostError.TRAPPED, "empty prng range")
        span = hi - lo + 1
        if span == 1 << 64:
            return self.u64()
        # rejection sampling: deterministic AND unbiased
        limit = ((1 << 64) // span) * span
        while True:
            v = self.u64()
            if v < limit:
                return lo + (v % span)

    def fork(self, salt: bytes) -> "_Prng":
        return _Prng(sha256(self._seed + salt))

    def reseed(self, seed: bytes):
        self._seed = sha256(seed)
        self._counter = 0
        self._buf = b""


class _Host:
    def __init__(self, storage: _Storage, budget: _Budget, auth,
                 config, ledger_seq: int,
                 prng_seed: Optional[bytes] = None,
                 network_id: bytes = b"\x00" * 32):
        self.storage = storage
        self.budget = budget
        self.auth = auth
        self.config = config
        self.ledger_seq = ledger_seq
        self.network_id = network_id
        self.events: List = []
        self._events_size = 0  # running serialized size (limit check)
        self.diagnostics: List = []
        self.base_prng = _Prng(prng_seed if prng_seed is not None
                               else b"\x00" * 32)
        self._prng_forks = 0
        # active contract frames (SCAddress bytes, bottom -> top):
        # drives the direct-contract-invoker implicit authorization
        self.frame_addrs: List[bytes] = []
        # authorize_as_curr_contract registrations, scoped to the
        # granting frame: authorizer addr bytes ->
        # [(granting frame depth, SorobanAuthorizedFunction bytes)];
        # pruned when the granting frame exits (reference: these
        # entries live only for the current invocation)
        self.contract_auths: Dict[bytes, List[Tuple[int, bytes]]] = {}

    def snapshot(self):
        """Frame snapshot for try_call rollback: storage slots +
        accounting, events, and auth consumption state. The budget is
        deliberately NOT captured — metering consumed by a failed
        callee stays consumed (reference try_call semantics)."""
        st = self.storage
        return (
            {kb: list(slot) for kb, slot in st.entries.items()},
            dict(st.ttl_extensions),
            len(self.events), len(self.diagnostics),
            # deep-copy the per-entry __check_auth cells: a rolled-back
            # frame must not leave cell["verified"]=True behind while
            # the storage effects that verification depended on are
            # undone
            {k: [(fn, dict(c) if c is not None else None)
                 for fn, c in v]
             for k, v in self.auth.available.items()}
            if self.auth is not None else None,
            {k: list(v) for k, v in self.contract_auths.items()},
            set(st._read_charged), dict(st._write_sizes),
            st.read_bytes, self._events_size, dict(st._entry_sizes),
        )

    def restore(self, snap):
        st = self.storage
        (st.entries, st.ttl_extensions, n_ev, n_diag, avail,
         cauths, st._read_charged, st._write_sizes,
         st.read_bytes, self._events_size, st._entry_sizes) = snap
        del self.events[n_ev:]
        del self.diagnostics[n_diag:]
        if avail is not None:
            self.auth.available = avail
        self.contract_auths = cauths

    def fork_prng(self) -> _Prng:
        """A fresh per-frame PRNG stream (deterministic fork order)."""
        self._prng_forks += 1
        return self.base_prng.fork(
            self._prng_forks.to_bytes(8, "little"))

    def require_auth(self, addr, invocation, depth: int = 0):
        if addr.arm != T.SCV_ADDRESS:
            raise HostError(HostError.TRAPPED,
                            "require_auth on non-address")
        ab = _address_bytes(addr.value)
        # the DIRECT caller contract is implicitly authorized for the
        # frame it invoked (reference contract-invoker rule); deeper
        # sub-invocations need authorize_as_curr_contract entries
        if len(self.frame_addrs) >= 2 and ab == self.frame_addrs[-2]:
            return
        regs = self.contract_auths.get(ab)
        if regs and invocation is not None:
            from stellar_tpu_torch.xdr.contract import (
                SorobanAuthorizedFunction,
            )
            want = to_bytes(SorobanAuthorizedFunction, invocation)
            for i, (_d, fb) in enumerate(regs):
                if fb == want:
                    regs.pop(i)
                    return
        self.auth.require(ab, invocation, depth)

    def prune_contract_auths(self):
        """Drop authorize_as_curr_contract grants whose granting frame
        has exited (called on every frame pop)."""
        live = len(self.frame_addrs)
        for ab in list(self.contract_auths):
            kept = [(d, fb) for d, fb in self.contract_auths[ab]
                    if d <= live]
            if kept:
                self.contract_auths[ab] = kept
            else:
                del self.contract_auths[ab]

    def call_contract(self, addr, fn_name: bytes, args: List,
                      depth: int):
        """Cross-contract invocation sharing budget/storage/auth."""
        if depth > MAX_CALL_DEPTH:
            raise HostError(HostError.TRAPPED, "call depth exceeded")
        from stellar_tpu_torch.xdr.contract import InvokeContractArgs
        return _run_contract(
            self, InvokeContractArgs(contractAddress=addr,
                                     functionName=fn_name,
                                     args=list(args)), depth)

    def emit_event(self, contract_addr, topics, data):
        ev = ContractEvent(
            ext=ExtensionPoint.make(0),
            contractID=contract_addr.value,
            type=ContractEventType.CONTRACT,
            body=ContractEvent._types[3].make(
                0, ContractEventV0(topics=topics, data=data)))
        size = len(to_bytes(ContractEvent, ev))
        # running total, NOT a re-serialization of every prior event
        # (that would be quadratic in the event count)
        if self._events_size + size > \
                self.config.tx_max_contract_events_size_bytes:
            raise HostError(HostError.BUDGET, "events size limit")
        self.budget.charge(CPU_PER_INSTRUCTION + CPU_PER_BYTE * size, size)
        self._events_size += size
        self.events.append(ev)

    # ---- contract-data storage (shared by both execution engines) ----

    def data_put(self, contract_addr, key, val, dur):
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        entry = ContractDataEntry(
            ext=ExtensionPoint.make(0), contract=contract_addr,
            key=key, durability=dur, val=val)
        kb = key_bytes(contract_data_key(contract_addr, key, dur))
        is_new = self.storage.entries.get(kb, [None])[0] is None
        live_until = None
        if is_new:
            ttl = self.config.min_persistent_ttl \
                if dur == ContractDataDurability.PERSISTENT \
                else self.config.min_temporary_ttl
            live_until = self.ledger_seq + ttl - 1
        self.storage.put(kb, _wrap_entry(
            LedgerEntryType.CONTRACT_DATA, entry, self.ledger_seq),
            live_until)

    def data_get(self, kb: bytes):
        """Stored SCVal for a data key, or None."""
        e = self.storage.get(kb)
        return None if e is None else e.data.value.val

    def data_del(self, kb: bytes):
        self.storage.delete(kb)

    def _instance_entry(self, contract_addr):
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        kb = key_bytes(contract_data_key(
            contract_addr, SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE),
            ContractDataDurability.PERSISTENT))
        entry = self.storage.get(kb)
        if entry is None:
            raise HostError(HostError.TRAPPED, "missing instance entry")
        return kb, entry.data.value.val.value  # SCContractInstance

    def instance_get(self, contract_addr, key):
        _kb, inst = self._instance_entry(contract_addr)
        key_b = to_bytes(SCVal, key)
        for e in (inst.storage or ()):
            if to_bytes(SCVal, e.key) == key_b:
                return e.val
        return None

    def instance_put(self, contract_addr, key, val):
        self._instance_update(contract_addr, key, val, delete=False)

    def instance_del(self, contract_addr, key):
        self._instance_update(contract_addr, key, None, delete=True)

    def extend_ttl(self, kb: bytes, threshold: int, extend_to: int):
        """In-contract TTL extension (reference host
        ``extend_contract_data_ttl``): when the entry's remaining
        lifetime sits below ``threshold`` ledgers, raise live_until to
        now + extend_to (capped by max_entry_ttl). Declared-footprint
        keys only; read-only keys allowed (like ExtendFootprintTTLOp)."""
        st = self.storage
        if kb not in st.read_only and kb not in st.read_write:
            raise HostError(HostError.TRAPPED,
                            "TTL extension outside declared footprint")
        if threshold > extend_to:
            raise HostError(HostError.TRAPPED,
                            "TTL threshold above extend_to")
        if extend_to > self.config.max_entry_ttl - 1:
            raise HostError(HostError.TRAPPED, "extend_to above max TTL")
        slot = st.entries.get(kb)
        if slot is None or slot[0] is None:
            raise HostError(HostError.TRAPPED,
                            "missing entry for TTL extension")
        st._check_live(kb, slot)
        self.budget.charge(CPU_PER_STORAGE_OP)
        cur_live = st.ttl_extensions.get(kb, slot[1])
        if cur_live is None:
            return  # entry carries no TTL (nothing to extend)
        if cur_live - self.ledger_seq < threshold:
            new_live = self.ledger_seq + extend_to
            if new_live > cur_live:
                st.ttl_extensions[kb] = new_live

    def _instance_update(self, contract_addr, key, val, delete: bool):
        kb, inst = self._instance_entry(contract_addr)
        storage = list(inst.storage or ())
        key_b = to_bytes(SCVal, key)
        idx = next((i for i, e in enumerate(storage)
                    if to_bytes(SCVal, e.key) == key_b), None)
        if delete:
            if idx is None:
                return
            del storage[idx]
        elif idx is not None:
            storage[idx] = SCMapEntry(key=key, val=val)
        else:
            storage.append(SCMapEntry(key=key, val=val))
            storage.sort(key=lambda e: to_bytes(SCVal, e.key))
        new_inst = ContractDataEntry(
            ext=ExtensionPoint.make(0), contract=contract_addr,
            key=SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE),
            durability=ContractDataDurability.PERSISTENT,
            val=SCVal.make(T.SCV_CONTRACT_INSTANCE, SCContractInstance(
                executable=inst.executable, storage=storage or None)))
        self.storage.put(kb, _wrap_entry(
            LedgerEntryType.CONTRACT_DATA, new_inst, self.ledger_seq),
            None)


def invoke_host_function(host_fn, footprint_entries: Dict[bytes, Tuple],
                         read_only: set, read_write: set, auth_entries,
                         source_account, network_id: bytes,
                         ledger_seq: int, config,
                         cpu_limit: Optional[int] = None,
                         ledger_header=None,
                         tx_hash: Optional[bytes] = None) -> InvokeOutput:
    """Execute one HostFunction against declared state (the lib.rs
    boundary). ``footprint_entries``: kb -> (LedgerEntry|None,
    live_until|None) for every declared key that exists."""
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.ledger.network_config import effective_cost_params
    proto = ledger_header.ledgerVersion if ledger_header is not None \
        else CURRENT_LEDGER_PROTOCOL_VERSION
    budget = _Budget(cpu_limit if cpu_limit is not None
                     else config.tx_max_instructions,
                     config.tx_memory_limit,
                     cpu_params=effective_cost_params(config, proto,
                                                      "cpu"),
                     mem_params=effective_cost_params(config, proto,
                                                      "mem"))
    storage = _Storage(footprint_entries, read_only, read_write, budget,
                       ledger_seq)
    out = InvokeOutput(success=False)
    host = None
    try:
        auth = _AuthContext(auth_entries, source_account, network_id,
                            ledger_seq, storage, _verify_sig)
        # PRNG seed: every node derives the same stream for this
        # invocation (reference: per-tx sub-seed) — the TX HASH makes
        # it unique per transaction, so a copycat invocation in the
        # same ledger cannot predict another tx's stream
        from stellar_tpu_torch.xdr.contract import HostFunction as _HF
        prng_seed = sha256(network_id +
                           ledger_seq.to_bytes(8, "little") +
                           (tx_hash if tx_hash is not None
                            else to_bytes(_HF, host_fn)))
        host = _Host(storage, budget, auth, config, ledger_seq,
                     prng_seed=prng_seed, network_id=network_id)
        auth.host = host  # custom-account __check_auth dispatch
        host.ledger_header = ledger_header  # classic reserve math (SAC)
        t = host_fn.arm
        if t == HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM:
            rv = _upload(host, host_fn.value, read_write)
        elif t in (HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
                   HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT_V2):
            rv = _create(host, host_fn.value, network_id)
        elif t == HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT:
            rv = _invoke(host, host_fn.value)
        else:
            raise HostError(HostError.TRAPPED, "unknown host function")
        out.success = True
        out.return_value = rv
        out.events = host.events
        out.diagnostics = host.diagnostics
    except HostError as e:
        out.error = e.kind
        # diagnostics accumulated up to the failure still surface —
        # debugging trapping contracts is their main use
        if host is not None:
            out.diagnostics = host.diagnostics
    out.cpu_insns = budget.cpu
    out.mem_bytes = budget.mem
    out.read_bytes = storage.read_bytes
    out.write_bytes = storage.write_bytes
    if out.success:
        out.modified = {kb: (slot[0],
                             max(slot[1] or 0,
                                 storage.ttl_extensions.get(kb, 0))
                             or None)
                        for kb, slot in storage.entries.items()
                        if slot[2]}
        out.ttl_extensions = {
            kb: lu for kb, lu in storage.ttl_extensions.items()
            if kb not in out.modified}
    return out


def _verify_sig(pk, payload, sig) -> bool:
    from stellar_tpu_torch.crypto.keys import verify_sig
    return verify_sig(pk, payload, sig)


from stellar_tpu_torch.utils.cache import RandomEvictionCache as _REC

_PROGRAM_CACHE: "_REC" = _REC(128)


def _parse_program(code: bytes) -> Dict[bytes, List]:
    """Decoded SCVal program for ``code``, memoized by content hash —
    the interpreter-side analogue of the parsed-wasm module cache."""
    h = sha256(code)
    cached = _PROGRAM_CACHE.maybe_get(h)
    if cached is not None:
        return cached
    try:
        val = from_bytes(SCVal, code)
    except Exception:
        raise HostError(HostError.TRAPPED, "unparsable contract code")
    if val.arm != T.SCV_MAP or val.value is None:
        raise HostError(HostError.TRAPPED, "contract code not a map")
    prog = {}
    for e in val.value:
        if e.key.arm != T.SCV_SYMBOL or e.val.arm != T.SCV_VEC:
            raise HostError(HostError.TRAPPED, "bad function entry")
        prog[e.key.value] = list(e.val.value or ())
    _PROGRAM_CACHE.put(h, prog)
    return prog


_MODULE_CACHE: "_REC" = _REC(128)


def _parsed_module(code: bytes):
    """Validated WasmModule for ``code``, memoized by content hash
    (the reference host caches parsed+validated wasmi modules per code
    entry the same way)."""
    return _parsed_module_tracked(code)[0]


def _parsed_module_tracked(code: bytes):
    """(module, cache_hit) — the hit flag drives instantiation
    metering (parse costs are charged only on first touch)."""
    from stellar_tpu_torch.soroban.wasm import parse_module
    h = sha256(code)
    mod = _MODULE_CACHE.maybe_get(h)
    if mod is not None:
        return mod, True
    mod = parse_module(code)
    _MODULE_CACHE.put(h, mod)
    return mod, False


def _module_section_counts(module):
    """Per-section sizes in the order of the ParseWasm*/InstantiateWasm*
    cost types (instructions, functions, globals, table entries, types,
    data segments, elem segments, imports, exports, data bytes)."""
    cached = getattr(module, "_section_counts", None)
    if cached is None:
        cached = module._section_counts = (
            sum(len(f.ops) for f in module.funcs),
            len(module.funcs),
            len(module.globals),
            module.table_min,
            len(module.types),
            len(module.data),
            len(module.elements),
            len(module.imports),
            len(module.exports),
            sum(len(d) for _off, d in module.data),
        )
    return cached


_PARSE_COST_TYPES = (
    _cm.CostType.ParseWasmInstructions, _cm.CostType.ParseWasmFunctions,
    _cm.CostType.ParseWasmGlobals, _cm.CostType.ParseWasmTableEntries,
    _cm.CostType.ParseWasmTypes, _cm.CostType.ParseWasmDataSegments,
    _cm.CostType.ParseWasmElemSegments, _cm.CostType.ParseWasmImports,
    _cm.CostType.ParseWasmExports,
    _cm.CostType.ParseWasmDataSegmentBytes,
)
_INSTANTIATE_COST_TYPES = (
    _cm.CostType.InstantiateWasmInstructions,
    _cm.CostType.InstantiateWasmFunctions,
    _cm.CostType.InstantiateWasmGlobals,
    _cm.CostType.InstantiateWasmTableEntries,
    _cm.CostType.InstantiateWasmTypes,
    _cm.CostType.InstantiateWasmDataSegments,
    _cm.CostType.InstantiateWasmElemSegments,
    _cm.CostType.InstantiateWasmImports,
    _cm.CostType.InstantiateWasmExports,
    _cm.CostType.InstantiateWasmDataSegmentBytes,
)


def _charge_vm_instantiation(budget, module, code_len: int,
                             protocol: int) -> None:
    """Era-correct VM setup metering: p20 charges VmInstantiation over
    the code length; p21+ splits it — ParseWasm* plus InstantiateWasm*
    by section, EVERY invocation (reference updateCpuCostParamsEntryForV21
    rationale, NetworkConfig.cpp:355+; the p21/p22 host re-parses per
    invocation). Deliberately independent of the process-local module
    cache: metering is consensus, and a cache-dependent charge would
    differ between a warm node and a freshly restarted one."""
    if protocol < 21:
        budget.charge_type(_cm.CostType.VmInstantiation, code_len)
        return
    counts = _module_section_counts(module)
    for ct, n in zip(_PARSE_COST_TYPES, counts):
        budget.charge_type(ct, n)
    for ct, n in zip(_INSTANTIATE_COST_TYPES, counts):
        budget.charge_type(ct, n)


class WasmContractEnv:
    """Per-contract-frame bridge between the wasm host imports
    (``soroban/env.py``) and the shared ``_Host`` services. Envs (and
    their import tables, ~140 closures) are POOLED per thread and
    reset per frame — the Val object table is cleared on acquire, so
    handles still never leak across contract boundaries.

    Everything the import-table closures capture must stay
    identity-stable across a reset: the env itself, its ValConverter,
    and the ``charge`` indirection below (the budget it forwards to is
    re-pointed on acquire)."""

    def __init__(self, host: "_Host", contract_addr, invocation,
                 depth: int):
        from stellar_tpu_torch.soroban.env import ValConverter
        self.host = host
        self.contract_addr = contract_addr
        self.invocation = invocation
        self.depth = depth
        self.cv = ValConverter(self.charge)
        self.prng = None  # per-frame stream, forked on first use

    def charge(self, cpu: int, mem: int = 0):
        # stable bound method: closures capture THIS, the budget
        # behind it follows the host of the current frame
        self.host.budget.charge(cpu, mem)

    def charge_type(self, type_idx: int, input_size: int = 0,
                    iterations: int = 1):
        # metered cost-model charge (ContractCostType + calibrated
        # params) — same identity-stability contract as ``charge``
        self.host.budget.charge_type(type_idx, input_size, iterations)

    def reset(self, host: "_Host", contract_addr, invocation,
              depth: int):
        self.host = host
        self.contract_addr = contract_addr
        self.invocation = invocation
        self.depth = depth
        self.cv.objs.clear()
        self.prng = None

    # storage bridges
    def data_put(self, key_sc, val_sc, dur):
        self.host.data_put(self.contract_addr, key_sc, val_sc, dur)

    def data_get(self, kb):
        return self.host.data_get(kb)

    def data_del(self, kb):
        self.host.data_del(kb)

    def instance_get(self, key_sc):
        return self.host.instance_get(self.contract_addr, key_sc)

    def instance_put(self, key_sc, val_sc):
        self.host.instance_put(self.contract_addr, key_sc, val_sc)

    def instance_del(self, key_sc):
        self.host.instance_del(self.contract_addr, key_sc)


import threading as _threading

_env_pool = _threading.local()


def _acquire_wasm_env(host: "_Host", contract_addr, invocation,
                      depth: int):
    """(env, modern import table) from the per-thread pool — building
    the table is ~100us of closure construction, pure overhead when
    paid per frame. Nested frames pop deeper entries; release returns
    them."""
    free = getattr(_env_pool, "free", None)
    if free is None:
        free = _env_pool.free = []
    if free:
        env, imports = free.pop()
        env.reset(host, contract_addr, invocation, depth)
        return env, imports
    from stellar_tpu_torch.soroban.env import make_imports
    env = WasmContractEnv(host, contract_addr, invocation, depth)
    return env, make_imports(env)


def _release_wasm_env(env, imports):
    # drop every reference to the finished frame — a pooled idle env
    # must not pin the invoke's host, auth tree, or PRNG state alive
    env.cv.objs.clear()
    env.host = None
    env.contract_addr = None
    env.invocation = None
    env.prng = None
    _env_pool.free.append((env, imports))


def _run_wasm_contract(host: "_Host", contract_addr, code: bytes,
                       fn_name: bytes, args: List, invocation,
                       depth: int):
    """Execute one exported function of a wasm contract (the wasmi
    dispatch inside the reference's soroban-env-host)."""
    from stellar_tpu_torch.soroban.env import make_imports
    from stellar_tpu_torch.soroban.wasm import Trap, WasmError, WasmInstance
    try:
        module = _parsed_module(code)
    except WasmError as e:
        raise HostError(HostError.TRAPPED, f"invalid wasm: {e}")
    budget = host.budget
    hdr = getattr(host, "ledger_header", None)
    proto = hdr.ledgerVersion if hdr is not None else \
        CURRENT_LEDGER_PROTOCOL_VERSION
    _charge_vm_instantiation(budget, module, len(code), proto)

    # per-instruction tick price comes from the UPGRADABLE cost table
    # (WasmInsnExec const term), not the compile-time default
    cpu_per_insn = budget.wasm_insn_cost()

    def charge(n_insns: int):
        budget.charge(n_insns * cpu_per_insn)

    def mem_charge(n_bytes: int):
        budget.charge(0, n_bytes)

    pooled = None
    try:
        try:
            fn = fn_name.decode("utf-8")
        except UnicodeDecodeError:
            raise HostError(HostError.TRAPPED, "bad function name")
        from stellar_tpu_torch.soroban.legacy_abi import (
            from_rawval, is_legacy_module, make_legacy_imports, to_rawval,
        )
        if is_legacy_module(module):
            # pre-1.0 fixture dialect: 4-bit-tag RawVals + the tiny
            # early import surface; same engines, different codec
            env = WasmContractEnv(host, contract_addr, invocation,
                                  depth)
            imports = make_legacy_imports(env)
            vals = [to_rawval(a) for a in args]
            decode = from_rawval
        else:
            env, imports = _acquire_wasm_env(host, contract_addr,
                                             invocation, depth)
            pooled = (env, imports)
            vals = [env.cv.from_scval(a) for a in args]
            decode = env.cv.to_scval
        if USE_NATIVE_WASM:
            from stellar_tpu_torch.soroban import native_wasm
            if native_wasm.available():
                rv = native_wasm.run_export(
                    module, imports, budget, cpu_per_insn, fn,
                    vals, cache_imports=pooled is not None)
                return decode(rv) if rv is not None \
                    else SCVal.make(T.SCV_VOID)
        inst = WasmInstance(module, imports, charge, mem_charge)
        if not inst.exports_function(fn):
            raise HostError(HostError.TRAPPED,
                            f"no exported function {fn!r}")
        rv = inst.invoke(fn, vals)
        return decode(rv) if rv is not None \
            else SCVal.make(T.SCV_VOID)
    except WasmError as e:
        raise HostError(HostError.TRAPPED, f"invalid wasm: {e}")
    except Trap as e:
        raise HostError(HostError.TRAPPED, str(e),
                        error_sc=getattr(e, "error_sc", None))
    except HostError:
        raise
    except Exception as e:
        # defense in depth: the VM's inputs are attacker-shaped; any
        # unexpected failure must trap THIS transaction, never escape
        # and abort the ledger close (the reference host catches Rust
        # panics at the FFI boundary the same way)
        raise HostError(HostError.TRAPPED,
                        f"host internal error: {type(e).__name__}: {e}")
    finally:
        if pooled is not None:
            _release_wasm_env(*pooled)


def _upload(host: "_Host", code: bytes, read_write: set):
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.xdr.contract import ContractCodeEntry
    if len(code) > host.config.max_contract_size:
        raise HostError(HostError.BUDGET, "contract too large")
    if code[:4] == b"\x00asm":
        # full decode + validation at upload, exactly like the
        # reference host rejecting malformed modules before they can
        # be created (charging by code size)
        host.budget.charge(CPU_PER_BYTE * 40 * len(code), len(code))
        from stellar_tpu_torch.soroban.wasm import WasmError
        try:
            _parsed_module(code)
        except WasmError as e:
            raise HostError(HostError.TRAPPED, f"invalid wasm: {e}")
    else:
        _parse_program(code)  # legacy SCVal program must at least parse
    h = sha256(code)
    lk = contract_code_key(h)
    kb = key_bytes(lk)
    entry = ContractCodeEntry(
        ext=ContractCodeEntry._types[0].make(0), hash=h, code=code)
    host.storage.put(kb, _wrap_entry(LedgerEntryType.CONTRACT_CODE,
                                     entry, host.ledger_seq),
                     host.ledger_seq + host.config.min_persistent_ttl - 1)
    return scbytes(h)


def _create(host: "_Host", args, network_id: bytes):
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    contract_id = derive_contract_id(network_id, args.contractIDPreimage)
    addr = scaddress_contract(contract_id)
    storage = None
    if args.executable.arm == \
            ContractExecutableType.CONTRACT_EXECUTABLE_WASM:
        if args.contractIDPreimage.arm == \
                ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET:
            raise HostError(HostError.TRAPPED,
                            "asset preimage needs the asset executable")
        code_kb = key_bytes(contract_code_key(args.executable.value))
        if host.storage.get(code_kb) is None:
            raise HostError(HostError.TRAPPED,
                            "executable code not uploaded")
    else:
        # Stellar Asset Contract: deployable only from an asset
        # preimage; the wrapped asset rides in instance storage
        if args.contractIDPreimage.arm != \
                ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET:
            raise HostError(HostError.TRAPPED,
                            "asset executable needs an asset preimage")
        from stellar_tpu_torch.soroban.asset_contract import (
            asset_instance_storage,
        )
        storage = asset_instance_storage(args.contractIDPreimage.value)
    key = SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE)
    lk = contract_data_key(addr, key, ContractDataDurability.PERSISTENT)
    kb = key_bytes(lk)
    if host.storage.get(kb) is not None:
        raise HostError(HostError.TRAPPED, "contract already exists")
    inst = ContractDataEntry(
        ext=ExtensionPoint.make(0), contract=addr, key=key,
        durability=ContractDataDurability.PERSISTENT,
        val=SCVal.make(T.SCV_CONTRACT_INSTANCE, SCContractInstance(
            executable=args.executable, storage=storage)))
    host.storage.put(kb, _wrap_entry(LedgerEntryType.CONTRACT_DATA,
                                     inst, host.ledger_seq),
                     host.ledger_seq + host.config.min_persistent_ttl - 1)
    return SCVal.make(T.SCV_ADDRESS, addr)


def _run_contract(host: "_Host", args, depth: int = 0):
    host.frame_addrs.append(_address_bytes(args.contractAddress))
    try:
        return _run_contract_inner(host, args, depth)
    finally:
        host.frame_addrs.pop()
        host.prune_contract_auths()


def _run_contract_inner(host: "_Host", args, depth: int = 0):
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.xdr.contract import (
        SorobanAuthorizedFunction, SorobanAuthorizedFunctionType,
    )
    addr = args.contractAddress
    key = SCVal.make(T.SCV_LEDGER_KEY_CONTRACT_INSTANCE)
    lk = contract_data_key(addr, key, ContractDataDurability.PERSISTENT)
    inst_entry = host.storage.get(key_bytes(lk))
    if inst_entry is None:
        raise HostError(HostError.TRAPPED, "contract does not exist")
    inst = inst_entry.data.value.val.value  # SCContractInstance
    if inst.executable.arm == \
            ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET:
        from stellar_tpu_torch.soroban.asset_contract import asset_contract_call
        from stellar_tpu_torch.xdr.contract import (
            SorobanAuthorizedFunction, SorobanAuthorizedFunctionType,
        )
        invocation = SorobanAuthorizedFunction.make(
            SorobanAuthorizedFunctionType
            .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN, args)
        return asset_contract_call(host, addr, inst, args.functionName,
                                   list(args.args), invocation,
                                   depth=depth)
    code_entry = host.storage.get(
        key_bytes(contract_code_key(inst.executable.value)))
    if code_entry is None:
        raise HostError(HostError.TRAPPED, "missing contract code")
    code = code_entry.data.value.code
    invocation = SorobanAuthorizedFunction.make(
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN, args)
    if code[:4] == b"\x00asm":
        return _run_wasm_contract(host, addr, code, args.functionName,
                                  list(args.args), invocation, depth)
    prog = _parse_program(code)
    interp = _Interp(host, addr, prog, invocation=invocation,
                     depth=depth)
    return interp.run(args.functionName, list(args.args))


def _invoke(host: "_Host", args):
    return _run_contract(host, args, depth=0)
