"""Load generation + apply-load benchmarking (reference
``src/simulation/LoadGenerator.h:30-49`` modes and ``ApplyLoad.h:14-55``
— synthetic tx queues driven through the real close pipeline, measuring
the ``ledger.ledger.close`` timer)."""

from __future__ import annotations

import time
from typing import List, Optional

from stellar_tpu_torch.crypto.keys import SecretKey
from stellar_tpu_torch.herder.tx_set import make_tx_set_from_transactions
from stellar_tpu_torch.ledger.ledger_manager import LedgerCloseData, LedgerManager
from stellar_tpu_torch.utils.metrics import registry

__all__ = ["LoadGenerator", "apply_load"]

XLM = 10_000_000


def weighted_cfg_sample(cfg, prefix: str, default: int,
                        ordinal: int) -> int:
    """Weighted sample from {prefix}_FOR_TESTING values with
    {prefix}_DISTRIBUTION_FOR_TESTING weights (reference LOADGEN_* /
    APPLY_LOAD_* shaping families). Deterministic in ``ordinal`` so
    shapes reproduce run to run."""
    values = getattr(cfg, f"{prefix}_FOR_TESTING", None) \
        if cfg is not None else None
    if not values:
        return default
    weights = getattr(
        cfg, f"{prefix}_DISTRIBUTION_FOR_TESTING", None) or \
        [1] * len(values)
    if len(weights) != len(values):
        raise ValueError(f"{prefix} value/weight lengths differ")
    total = sum(weights)
    if total <= 0:
        raise ValueError(f"{prefix} weights sum to zero")
    import zlib
    # Knuth hash, salted per family so e.g. the RO and RW draws of the
    # same tx decorrelate (and no mod-parity artifact for small totals)
    pick = ((ordinal * 2654435761) ^ zlib.crc32(prefix.encode())) % total
    acc = 0
    for v, w in zip(values, weights):
        acc += w
        if pick < acc:
            return v
    return values[-1]


class LoadGenerator:
    """Paced synthetic traffic through a real herder (reference
    ``LoadGenerator.h:30-49`` modes: CREATE, PAY, PRETEND,
    SOROBAN_UPLOAD, SOROBAN_INVOKE (+setup), MIXED_CLASSIC_SOROBAN)."""

    MODES = ("pay", "create", "pretend", "soroban_upload",
             "soroban_invoke", "mixed_classic_soroban")

    def __init__(self, app, n_accounts: int = 16):
        self.app = app
        self.accounts: List[SecretKey] = [
            SecretKey.from_seed_str(f"loadgen-{i}")
            for i in range(n_accounts)]
        self.seqs = {}
        self.submitted = 0
        self.rejected = 0
        self.created = 0
        # soroban_invoke state: one shared counter contract
        self.contract_id: Optional[bytes] = None

    def account_keys(self):
        return self.accounts

    def _cfg_sample(self, base: str, default: int) -> int:
        """Weighted sample from the LOADGEN_{base}_FOR_TESTING value /
        _DISTRIBUTION_FOR_TESTING weight lists (reference LOADGEN_*
        shaping family). Deterministic: the nth submitted tx picks by
        cumulative weight, so load shapes reproduce run to run."""
        return weighted_cfg_sample(getattr(self.app, "config", None),
                                   f"LOADGEN_{base}", default,
                                   self.submitted)

    def _next_seq(self, src: SecretKey) -> Optional[int]:
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.tx.op_frame import account_key
        from stellar_tpu_torch.xdr.types import account_id
        raw = src.public_key.raw
        if raw not in self.seqs:
            e = self.app.herder.lm.root.store.get(
                key_bytes(account_key(account_id(raw))))
            if e is None:
                return None
            self.seqs[raw] = e.data.value.seqNum
        self.seqs[raw] += 1
        return self.seqs[raw]

    def _submit(self, tx, src: SecretKey) -> bool:
        """Submit through the herder; on queue rejection, unwind the
        cached seq so later txs from this account stay gap-free."""
        from stellar_tpu_torch.herder.transaction_queue import AddResult
        res = self.app.herder.recv_transaction(tx)
        accepted = res.code in (AddResult.ADD_STATUS_PENDING,
                                AddResult.ADD_STATUS_DUPLICATE)
        if accepted:
            self.submitted += 1
        else:
            self.seqs[src.public_key.raw] -= 1
            self.rejected += 1
        return accepted

    def generate_load(self, n_txs: int, mode: str = "pay"):
        """Submit n txs of the given mode round-robin across accounts."""
        if mode not in self.MODES:
            raise ValueError(f"unknown load mode {mode!r}; "
                             f"one of {self.MODES}")
        if mode in ("soroban_invoke", "mixed_classic_soroban") and \
                self.contract_id is None:
            raise RuntimeError(
                "run setup_soroban() (and crank it through a close) "
                "before soroban_invoke load")
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.tx.op_frame import account_key
        from stellar_tpu_torch.tx.tx_test_utils import (
            create_account_op, make_tx, payment_op,
        )
        from stellar_tpu_torch.xdr.types import account_id
        herder = self.app.herder
        for i in range(n_txs):
            src = self.accounts[i % len(self.accounts)]
            seq = self._next_seq(src)
            if seq is None:
                continue
            if mode == "pay" or (mode == "mixed_classic_soroban"
                                 and i % 2 == 0):
                # LOADGEN_OP_COUNT shaping: n payments per tx
                n_ops = max(1, self._cfg_sample("OP_COUNT", 1))
                dst = self.accounts[(i + 1) % len(self.accounts)]
                tx = make_tx(src, seq,
                             [payment_op(dst, XLM)] * n_ops,
                             network_id=herder.network_id)
            elif mode == "create":
                # skip over accounts that already exist (repeat runs /
                # restarted generators must still create fresh ones)
                while True:
                    new = SecretKey.from_seed_str(
                        f"loadgen-created-{self.created}")
                    self.created += 1
                    if herder.lm.root.store.get(key_bytes(account_key(
                            account_id(new.public_key.raw)))) is None:
                        break
                tx = make_tx(src, seq, [create_account_op(new, 50 * XLM)],
                             network_id=herder.network_id)
            elif mode == "pretend":
                # realistic-looking no-op traffic (reference PRETEND:
                # SetOptions that changes nothing observable)
                from stellar_tpu_torch.xdr.tx import (
                    Operation, OperationBody, OperationType, SetOptionsOp,
                )
                op = Operation(
                    sourceAccount=None,
                    body=OperationBody.make(
                        OperationType.SET_OPTIONS,
                        SetOptionsOp(inflationDest=None, clearFlags=None,
                                     setFlags=None, masterWeight=None,
                                     lowThreshold=None, medThreshold=None,
                                     highThreshold=None, homeDomain=None,
                                     signer=None)))
                # LOADGEN_OP_COUNT / TX_SIZE_BYTES shaping: op count,
                # plus a text memo padding toward the size target
                n_ops = max(1, self._cfg_sample("OP_COUNT", 1))
                memo = None
                pad = self._cfg_sample("TX_SIZE_BYTES", 0)
                if pad:
                    from stellar_tpu_torch.xdr.tx import Memo, MemoType
                    memo = Memo.make(MemoType.MEMO_TEXT,
                                     b"x" * min(28, pad))
                tx = make_tx(src, seq, [op] * n_ops, memo=memo,
                             network_id=herder.network_id)
            elif mode == "soroban_upload":
                tx = self._upload_tx(src, seq, unique=self.submitted)
            else:  # soroban_invoke / mixed odd slots
                tx = self._invoke_tx(src, seq)
            self._submit(tx, src)

    # ---------------- soroban builders ----------------

    def _counter_code(self, unique: int = 0, pad_to: int = 0) -> bytes:
        """``pad_to`` pads the body toward the LOADGEN_WASM_BYTES
        target with an unexecuted function holding a bytes blob."""
        from stellar_tpu_torch.soroban.host import (
            assemble_program, ins, scbytes, sym, u32,
        )
        if pad_to:
            base = len(self._counter_code(unique))
            if pad_to > base + 64:
                return assemble_program({
                    "zpad": [ins("push",
                                 scbytes(b"\x00" * (pad_to - base - 64)))],
                    **self._counter_program(unique),
                })
        return assemble_program(self._counter_program(unique))

    def _counter_program(self, unique: int = 0) -> dict:
        from stellar_tpu_torch.soroban.host import ins, sym, u32
        return {
            "incr": [
                ins("push", u32(unique)), ins("drop"),
                ins("push", sym("count")), ins("has", sym("persistent")),
                ins("jz", u32(3)),
                ins("push", sym("count")), ins("get", sym("persistent")),
                ins("jmp", u32(1)),
                ins("push", u32(0)),
                ins("push", u32(1)), ins("add"),
                ins("dup"),
                ins("push", sym("count")), ins("swap"),
                ins("put", sym("persistent")),
                ins("ret"),
            ],
        }

    def _upload_tx(self, src, seq, unique: int = 0):
        """SOROBAN_UPLOAD: each tx uploads a distinct contract body
        (reference uploads randomized wasm)."""
        from stellar_tpu_torch.crypto.sha import sha256
        from stellar_tpu_torch.soroban.host import contract_code_key
        from stellar_tpu_torch.tx.tx_test_utils import make_tx
        from stellar_tpu_torch.xdr.contract import (
            HostFunction, HostFunctionType,
        )
        code = self._counter_code(
            unique, pad_to=self._cfg_sample("WASM_BYTES", 0))
        fn = HostFunction.make(
            HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM,
            code)
        sd = _soroban_data(
            read_write=[contract_code_key(sha256(code))])
        return make_tx(src, seq, [_soroban_op(fn)], fee=6_000_000,
                       soroban_data=sd,
                       network_id=self.app.herder.network_id)

    def setup_soroban(self):
        """SOROBAN_INVOKE_SETUP (reference mode): submit the upload +
        create txs for the shared counter contract. Crank the network
        through at least two closes afterwards, then invoke load can
        run."""
        owner = self.accounts[0]
        seq = self._next_seq(owner)
        if seq is None:
            raise RuntimeError("loadgen account 0 does not exist yet")
        up, create, self.contract_id, self._code_hash, _ = \
            _deploy_frames(owner, seq, self._next_seq(owner),
                           self._counter_code(),
                           self.app.herder.network_id, salt=b"\x5a" * 32)
        self._submit(up, owner)
        self._submit(create, owner)

    def _invoke_tx(self, src, seq):
        from stellar_tpu_torch.soroban.host import (
            contract_code_key, contract_data_key, scaddress_contract,
            sym,
        )
        from stellar_tpu_torch.tx.tx_test_utils import make_tx
        from stellar_tpu_torch.xdr.contract import (
            ContractDataDurability, HostFunction, HostFunctionType,
            InvokeContractArgs, SCVal, SCValType,
        )
        addr = scaddress_contract(self.contract_id)
        fn = HostFunction.make(
            HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
            InvokeContractArgs(contractAddress=addr,
                               functionName=b"incr", args=[]))
        inst_key = contract_data_key(
            addr, SCVal.make(SCValType.SCV_LEDGER_KEY_CONTRACT_INSTANCE),
            ContractDataDurability.PERSISTENT)
        counter_key = contract_data_key(
            addr, sym("count"), ContractDataDurability.PERSISTENT)
        # LOADGEN shaping: declared instructions / io bytes / extra
        # data-entry footprint per the configured distributions
        insns = self._cfg_sample("INSTRUCTIONS", 2_000_000)
        io_kb = self._cfg_sample("IO_KILOBYTES", 3)
        extra_rw = [
            contract_data_key(addr, sym(f"pad{j}"),
                              ContractDataDurability.PERSISTENT)
            for j in range(max(
                0, self._cfg_sample("NUM_DATA_ENTRIES", 1) - 1))]
        sd = _soroban_data(
            read_only=[inst_key, contract_code_key(self._code_hash)],
            read_write=[counter_key] + extra_rw,
            instructions=insns,
            read_bytes=max(1, io_kb) * 1024,
            write_bytes=max(1, io_kb) * 1024)
        return make_tx(src, seq, [_soroban_op(fn)], fee=6_000_000,
                       soroban_data=sd,
                       network_id=self.app.herder.network_id)


def _deploy_frames(owner, seq_upload: int, seq_create: int, code: bytes,
                   network_id: bytes, salt: bytes):
    """(upload_frame, create_frame, contract_id, code_hash, inst_key):
    the contract-deployment pair shared by the paced LoadGenerator and
    the apply-load soroban scenario."""
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.soroban.host import (
        contract_code_key, contract_data_key, derive_contract_id,
        scaddress_account, scaddress_contract,
    )
    from stellar_tpu_torch.tx.tx_test_utils import make_tx
    from stellar_tpu_torch.xdr.contract import (
        ContractDataDurability, ContractExecutable,
        ContractExecutableType, ContractIDPreimage,
        ContractIDPreimageFromAddress, ContractIDPreimageType,
        CreateContractArgs, HostFunction, HostFunctionType, SCVal,
        SCValType,
    )
    from stellar_tpu_torch.xdr.types import account_id
    code_hash = sha256(code)
    upload = make_tx(
        owner, seq_upload,
        [_soroban_op(HostFunction.make(
            HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM,
            code))],
        fee=6_000_000,
        soroban_data=_soroban_data(
            read_write=[contract_code_key(code_hash)]),
        network_id=network_id)
    preimage = ContractIDPreimage.make(
        ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS,
        ContractIDPreimageFromAddress(
            address=scaddress_account(account_id(owner.public_key.raw)),
            salt=salt))
    contract_id = derive_contract_id(network_id, preimage)
    addr = scaddress_contract(contract_id)
    inst_key = contract_data_key(
        addr, SCVal.make(SCValType.SCV_LEDGER_KEY_CONTRACT_INSTANCE),
        ContractDataDurability.PERSISTENT)
    create = make_tx(
        owner, seq_create,
        [_soroban_op(HostFunction.make(
            HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
            CreateContractArgs(
                contractIDPreimage=preimage,
                executable=ContractExecutable.make(
                    ContractExecutableType.CONTRACT_EXECUTABLE_WASM,
                    code_hash))))],
        fee=6_000_000,
        soroban_data=_soroban_data(
            read_only=[contract_code_key(code_hash)],
            read_write=[inst_key]),
        network_id=network_id)
    return upload, create, contract_id, code_hash, inst_key


def _soroban_op(host_fn, auth=()):
    from stellar_tpu_torch.xdr.tx import (
        InvokeHostFunctionOp, Operation, OperationBody, OperationType,
    )
    return Operation(
        sourceAccount=None,
        body=OperationBody.make(
            OperationType.INVOKE_HOST_FUNCTION,
            InvokeHostFunctionOp(hostFunction=host_fn, auth=list(auth))))


def _soroban_data(read_only=(), read_write=(), instructions=2_000_000,
                  read_bytes=3_000, write_bytes=3_000,
                  resource_fee=5_000_000):
    from stellar_tpu_torch.xdr.tx import (
        LedgerFootprint, SorobanResources, SorobanTransactionData,
    )
    from stellar_tpu_torch.xdr.types import ExtensionPoint
    return SorobanTransactionData(
        ext=ExtensionPoint.make(0),
        resources=SorobanResources(
            footprint=LedgerFootprint(readOnly=list(read_only),
                                      readWrite=list(read_write)),
            instructions=instructions, readBytes=read_bytes,
            writeBytes=write_bytes),
        resourceFee=resource_fee)


def apply_load(n_ledgers: int = 10, txs_per_ledger: int = 100,
               n_accounts: int = 64) -> dict:
    """Standalone close-ledger benchmark (reference ``apply-load``):
    build txsets from a synthetic queue and drive closeLedger, reporting
    the close-timer distribution."""
    from stellar_tpu_torch.tx.tx_test_utils import (
        TEST_NETWORK_ID, make_tx, payment_op, seed_root_with_accounts,
    )
    keys = [SecretKey.from_seed_str(f"applyload-{i}")
            for i in range(n_accounts)]
    root = seed_root_with_accounts([(k, 10**13) for k in keys])
    lm = LedgerManager(TEST_NETWORK_ID, root)
    lm.last_closed_header.maxTxSetSize = max(1000, txs_per_ledger * 2)
    from stellar_tpu_torch.utils.metrics import Timer
    # per-run timer: the process-wide registry timer accumulates
    # across scenarios, which would contaminate repeat-run stats
    close_timer = Timer()
    seqs = {k.public_key.raw: (1 << 32) for k in keys}
    total_applied = 0
    per_close_ms = []  # (ledger_seq, ms) for spill-boundary analysis
    import time as _time
    for ledger_i in range(n_ledgers):
        frames = []
        for t in range(txs_per_ledger):
            src = keys[t % len(keys)]
            dst = keys[(t + 1) % len(keys)]
            seqs[src.public_key.raw] += 1
            frames.append(make_tx(
                src, seqs[src.public_key.raw], [payment_op(dst, XLM)]))
        txset, excluded = make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash)
        t0 = _time.perf_counter()
        with close_timer.time():
            res = lm.close_ledger(LedgerCloseData(
                lm.ledger_seq + 1, txset,
                lm.last_closed_header.scpValue.closeTime + 5))
        per_close_ms.append((lm.ledger_seq,
                             (_time.perf_counter() - t0) * 1000.0))
        if res.failed_count:
            raise RuntimeError(f"apply-load tx failures: "
                               f"{res.failed_count}")
        total_applied += res.applied_count
    stats = close_timer.to_dict()
    out = {
        "ledgers": n_ledgers,
        "txs_per_ledger": txs_per_ledger,
        "total_applied": total_applied,
        "close_min_ms": stats["min_ms"],
        "close_mean_ms": stats["mean_ms"],
        "close_max_ms": stats["max_ms"],
        "close_stddev_ms": stats["stddev_ms"],
        "tx_apply_per_sec": round(
            total_applied / (stats["mean_ms"] * n_ledgers / 1000.0), 1)
        if stats["mean_ms"] else 0.0,
    }
    out.update(_spill_boundary_stats(per_close_ms))
    return out


def _spill_boundary_stats(per_close_ms) -> dict:
    """Worst-case close latency across deep-spill boundaries (ledgers
    on a >=64 spill cadence, where the reference's FutureBucket keeps
    merge latency off the close path): p50/p99
    over all closes plus the worst deep-spill close, as a ratio to the
    median so regressions to eager-merge behavior are visible."""
    import numpy as _np
    if not per_close_ms:
        return {}
    times = _np.array([ms for _seq, ms in per_close_ms])
    p50 = float(_np.percentile(times, 50))
    p99 = float(_np.percentile(times, 99))
    spill_times = [ms for seq, ms in per_close_ms if seq % 64 == 0]
    out = {"close_p50_ms": round(p50, 3), "close_p99_ms": round(p99, 3)}
    if spill_times:
        worst = max(spill_times)
        out["deep_spill_worst_ms"] = round(worst, 3)
        out["deep_spill_over_p50"] = round(worst / p50, 2) if p50 else 0.0
    return out


def soroban_compute_load(n_ledgers: int = 3, txs_per_ledger: int = 100,
                         use_wasm: bool = False,
                         n_iter: int = 600) -> dict:
    """Compute-bound soroban row: each invoke runs an ``n_iter``-step
    accumulation loop with NO host calls inside — the workload where
    engine per-instruction cost dominates (the counter scenario is
    host-call-bound, where both engines converge on shared host work).
    Equivalent semantics in both engines: the wasm ``sum`` contract
    (raw i64 loop) vs an SCVal-program loop."""
    from stellar_tpu_torch.soroban.host import (
        contract_code_key, scaddress_contract, u32,
    )
    from stellar_tpu_torch.tx.tx_test_utils import (
        TEST_NETWORK_ID, make_tx, seed_root_with_accounts,
    )
    from stellar_tpu_torch.xdr.contract import (
        HostFunction, HostFunctionType, InvokeContractArgs,
    )
    import dataclasses
    n_accounts = 50
    srcs = [SecretKey.from_seed_str(f"sc-src-{i}")
            for i in range(n_accounts)]
    root = seed_root_with_accounts([(k, 10**13) for k in srcs])
    lm = LedgerManager(TEST_NETWORK_ID, root)
    lm.last_closed_header.maxTxSetSize = max(2000, txs_per_ledger * 2)
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    lm.last_closed_header.ledgerVersion = CURRENT_LEDGER_PROTOCOL_VERSION
    lm.soroban_config = dataclasses.replace(
        lm.soroban_config,
        ledger_max_tx_count=max(1000, txs_per_ledger),
        ledger_max_instructions=10**10, tx_max_instructions=10**7)
    lm.root.soroban_config = lm.soroban_config

    if use_wasm:
        from stellar_tpu_torch.soroban.example_contracts import sum_wasm
        code = sum_wasm()
    else:
        from stellar_tpu_torch.soroban.example_contracts import (
            sum_scval_program,
        )
        code = sum_scval_program()
    owner = srcs[0]
    seqs = {k.public_key.raw: (1 << 32) for k in srcs}
    seqs[owner.public_key.raw] += 2
    up, create, contract_id, code_hash, inst_key = _deploy_frames(
        owner, seqs[owner.public_key.raw] - 1,
        seqs[owner.public_key.raw], code, TEST_NETWORK_ID,
        salt=b"\x67" * 32)
    addr = scaddress_contract(contract_id)
    for setup in ([up], [create]):
        txset, _ = make_tx_set_from_transactions(
            setup, lm.last_closed_header, lm.last_closed_hash,
            soroban_config=lm.soroban_config)
        res = lm.close_ledger(LedgerCloseData(
            lm.ledger_seq + 1, txset,
            lm.last_closed_header.scpValue.closeTime + 5))
        if res.failed_count:
            raise RuntimeError("compute load setup failed")

    from stellar_tpu_torch.utils.metrics import Timer
    close_timer = Timer()
    total = 0
    for _ in range(n_ledgers):
        frames = []
        for t in range(txs_per_ledger):
            src = srcs[t % n_accounts]
            seqs[src.public_key.raw] += 1
            frames.append(make_tx(
                src, seqs[src.public_key.raw],
                [_soroban_op(HostFunction.make(
                    HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                    InvokeContractArgs(
                        contractAddress=addr, functionName=b"sum",
                        args=[u32(n_iter)])))],
                fee=8_000_000,
                soroban_data=_soroban_data(
                    read_only=[inst_key, contract_code_key(code_hash)],
                    instructions=8_000_000)))
        txset, excluded = make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash,
            soroban_config=lm.soroban_config)
        if excluded:
            raise RuntimeError(f"{len(excluded)} compute txs excluded")
        with close_timer.time():
            res = lm.close_ledger(LedgerCloseData(
                lm.ledger_seq + 1, txset,
                lm.last_closed_header.scpValue.closeTime + 5))
        if res.failed_count:
            raise RuntimeError(
                f"compute load failures: {res.failed_count}")
        total += res.applied_count
    stats = close_timer.to_dict()
    from stellar_tpu_torch.soroban import native_wasm
    engine = ("wasm-native" if use_wasm and native_wasm.available()
              else "wasm-py" if use_wasm else "scval")
    return {
        "scenario": "soroban_compute",
        "engine": engine,
        "ledgers": n_ledgers,
        "txs_per_ledger": txs_per_ledger,
        "loop_iterations": n_iter,
        "total_applied": total,
        "close_mean_ms": stats["mean_ms"],
        "close_max_ms": stats["max_ms"],
        "txs_per_sec": round(
            total / (stats["mean_ms"] * n_ledgers / 1000.0), 1)
        if stats["mean_ms"] else 0.0,
    }


def multisig_apply_load(n_ledgers: int = 5, txs_per_ledger: int = 1000,
                        extra_signers: int = 1) -> dict:
    """BASELINE config #2: 1,000-tx multi-signer payment sets — every tx
    carries 1 + extra_signers ed25519 signatures, all checked at apply
    (the ~2k-sig TxSet shape the north-star targets)."""
    from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
    from stellar_tpu_torch.tx.op_frame import account_key
    from stellar_tpu_torch.tx.tx_test_utils import (
        TEST_NETWORK_ID, make_tx, payment_op, seed_root_with_accounts,
    )
    from stellar_tpu_torch.xdr.types import (
        Signer, SignerKey, SignerKeyType, account_id,
    )
    n_accounts = 64
    keys = [SecretKey.from_seed_str(f"ms-{i}") for i in range(n_accounts)]
    cosigners = [SecretKey.from_seed_str(f"ms-co-{i}-{j}")
                 for i in range(n_accounts) for j in range(extra_signers)]
    root = seed_root_with_accounts([(k, 10**13) for k in keys])
    lm = LedgerManager(TEST_NETWORK_ID, root)
    lm.last_closed_header.maxTxSetSize = max(2000, txs_per_ledger * 2)
    # register each account's cosigners (reference SetOptions signers)
    with LedgerTxn(lm.root) as ltx:
        for i, k in enumerate(keys):
            h = ltx.load(account_key(account_id(k.public_key.raw)))
            acct = h.entry.data.value
            for j in range(extra_signers):
                co = cosigners[i * extra_signers + j]
                acct.signers.append(Signer(
                    key=SignerKey.make(
                        SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                        co.public_key.raw),
                    weight=1))
            acct.numSubEntries += extra_signers
            # require master + every cosigner (medium threshold =
            # total weight), so each signature is consumed and verified
            t = 1 + extra_signers
            acct.thresholds = bytes([1, t, t, t])
            h.deactivate()
        ltx.commit()
    from stellar_tpu_torch.utils.metrics import Timer
    # per-run timer: the process-wide registry timer accumulates
    # across scenarios, which would contaminate repeat-run stats
    close_timer = Timer()
    seqs = {k.public_key.raw: (1 << 32) for k in keys}
    total = 0
    for _ in range(n_ledgers):
        frames = []
        for t in range(txs_per_ledger):
            src = keys[t % n_accounts]
            cos = [cosigners[(t % n_accounts) * extra_signers + j]
                   for j in range(extra_signers)]
            seqs[src.public_key.raw] += 1
            frames.append(make_tx(
                src, seqs[src.public_key.raw],
                [payment_op(keys[(t + 1) % n_accounts], XLM)],
                extra_signers=cos))
        txset, _ = make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash)
        with close_timer.time():
            res = lm.close_ledger(LedgerCloseData(
                lm.ledger_seq + 1, txset,
                lm.last_closed_header.scpValue.closeTime + 5))
        if res.failed_count:
            raise RuntimeError(f"multisig load failures: "
                               f"{res.failed_count}")
        total += res.applied_count
    stats = close_timer.to_dict()
    sigs_per_tx = 1 + extra_signers
    return {
        "scenario": "multisig",
        "ledgers": n_ledgers,
        "txs_per_ledger": txs_per_ledger,
        "signatures_per_ledger": txs_per_ledger * sigs_per_tx,
        "total_applied": total,
        "close_mean_ms": stats["mean_ms"],
        "close_max_ms": stats["max_ms"],
        "sigs_per_sec": round(
            total * sigs_per_tx / (stats["mean_ms"] * n_ledgers / 1000.0),
            1) if stats["mean_ms"] else 0.0,
    }


def _prefill_bucket_list(lm, config) -> int:
    """Synthetic bucket-list prefill (reference APPLY_LOAD_BL_*,
    ApplyLoad.cpp:316-355): every WRITE_FREQUENCYth of
    SIMULATED_LEDGERS addBatch calls writes BATCH_SIZE contract-data +
    TTL entry pairs (LAST_BATCH_SIZE for each of the final
    LAST_BATCH_LEDGERS), building a deep, realistically-leveled list
    before the benchmark. Returns the number of entries written."""
    sim = getattr(config, "APPLY_LOAD_BL_SIMULATED_LEDGERS", 0) \
        if config is not None else 0
    if not sim or lm.bucket_list is None:
        return 0
    from stellar_tpu_torch.ledger.ledger_txn import entry_to_key, key_bytes
    from stellar_tpu_torch.soroban.host import (
        _wrap_entry, scaddress_contract, ttl_key_for,
    )
    from stellar_tpu_torch.xdr.contract import (
        ContractDataDurability, ContractDataEntry, SCVal, SCValType,
    )
    from stellar_tpu_torch.xdr.types import (
        ExtensionPoint, LedgerEntryType, TTLEntry,
    )
    freq = max(1, config.APPLY_LOAD_BL_WRITE_FREQUENCY)
    batch = config.APPLY_LOAD_BL_BATCH_SIZE
    last_n = config.APPLY_LOAD_BL_LAST_BATCH_LEDGERS
    last_sz = config.APPLY_LOAD_BL_LAST_BATCH_SIZE
    addr = scaddress_contract(b"\x42" * 32)
    T = SCValType
    seq = lm.ledger_seq
    version = lm.last_closed_header.ledgerVersion
    current_key = 0
    for i in range(sim):
        seq += 1
        init = []
        is_last = i >= sim - last_n
        if i % freq == 0 or is_last:
            for _ in range(last_sz if is_last else batch):
                key_sc = SCVal.make(T.SCV_U64, current_key)
                current_key += 1
                de = ContractDataEntry(
                    ext=ExtensionPoint.make(0), contract=addr,
                    key=key_sc,
                    durability=ContractDataDurability.PERSISTENT,
                    val=SCVal.make(T.SCV_U64, 0))
                le = _wrap_entry(LedgerEntryType.CONTRACT_DATA, de, seq)
                ttl = _wrap_entry(
                    LedgerEntryType.TTL,
                    TTLEntry(keyHash=ttl_key_for(
                        entry_to_key(le)).value.keyHash,
                             liveUntilLedgerSeq=1_000_000_000), seq)
                init.append(le)
                init.append(ttl)
                # live state and the bucket list must agree: the next
                # close's header commits a bucketListHash that point
                # reads (and a bucket-restored node) must match
                lm.root.store.put(key_bytes(entry_to_key(le)), le)
                lm.root.store.put(key_bytes(entry_to_key(ttl)), ttl)
        lm.bucket_list.add_batch(seq, version, init, [], [])
    lm.last_closed_header.ledgerSeq = seq
    return current_key


def soroban_apply_load(n_ledgers: int = 3, txs_per_ledger: int = 500,
                       use_wasm: bool = False, config=None) -> dict:
    """BASELINE config #5: Soroban InvokeHostFunction txs/ledger, each a
    fee-bump outer envelope around an invoke with a signed ed25519 auth
    entry — 3 signatures per tx (outer, inner, auth) through the verify
    path, plus contract execution and footprint/fee accounting.
    ``use_wasm`` runs a genuinely compiled wasm counter (native C++
    engine when built) instead of the legacy SCVal program. ``config``
    shapes per-tx footprints via the APPLY_LOAD_NUM_RO/RW_ENTRIES
    value/weight lists (reference APPLY_LOAD_* family)."""
    import dataclasses
    from stellar_tpu_torch.crypto.sha import sha256
    from stellar_tpu_torch.ledger.ledger_txn import key_bytes
    from stellar_tpu_torch.soroban.host import (
        assemble_program, auth_payload_hash, contract_code_key,
        contract_data_key, ins, scaddress_account, scaddress_contract,
        sym, u32,
    )
    from stellar_tpu_torch.tx.transaction_frame import FeeBumpTransactionFrame
    from stellar_tpu_torch.tx.tx_test_utils import (
        TEST_NETWORK_ID, make_tx, seed_root_with_accounts,
    )
    from stellar_tpu_torch.xdr.contract import (
        ContractDataDurability, HostFunction, HostFunctionType,
        InvokeContractArgs, SCMapEntry, SCNonceKey, SCVal, SCValType,
        SorobanAddressCredentials, SorobanAuthorizationEntry,
        SorobanAuthorizedFunction, SorobanAuthorizedFunctionType,
        SorobanAuthorizedInvocation, SorobanCredentials,
        SorobanCredentialsType,
    )
    from stellar_tpu_torch.xdr.tx import (
        FeeBumpTransaction, FeeBumpTransactionEnvelope,
        TransactionEnvelope, TransactionV1Envelope, _FeeBumpInner,
        feebump_sig_payload, muxed_account,
    )
    from stellar_tpu_torch.xdr.types import EnvelopeType, account_id
    T = SCValType
    n_accounts = 50
    srcs = [SecretKey.from_seed_str(f"sb-src-{i}")
            for i in range(n_accounts)]
    payers = [SecretKey.from_seed_str(f"sb-pay-{i}")
              for i in range(n_accounts)]
    signer = SecretKey.from_seed_str("sb-auth-signer")
    root = seed_root_with_accounts(
        [(k, 10**13) for k in srcs + payers + [signer]])
    lm = LedgerManager(TEST_NETWORK_ID, root)
    lm.last_closed_header.maxTxSetSize = max(2000, txs_per_ledger * 2)
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    lm.last_closed_header.ledgerVersion = CURRENT_LEDGER_PROTOCOL_VERSION
    # per-run raised caps, as a config upgrade would set them; the
    # entry limits grow to cover the APPLY_LOAD footprint shaping and
    # never shrink below what the process defaults (possibly already
    # patched by the CLI's APPLY_LOAD_TX_MAX_* overrides) allow
    max_ro_shape = max([0] + list(getattr(
        config, "APPLY_LOAD_NUM_RO_ENTRIES_FOR_TESTING", []) or []))
    max_rw_shape = max([0] + list(getattr(
        config, "APPLY_LOAD_NUM_RW_ENTRIES_FOR_TESTING", []) or []))
    max_ev_shape = max([0] + list(getattr(
        config, "APPLY_LOAD_EVENT_COUNT_FOR_TESTING", []) or []))
    lm.soroban_config = dataclasses.replace(
        lm.soroban_config, ledger_max_tx_count=max(1000, txs_per_ledger),
        tx_max_read_ledger_entries=max(
            lm.soroban_config.tx_max_read_ledger_entries,
            10 + max_ro_shape + max_rw_shape),
        tx_max_write_ledger_entries=max(
            lm.soroban_config.tx_max_write_ledger_entries,
            8 + max_rw_shape),
        tx_max_contract_events_size_bytes=max(
            lm.soroban_config.tx_max_contract_events_size_bytes,
            (max_ev_shape + 2) * 128),
        tx_max_instructions=max(
            lm.soroban_config.tx_max_instructions,
            2_000_000 + 8_000 * max_ev_shape))
    lm.root.soroban_config = lm.soroban_config
    prefilled = _prefill_bucket_list(lm, config)

    if use_wasm:
        from stellar_tpu_torch.soroban.example_contracts import counter_wasm
        # the burst export is only compiled in when shaping asks for
        # it: the unshaped contract stays byte-identical (golden metas
        # pin its code hash)
        code = counter_wasm(with_burst=max_ev_shape > 0)
    else:
        # same semantic workload as the wasm counter (auth + has/get/
        # put + an ``incr`` event with the new count) so the two
        # benchmark rows compare engines, not contracts
        _incr_body = [
            ins("arg", u32(0)), ins("require_auth"),
            ins("push", sym("count")), ins("has", sym("persistent")),
            ins("jz", u32(3)),
            ins("push", sym("count")), ins("get", sym("persistent")),
            ins("jmp", u32(1)),
            ins("push", u32(0)),
            ins("push", u32(1)), ins("add"),
            ins("dup"),
            ins("push", sym("count")), ins("swap"),
            ins("put", sym("persistent")),
            ins("dup"),
            ins("push", sym("incr")), ins("swap"),
            ins("event"),
        ]
        fns = {"auth_incr": _incr_body + [ins("ret")]}
        if max_ev_shape > 0:
            # auth_incr + k extra events (APPLY_LOAD_EVENT_COUNT
            # shaping): loop on arg 1 emitting ("burst", k) events.
            # Only added when shaping is configured, so the UNSHAPED
            # benchmark contract stays byte-identical (golden metas
            # pin its code hash)
            fns["auth_incr_burst"] = _incr_body + [
                ins("arg", u32(1)),                  # [nv, k]
                ins("dup"),                          # loop top
                ins("jz", u32(7)),                   # k==0 -> drop
                ins("dup"),
                ins("push", sym("burst")),
                ins("swap"),
                ins("event"),                        # [nv, k]
                ins("push", u32(1)),
                ins("sub"),                          # [nv, k-1]
                ins("jmp", SCVal.make(T.SCV_I32, -9)),
                ins("drop"),
                ins("ret"),
            ]
        code = assemble_program(fns)
    code_hash = sha256(code)
    owner = srcs[0]
    seqs = {k.public_key.raw: (1 << 32) for k in srcs + payers}

    def _make_set(frames):
        txset, excluded = make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash,
            soroban_config=lm.soroban_config)
        if excluded:
            raise RuntimeError(f"{len(excluded)} txs excluded from set")
        return txset

    def _close_set(txset):
        return lm.close_ledger(LedgerCloseData(
            lm.ledger_seq + 1, txset,
            lm.last_closed_header.scpValue.closeTime + 5))

    def _close(frames):
        return _close_set(_make_set(frames))

    # setup ledger: upload + create (shared deployment builder)
    seqs[owner.public_key.raw] += 2
    up, create, contract_id, code_hash, inst_key = _deploy_frames(
        owner, seqs[owner.public_key.raw] - 1,
        seqs[owner.public_key.raw], code, TEST_NETWORK_ID,
        salt=b"\x66" * 32)
    addr = scaddress_contract(contract_id)
    res = _close([up])
    res2 = _close([create])
    if res.failed_count or res2.failed_count:
        raise RuntimeError("soroban load setup failed")

    addr_signer = scaddress_account(account_id(signer.public_key.raw))
    counter_key = contract_data_key(addr, sym("count"),
                                    ContractDataDurability.PERSISTENT)
    from stellar_tpu_torch.utils.metrics import Timer
    # per-run timer: the process-wide registry timer accumulates
    # across scenarios, which would contaminate repeat-run stats
    close_timer = Timer()
    total = 0
    nonce = 0
    shaped_entries = 0
    shaped_events = 0
    for _ in range(n_ledgers):
        frames = []
        for t in range(txs_per_ledger):
            src = srcs[t % n_accounts]
            payer = payers[t % n_accounts]
            nonce += 1
            # APPLY_LOAD_NUM_RO/RW_ENTRIES shaping: pad the declared
            # footprint with extra data keys (reference APPLY_LOAD_*
            # family — io-stress knobs for this very harness)
            n_ro = weighted_cfg_sample(config,
                                       "APPLY_LOAD_NUM_RO_ENTRIES",
                                       0, nonce)
            n_rw = weighted_cfg_sample(config,
                                       "APPLY_LOAD_NUM_RW_ENTRIES",
                                       0, nonce)
            extra_ro = [contract_data_key(
                addr, sym(f"ro{j}"), ContractDataDurability.TEMPORARY)
                for j in range(n_ro)]
            extra_rw = [contract_data_key(
                addr, sym(f"rw{nonce}x{j}"),
                ContractDataDurability.TEMPORARY)
                for j in range(n_rw)]
            shaped_entries += n_ro + n_rw
            # APPLY_LOAD_EVENT_COUNT shaping: k extra events per tx
            # via the burst variant (auth payload covers fn + args)
            n_ev = weighted_cfg_sample(config, "APPLY_LOAD_EVENT_COUNT",
                                       0, nonce)
            if n_ev > 0:
                fn_name = b"auth_incr_burst"
                fn_args = [SCVal.make(T.SCV_ADDRESS, addr_signer),
                           u32(n_ev)]
                shaped_events += n_ev
                # the scval interpreter charges ~5k budget cpu per
                # burst iteration; declare instructions to match so
                # the knob behaves identically on both engines
                extra_insns = 8_000 * n_ev
            else:
                fn_name = b"auth_incr"
                fn_args = [SCVal.make(T.SCV_ADDRESS, addr_signer)]
                extra_insns = 0
            invocation = SorobanAuthorizedInvocation(
                function=SorobanAuthorizedFunction.make(
                    SorobanAuthorizedFunctionType
                    .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
                    InvokeContractArgs(
                        contractAddress=addr, functionName=fn_name,
                        args=fn_args)),
                subInvocations=[])
            expiry = lm.ledger_seq + 1000
            payload = auth_payload_hash(TEST_NETWORK_ID, nonce, expiry,
                                        invocation)
            sig_val = SCVal.make(T.SCV_VEC, [SCVal.make(T.SCV_MAP, [
                SCMapEntry(key=sym("public_key"),
                           val=SCVal.make(T.SCV_BYTES,
                                          signer.public_key.raw)),
                SCMapEntry(key=sym("signature"),
                           val=SCVal.make(T.SCV_BYTES,
                                          signer.sign(payload))),
            ])])
            auth = SorobanAuthorizationEntry(
                credentials=SorobanCredentials.make(
                    SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS,
                    SorobanAddressCredentials(
                        address=addr_signer, nonce=nonce,
                        signatureExpirationLedger=expiry,
                        signature=sig_val)),
                rootInvocation=invocation)
            nonce_key = contract_data_key(
                addr_signer,
                SCVal.make(T.SCV_LEDGER_KEY_NONCE,
                           SCNonceKey(nonce=nonce)),
                ContractDataDurability.TEMPORARY)
            seqs[src.public_key.raw] += 1
            inner = make_tx(
                src, seqs[src.public_key.raw],
                [_soroban_op(HostFunction.make(
                    HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                    InvokeContractArgs(
                        contractAddress=addr, functionName=fn_name,
                        args=fn_args)),
                    [auth])],
                fee=5_000_200,  # covers the declared resource fee
                soroban_data=_soroban_data(
                    read_only=[inst_key, contract_code_key(code_hash)]
                    + extra_ro, read_write=[counter_key, nonce_key]
                    + extra_rw,
                    instructions=2_000_000 + extra_insns))
            # fee-bump outer envelope signed by the payer
            fb = FeeBumpTransaction(
                feeSource=muxed_account(payer.public_key.raw),
                fee=12_000_000,
                innerTx=_FeeBumpInner.make(
                    EnvelopeType.ENVELOPE_TYPE_TX,
                    TransactionV1Envelope(
                        tx=inner.tx, signatures=inner.signatures)),
                ext=FeeBumpTransaction._types[3].make(0))
            h = sha256(feebump_sig_payload(TEST_NETWORK_ID, fb))
            env = TransactionEnvelope.make(
                EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
                FeeBumpTransactionEnvelope(
                    tx=fb, signatures=[payer.sign_decorated(h)]))
            frames.append(FeeBumpTransactionFrame(TEST_NETWORK_ID, env))
        # time ONLY closeLedger (set assembly outside), so close stats
        # are comparable with the other apply-load scenarios
        txset = _make_set(frames)
        with close_timer.time():
            res = _close_set(txset)
        if res.failed_count:
            raise RuntimeError(
                f"soroban load: {res.failed_count} txs failed")
        total += res.applied_count
    stats = close_timer.to_dict()
    counter = lm.root.store.get(key_bytes(counter_key))
    if use_wasm:
        from stellar_tpu_torch.soroban import host as _host_mod
        from stellar_tpu_torch.soroban import native_wasm as _nw
        engine = "wasm-native" if (_host_mod.USE_NATIVE_WASM and
                                   _nw.available()) else "wasm-python"
    else:
        engine = "scval"
    return {
        "scenario": "soroban",
        "shaped_footprint_entries": shaped_entries,
        "shaped_extra_events": shaped_events,
        "bl_prefilled_entries": prefilled,
        "bl_deep_levels": sum(
            1 for lev in lm.bucket_list.levels
            if not (lev.curr.is_empty() and lev.snap.is_empty()))
        if lm.bucket_list is not None else 0,
        "engine": engine,
        "ledgers": n_ledgers,
        "txs_per_ledger": txs_per_ledger,
        "signatures_per_ledger": txs_per_ledger * 3,
        "total_applied": total,
        "counter_value": counter.data.value.val.value
        if counter is not None else None,
        "close_mean_ms": stats["mean_ms"],
        "close_max_ms": stats["max_ms"],
        "txs_per_sec": round(
            total / (stats["mean_ms"] * n_ledgers / 1000.0), 1)
        if stats["mean_ms"] else 0.0,
    }


def catchup_replay_bench(n_ledgers: int = 256,
                         txs_per_ledger: int = 20) -> dict:
    """BASELINE config #3 shape: publish a chain, then time a fresh
    node's COMPLETE replay (signature-bound without the batch
    verifier)."""
    import tempfile
    import time as _time
    from stellar_tpu_torch.catchup.catchup import (
        CatchupConfiguration, CatchupWork,
    )
    from stellar_tpu_torch.history.history_manager import (
        FileArchive, HistoryManager,
    )
    from stellar_tpu_torch.tx.tx_test_utils import (
        TEST_NETWORK_ID, make_tx, payment_op, seed_root_with_accounts,
    )
    from stellar_tpu_torch.utils.timer import VIRTUAL_TIME, VirtualClock
    from stellar_tpu_torch.work.work import State, WorkScheduler

    if n_ledgers < 63:
        raise ValueError(
            "catchup scenario needs >= 63 ledgers (at least one "
            "published checkpoint to replay)")
    keys = [SecretKey.from_seed_str(f"cr-{i}") for i in range(8)]
    root = seed_root_with_accounts([(k, 10**13) for k in keys])
    lm = LedgerManager(TEST_NETWORK_ID, root)
    lm.last_closed_header.maxTxSetSize = max(1000, txs_per_ledger * 2)
    tmp = tempfile.mkdtemp(prefix="stpu-catchup-bench-")
    hm = HistoryManager([FileArchive(tmp)], "bench")
    seqs = {k.public_key.raw: (1 << 32) for k in keys}
    for i in range(n_ledgers):
        frames = []
        for t in range(txs_per_ledger):
            src = keys[t % len(keys)]
            seqs[src.public_key.raw] += 1
            frames.append(make_tx(
                src, seqs[src.public_key.raw],
                [payment_op(keys[(t + 1) % len(keys)], XLM)]))
        txset, _ = make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash)
        res = lm.close_ledger(LedgerCloseData(
            lm.ledger_seq + 1, txset,
            lm.last_closed_header.scpValue.closeTime + 5))
        hm.ledger_closed(res, txset, lm.bucket_list)

    root2 = seed_root_with_accounts([(k, 10**13) for k in keys])
    lm2 = LedgerManager(TEST_NETWORK_ID, root2)
    # genesis must match the published chain's bit-for-bit
    lm2.last_closed_header.maxTxSetSize = \
        max(1000, txs_per_ledger * 2)
    # the chain build above verified every signature through the
    # process-wide result cache; flush it so the replay measures real
    # verification work (the whole point of BASELINE #3)
    from stellar_tpu_torch.crypto.keys import flush_verify_cache
    flush_verify_cache()
    ws = WorkScheduler(VirtualClock(VIRTUAL_TIME))
    target = hm.published_checkpoints[-1]
    work = CatchupWork(lm2, FileArchive(tmp),
                       CatchupConfiguration(target))
    t0 = _time.perf_counter()
    ws.schedule(work)
    ws.run_until_done(timeout=3600)
    dt = _time.perf_counter() - t0
    assert work.state == State.SUCCESS
    replayed = lm2.ledger_seq - 2
    return {
        "scenario": "catchup-replay",
        "replayed_ledgers": replayed,
        "txs_per_ledger": txs_per_ledger,
        "wall_s": round(dt, 2),
        "ledgers_per_sec": round(replayed / dt, 2),
        "txs_per_sec": round(replayed * txs_per_ledger / dt, 1),
    }


def scp_storm_bench(n_validators: int = 16, n_rounds: int = 5) -> dict:
    """BASELINE config #4 shape: N validators × M consensus rounds on
    the loopback overlay; reports rounds/sec and envelope counts."""
    import time as _time
    from stellar_tpu_torch.simulation.simulation import Topologies
    sim = Topologies.core(n_validators)
    sim.start_all_nodes()
    apps = list(sim.nodes.values())
    ok = sim.crank_until(
        lambda: all(a.overlay.authenticated_count() >= n_validators - 1
                    for a in apps), 60)
    assert ok, "mesh never authenticated"
    start_seq = apps[0].lm.ledger_seq
    t0 = _time.perf_counter()
    assert sim.crank_until_ledger(start_seq + n_rounds, timeout=600)
    dt = _time.perf_counter() - t0
    assert sim.in_consensus()
    envelopes = sum(
        len(slot.statements_history)
        for a in apps for slot in a.herder.scp.known_slots.values())
    return {
        "scenario": "scp-storm",
        "validators": n_validators,
        "rounds": n_rounds,
        "wall_s": round(dt, 2),
        "rounds_per_sec": round(n_rounds / dt, 3),
        "total_statements": envelopes,
    }
