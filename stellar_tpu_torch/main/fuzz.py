"""Fuzz harnesses (reference ``src/test/FuzzerImpl.cpp`` + ``fuzz.cpp``
+ ``docs/fuzzing.md``): deterministic, seeded campaigns in the
reference's two modes —

* **tx**: structured random operations (plus byte-level mutants of
  valid envelopes) applied through the REAL close pipeline against a
  seeded ledger with every invariant enabled. The invariant: apply may
  *fail* a transaction however it likes, but must never throw out of
  ``close_ledger`` and must never break an invariant.
* **overlay**: random and bit-flipped frames injected into an
  authenticated peer pair; the node must drop or ignore, never crash.

Like the reference (fuzzing.md:10-43) signature verification is
bypassed for throughput — the fuzzer explores apply logic, not ed25519.
"""

from __future__ import annotations

import random
from typing import List, Optional

__all__ = ["TxFuzzer", "OverlayFuzzer", "WasmFuzzer", "run_fuzz"]

XLM = 10_000_000


class TxFuzzer:
    def __init__(self, seed: int = 0):
        from stellar_tpu_torch.crypto.keys import SecretKey
        from stellar_tpu_torch.invariant import (
            InvariantManager, set_active_manager,
        )
        from stellar_tpu_torch.ledger.ledger_manager import LedgerManager
        from stellar_tpu_torch.tx.tx_test_utils import seed_root_with_accounts
        self.rng = random.Random(seed)
        self.keys = [SecretKey.from_seed_str(f"fuzz-{i}")
                     for i in range(6)]
        root = seed_root_with_accounts(
            [(k, 100_000 * XLM) for k in self.keys])
        self.lm = LedgerManager(b"\x5a" * 32, root)
        set_active_manager(InvariantManager([".*"]))
        self.crashes: List[str] = []
        self.applied = 0
        self.rejected = 0

    # ---------------- generators ----------------

    def _account(self):
        from stellar_tpu_torch.xdr.types import account_id
        return account_id(self.rng.choice(self.keys).public_key.raw)

    def _muxed(self):
        from stellar_tpu_torch.xdr.tx import muxed_account
        return muxed_account(self.rng.choice(self.keys).public_key.raw)

    def _asset(self):
        from stellar_tpu_torch.xdr.types import NATIVE_ASSET, asset_alphanum4
        if self.rng.random() < 0.4:
            return NATIVE_ASSET
        code = bytes(self.rng.choice(b"ABCDXYZ01") for _ in range(3))
        return asset_alphanum4(code, self._account())

    def _amount(self):
        return self.rng.choice([0, 1, -1, 100, XLM,
                                2**63 - 1, -(2**63),
                                self.rng.randrange(0, 10**12)])

    def _random_op(self):
        from stellar_tpu_torch.xdr.tx import (
            ChangeTrustAsset, ChangeTrustOp, CreateAccountOp,
            ManageDataOp, ManageSellOfferOp, Operation, OperationBody,
            OperationType, PathPaymentStrictReceiveOp, PaymentOp,
            SetOptionsOp,
        )
        from stellar_tpu_torch.xdr.types import Price
        r = self.rng
        choice = r.randrange(9)
        if choice == 7:
            # sponsorship sandwich fragments (often invalid: missing
            # Begin/End pairing exercises txBAD_SPONSORSHIP)
            from stellar_tpu_torch.xdr.tx import (
                BeginSponsoringFutureReservesOp,
            )
            if r.random() < 0.5:
                body = OperationBody.make(
                    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES,
                    BeginSponsoringFutureReservesOp(
                        sponsoredID=self._account()))
            else:
                body = OperationBody.make(
                    OperationType.END_SPONSORING_FUTURE_RESERVES, None)
            return Operation(sourceAccount=None, body=body)
        if choice == 8:
            from stellar_tpu_torch.xdr.tx import (
                LiquidityPoolDepositOp, LiquidityPoolWithdrawOp,
            )
            if r.random() < 0.5:
                body = OperationBody.make(
                    OperationType.LIQUIDITY_POOL_DEPOSIT,
                    LiquidityPoolDepositOp(
                        liquidityPoolID=bytes(
                            r.randrange(256) for _ in range(32)),
                        maxAmountA=self._amount(),
                        maxAmountB=self._amount(),
                        minPrice=Price(n=r.randrange(-2, 100),
                                       d=r.randrange(-2, 100)),
                        maxPrice=Price(n=r.randrange(-2, 100),
                                       d=r.randrange(-2, 100))))
            else:
                body = OperationBody.make(
                    OperationType.LIQUIDITY_POOL_WITHDRAW,
                    LiquidityPoolWithdrawOp(
                        liquidityPoolID=bytes(
                            r.randrange(256) for _ in range(32)),
                        amount=self._amount(),
                        minAmountA=self._amount(),
                        minAmountB=self._amount()))
            return Operation(sourceAccount=None, body=body)
        if choice == 0:
            body = OperationBody.make(OperationType.PAYMENT, PaymentOp(
                destination=self._muxed(), asset=self._asset(),
                amount=self._amount()))
        elif choice == 1:
            from stellar_tpu_torch.crypto.keys import SecretKey
            dest = SecretKey.from_seed_str(f"fz-new-{r.randrange(8)}")
            from stellar_tpu_torch.xdr.types import account_id
            body = OperationBody.make(
                OperationType.CREATE_ACCOUNT, CreateAccountOp(
                    destination=account_id(dest.public_key.raw),
                    startingBalance=self._amount()))
        elif choice == 2:
            body = OperationBody.make(
                OperationType.CHANGE_TRUST, ChangeTrustOp(
                    line=ChangeTrustAsset.make(
                        self._asset().arm, self._asset().value),
                    limit=self._amount()))
        elif choice == 3:
            body = OperationBody.make(
                OperationType.MANAGE_SELL_OFFER, ManageSellOfferOp(
                    selling=self._asset(), buying=self._asset(),
                    amount=self._amount(),
                    price=Price(n=r.randrange(-2, 10**7),
                                d=r.randrange(-2, 10**7)),
                    offerID=r.choice([0, 1, 2**62])))
        elif choice == 4:
            body = OperationBody.make(
                OperationType.MANAGE_DATA, ManageDataOp(
                    dataName=bytes(r.choice(b"abc \x00\xff")
                                   for _ in range(r.randrange(0, 70))),
                    dataValue=None if r.random() < 0.3 else
                    bytes(r.randrange(256)
                          for _ in range(r.randrange(0, 64)))))
        elif choice == 5:
            body = OperationBody.make(
                OperationType.SET_OPTIONS, SetOptionsOp(
                    inflationDest=None, clearFlags=r.randrange(16),
                    setFlags=r.randrange(16),
                    masterWeight=r.randrange(300),
                    lowThreshold=r.randrange(300),
                    medThreshold=None, highThreshold=None,
                    homeDomain=None, signer=None))
        else:
            body = OperationBody.make(
                OperationType.PATH_PAYMENT_STRICT_RECEIVE,
                PathPaymentStrictReceiveOp(
                    sendAsset=self._asset(), sendMax=self._amount(),
                    destination=self._muxed(),
                    destAsset=self._asset(),
                    destAmount=self._amount(),
                    path=[self._asset()
                          for _ in range(self.rng.randrange(0, 3))]))
        return Operation(sourceAccount=None, body=body)

    def _make_frame(self, source, ops, soroban_data=None, fee=10_000):
        from stellar_tpu_torch.tx.tx_test_utils import make_tx
        from stellar_tpu_torch.ledger.ledger_txn import key_bytes
        from stellar_tpu_torch.tx.op_frame import account_key
        from stellar_tpu_torch.xdr.types import account_id
        e = self.lm.root.store.get(key_bytes(account_key(
            account_id(source.public_key.raw))))
        seq = e.data.value.seqNum + 1 if e is not None else 1
        return make_tx(source, seq, ops, fee=fee,
                       network_id=self.lm.network_id,
                       soroban_data=soroban_data)

    def _soroban_frame(self, source):
        """Random Soroban tx: uploads of valid/garbage code with
        random-ish footprints and resource declarations."""
        from stellar_tpu_torch.crypto.sha import sha256
        from stellar_tpu_torch.soroban.host import (
            assemble_program, contract_code_key, ins, sym, u32,
        )
        from stellar_tpu_torch.xdr.contract import HostFunction, HostFunctionType
        from stellar_tpu_torch.xdr.tx import (
            InvokeHostFunctionOp, LedgerFootprint, Operation,
            OperationBody, OperationType, SorobanResources,
            SorobanTransactionData,
        )
        from stellar_tpu_torch.xdr.types import ExtensionPoint
        r = self.rng
        if r.random() < 0.5:
            code = assemble_program({
                f"f{r.randrange(4)}": [ins("push", u32(r.randrange(99))),
                                       ins("ret")]})
        else:
            code = bytes(r.randrange(256)
                         for _ in range(r.randrange(0, 200)))
        fn = HostFunction.make(
            HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM,
            code)
        rw = [contract_code_key(sha256(code))]
        if r.random() < 0.3:
            rw = []  # missing footprint: must trap, not crash
        sd = SorobanTransactionData(
            ext=ExtensionPoint.make(0),
            resources=SorobanResources(
                footprint=LedgerFootprint(readOnly=[], readWrite=rw),
                instructions=r.choice([0, 1000, 2_000_000]),
                readBytes=r.choice([0, 3000]),
                writeBytes=r.choice([0, 3000])),
            resourceFee=r.choice([0, 1000, 5_000_000]))
        op = Operation(sourceAccount=None, body=OperationBody.make(
            OperationType.INVOKE_HOST_FUNCTION,
            InvokeHostFunctionOp(hostFunction=fn, auth=[])))
        return self._make_frame(source, [op], soroban_data=sd,
                                fee=6_000_000)

    # ---------------- the campaign ----------------

    def _mutant_frame(self, source):
        """Byte-level mutant of a valid signed envelope (the reference
        fuzzer's raw-XDR mode): either unparsable (fine) or a parsed
        frame with corrupted fields."""
        from stellar_tpu_torch.tx.tx_test_utils import payment_op
        from stellar_tpu_torch.tx.transaction_frame import make_transaction_frame
        from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes
        from stellar_tpu_torch.xdr.tx import TransactionEnvelope
        base = self._make_frame(
            source, [payment_op(self.rng.choice(self.keys), XLM)])
        raw = bytearray(to_bytes(TransactionEnvelope, base.envelope))
        for _ in range(self.rng.randrange(1, 6)):
            raw[self.rng.randrange(len(raw))] ^= \
                1 << self.rng.randrange(8)
        env = from_bytes(TransactionEnvelope, bytes(raw))  # may raise
        return make_transaction_frame(self.lm.network_id, env)

    def step(self):
        from stellar_tpu_torch.herder.tx_set import (
            make_tx_set_from_transactions,
        )
        from stellar_tpu_torch.invariant.invariants import InvariantDoesNotHold
        from stellar_tpu_torch.ledger.ledger_manager import LedgerCloseData
        source = self.rng.choice(self.keys)
        try:
            roll = self.rng.random()
            if roll < 0.2:
                frame = self._mutant_frame(source)
            elif roll < 0.35:
                frame = self._soroban_frame(source)
            else:
                ops = [self._random_op()
                       for _ in range(self.rng.randrange(1, 4))]
                frame = self._make_frame(source, ops)
        except Exception:
            self.rejected += 1  # malformed beyond envelope construction
            return
        lcl = self.lm.last_closed_header
        txset, _ = make_tx_set_from_transactions(
            [frame], lcl, self.lm.last_closed_hash)
        # the consensus trust boundary: only CERTIFIED sets reach
        # close_ledger (validateValue -> checkValid); a set that fails
        # validation is simply never externalized
        from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn
        with LedgerTxn(self.lm.root) as scope:
            set_ok = txset.check_valid(scope, self.lm.last_closed_hash)
            scope.rollback()
        if not set_ok:
            self.rejected += 1
            return
        try:
            res = self.lm.close_ledger(LedgerCloseData(
                lcl.ledgerSeq + 1, txset,
                lcl.scpValue.closeTime + 5))
            if res.failed_count:
                self.rejected += 1
            else:
                self.applied += 1
        except InvariantDoesNotHold as e:
            self.crashes.append(f"invariant: {e}")
        except Exception as e:  # close must never throw
            self.crashes.append(f"{type(e).__name__}: {e}")

    def run(self, iterations: int) -> dict:
        for _ in range(iterations):
            self.step()
            if self.crashes:
                break
        return {"iterations": iterations, "applied": self.applied,
                "rejected": self.rejected, "crashes": self.crashes}


class OverlayFuzzer:
    """Feed garbage and bit-flipped frames into an authenticated peer
    (reference overlay fuzz mode)."""

    def __init__(self, seed: int = 0):
        from stellar_tpu_torch.simulation.simulation import Topologies
        self.rng = random.Random(seed)
        self.sim = Topologies.core(2, threshold=2)
        self.sim.start_all_nodes()
        self.apps = list(self.sim.nodes.values())
        self.sim.crank_until(
            lambda: all(a.overlay.authenticated_count() == 1
                        for a in self.apps), 30)
        self.crashes: List[str] = []

    def step(self):
        r = self.rng
        victim = self.apps[0]
        if not victim.overlay.peers and not victim.overlay.pending_peers:
            # all connections fuzzed to death: re-link and continue
            from stellar_tpu_torch.overlay.loopback import connect_loopback
            connect_loopback(self.apps[0], self.apps[1])
            self.sim.crank_all_nodes(30)
            if not victim.overlay.peers:
                return
        peers = victim.overlay.peers or victim.overlay.pending_peers
        peer = r.choice(peers)
        mode = r.randrange(3)
        if mode == 0:
            raw = bytes(r.randrange(256)
                        for _ in range(r.randrange(0, 200)))
        else:
            from stellar_tpu_torch.xdr.overlay import (
                MessageType, SendMoreExtended, StellarMessage,
            )
            from stellar_tpu_torch.xdr.runtime import to_bytes
            from stellar_tpu_torch.xdr.overlay import AuthenticatedMessage, \
                AuthenticatedMessageV0
            from stellar_tpu_torch.xdr.types import HmacSha256Mac
            msg = StellarMessage.make(
                MessageType.SEND_MORE_EXTENDED,
                SendMoreExtended(numMessages=r.randrange(2**32),
                                 numBytes=r.randrange(2**32)))
            am = AuthenticatedMessage.make(0, AuthenticatedMessageV0(
                sequence=r.randrange(2**32), message=msg,
                mac=HmacSha256Mac(mac=bytes(32))))
            raw = bytearray(to_bytes(AuthenticatedMessage, am))
            for _ in range(r.randrange(0, 8)):
                raw[r.randrange(len(raw))] ^= 1 << r.randrange(8)
            raw = bytes(raw)
        try:
            peer.receive_bytes(raw)
            self.sim.crank_all_nodes(3)
        except Exception as e:
            self.crashes.append(f"{type(e).__name__}: {e}")

    def run(self, iterations: int) -> dict:
        for _ in range(iterations):
            self.step()
            if self.crashes:
                break
        return {"iterations": iterations, "crashes": self.crashes}


def run_fuzz(mode: str, iterations: int, seed: int) -> dict:
    fuzzer = {"tx": TxFuzzer, "overlay": OverlayFuzzer,
              "wasm": WasmFuzzer}[mode](seed)
    out = fuzzer.run(iterations)
    out["mode"] = mode
    out["seed"] = seed
    return out


class _FuzzBudget:
    """Budget-shaped object for engine-differential fuzzing."""

    def __init__(self, cpu_limit: int):
        self.cpu_limit = cpu_limit
        self.mem_limit = 1 << 40
        self.cpu = 0
        self.mem = 0

    def charge(self, cpu, mem=0):
        from stellar_tpu_torch.soroban.wasm import Trap
        self.cpu += cpu
        self.mem += mem
        if self.cpu > self.cpu_limit or self.mem > self.mem_limit:
            raise Trap("fuzz budget exceeded")


class WasmFuzzer:
    """Wasm VM fuzz (the ``invoke_host_function`` attack surface): the
    decoder must raise ONLY WasmError on arbitrary bytes, and
    execution of anything that validates must end in a value, Trap, or
    budget exhaustion — never any other exception (a node-killing
    escape).

    Three corpora per step: random bytes behind the magic, structural
    mutants of the real counter contract, and valid-module invocation
    with randomized Val args through the host import table."""

    def __init__(self, seed: int = 0):
        """The mutation corpus is ``example_contracts``' two modules, as
        the reference's is wherever its fixtures' directory is missing.
        The port reads no environment option, so it has no directory of
        foreign ``*.wasm`` fixtures to add."""
        self.r = random.Random(seed)
        self.crashes: List[str] = []
        from stellar_tpu_torch.soroban.example_contracts import (
            counter_wasm, sum_wasm,
        )
        self.base_modules = [counter_wasm(), sum_wasm()]

    def _mutant(self) -> bytes:
        r = self.r
        mode = r.randrange(3)
        if mode == 0:  # random tail behind a valid magic+version
            return b"\x00asm\x01\x00\x00\x00" + bytes(
                r.randrange(256) for _ in range(r.randrange(0, 400)))
        raw = bytearray(r.choice(self.base_modules))
        if mode == 1:  # bit flips
            for _ in range(r.randrange(1, 16)):
                raw[r.randrange(len(raw))] ^= 1 << r.randrange(8)
            return bytes(raw)
        # truncation / duplication splice
        cut = r.randrange(8, len(raw))
        if r.random() < 0.5:
            return bytes(raw[:cut])
        ins = r.randrange(8, len(raw))
        return bytes(raw[:ins] + raw[cut:] + raw[ins:])

    def step(self):
        from stellar_tpu_torch.soroban.wasm import (
            Trap, WasmError, WasmInstance, parse_module,
        )
        r = self.r
        raw = self._mutant()
        try:
            module = parse_module(raw)
        except WasmError:
            return
        except Exception as e:
            self.crashes.append(
                f"decode {type(e).__name__}: {e} "
                f"(input sha {__import__('hashlib').sha256(raw).hexdigest()[:16]})")
            return
        # validated: every export must run to a value/Trap under a
        # hard budget, with host imports that return seeded Vals; when
        # the native engine is built, BOTH engines run the same case
        # and must agree on outcome class, value, and consumed budget
        # (differential fuzzing of the consensus-parity contract)
        from stellar_tpu_torch.soroban import native_wasm
        native_ok = native_wasm.available()
        exports = [(name, idx)
                   for name, (kind, idx) in module.exports.items()
                   if kind == "func"][:4]
        cases = []
        for name, idx in exports:
            ft = module.func_type(idx)
            cases.append((name,
                          [r.randrange(1 << 64) for _ in ft.params],
                          r.randrange(64, 60_000)))

        def run_python(name, args, limit, host_seed):
            hr = random.Random(host_seed)
            bud = _FuzzBudget(limit)

            def host_fn(inst, *a):
                return hr.randrange(1 << 64)
            imports = {(m, n): host_fn
                       for m, n, _t in module.imports}
            try:
                inst = WasmInstance(
                    module, imports,
                    lambda n: bud.charge(n * 4),
                    mem_charge=lambda n: bud.charge(0, n))
                v = inst.invoke(name, list(args))
                return ("value", v, bud.cpu)
            except Trap as e:
                kind = "budget" if "budget" in str(e) else "trap"
                return (kind, None, bud.cpu)

        def run_native(name, args, limit, host_seed):
            hr = random.Random(host_seed)
            bud = _FuzzBudget(limit)

            def host_fn(inst, *a):
                return hr.randrange(1 << 64)
            imports = {(m, n): host_fn
                       for m, n, _t in module.imports}
            try:
                v = native_wasm.run_export(module, imports, bud, 4,
                                           name, list(args))
                return ("value", v, bud.cpu)
            except Trap as e:
                kind = "budget" if "budget" in str(e) else "trap"
                return (kind, None, bud.cpu)

        try:
            for name, args, limit in cases:
                seed = r.randrange(1 << 30)
                p = run_python(name, args, limit * 4, seed)
                if native_ok:
                    n = run_native(name, args, limit * 4, seed)
                    if p[0] != n[0] or p[1] != n[1] or p[2] != n[2]:
                        self.crashes.append(
                            f"engine divergence on {name}{args}: "
                            f"python {p} vs native {n}")
        except Exception as e:
            self.crashes.append(f"exec {type(e).__name__}: {e}")

    def run(self, iterations: int) -> dict:
        for _ in range(iterations):
            self.step()
            if self.crashes:
                break
        return {"iterations": iterations, "crashes": self.crashes}
