"""Builders for transaction tests (reference ``src/test/TxTests.cpp`` /
``TestAccount`` fluent helpers): construct signed envelopes and seeded
ledgers without going through consensus.

The port's copy of ``stellar_tpu/tx/tx_test_utils.py``, with the port's
imports.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from stellar_tpu_torch.crypto.keys import SecretKey
from stellar_tpu_torch.ledger.ledger_txn import LedgerTxn, LedgerTxnRoot
from stellar_tpu_torch.tx.ops.create_account import new_account_entry
from stellar_tpu_torch.tx.transaction_frame import (
    TransactionFrame, make_transaction_frame,
)
from stellar_tpu_torch.xdr.tx import (
    MEMO_NONE, Operation, OperationBody, OperationType, PaymentOp,
    Preconditions, PreconditionType, Transaction, TransactionEnvelope,
    TransactionV1Envelope, muxed_account, transaction_sig_payload,
)
from stellar_tpu_torch.xdr.types import EnvelopeType, NATIVE_ASSET, account_id

TEST_NETWORK_ID = bytes(range(32))


def keypair(name: str) -> SecretKey:
    return SecretKey.from_seed_str(name)


def make_tx(source: SecretKey, seq_num: int, ops: Sequence[Operation],
            fee: Optional[int] = None, cond=None, memo=None,
            network_id: bytes = TEST_NETWORK_ID,
            extra_signers: Sequence[SecretKey] = (),
            soroban_data=None) -> TransactionFrame:
    """Build + sign a v1 envelope and wrap it in a frame."""
    tx = Transaction(
        sourceAccount=muxed_account(source.public_key.raw),
        fee=fee if fee is not None else 100 * max(1, len(ops)),
        seqNum=seq_num,
        cond=cond if cond is not None else Preconditions.make(
            PreconditionType.PRECOND_NONE),
        memo=memo if memo is not None else MEMO_NONE,
        operations=list(ops),
        ext=Transaction._types[6].make(0) if soroban_data is None
        else Transaction._types[6].make(1, soroban_data))
    payload = transaction_sig_payload(network_id, tx)
    from stellar_tpu_torch.crypto.sha import sha256
    h = sha256(payload)
    sigs = [k.sign_decorated(h) for k in (source, *extra_signers)]
    env = TransactionEnvelope.make(
        EnvelopeType.ENVELOPE_TYPE_TX,
        TransactionV1Envelope(tx=tx, signatures=sigs))
    return TransactionFrame(network_id, env)


def payment_op(dest: SecretKey, amount: int, asset=None,
               source: Optional[SecretKey] = None) -> Operation:
    op = PaymentOp(destination=muxed_account(dest.public_key.raw),
                   asset=asset if asset is not None else NATIVE_ASSET,
                   amount=amount)
    return Operation(
        sourceAccount=muxed_account(source.public_key.raw)
        if source else None,
        body=OperationBody.make(OperationType.PAYMENT, op))


def create_account_op(dest: SecretKey, balance: int,
                      source: Optional[SecretKey] = None) -> Operation:
    from stellar_tpu_torch.xdr.tx import CreateAccountOp
    op = CreateAccountOp(destination=account_id(dest.public_key.raw),
                         startingBalance=balance)
    return Operation(
        sourceAccount=muxed_account(source.public_key.raw)
        if source else None,
        body=OperationBody.make(OperationType.CREATE_ACCOUNT, op))


def seed_root_with_accounts(accounts, ledger_seq: int = 2,
                            close_time: int = 1000) -> LedgerTxnRoot:
    """Root whose store holds the given (SecretKey, balance) accounts,
    each with seqNum = (ledger_seq-1) << 32."""
    root = LedgerTxnRoot()
    with LedgerTxn(root) as ltx:
        with ltx.load_header() as hh:
            hh.header.ledgerSeq = ledger_seq
            hh.header.scpValue.closeTime = close_time
        for sk, balance in accounts:
            ltx.create(new_account_entry(
                account_id(sk.public_key.raw), balance,
                (ledger_seq - 1) << 32)).deactivate()
        ltx.commit()
    return root
