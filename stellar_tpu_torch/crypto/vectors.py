"""Seeded ed25519 test vectors for the port's tests and ``chip_smoke.py``.

Every vector comes from a ``numpy.random.Generator`` the caller seeds, so
a run can be repeated exactly. Signatures are made with the port's own
oracle (:mod:`stellar_tpu_torch.crypto.ed25519_ref`).

* :func:`edge_corpus` — (pk, msg, sig) triples aimed at every rejection
  rule of libsodium's verify: small-order and sign-flipped A and R,
  non-canonical y, undecompressable A, negative zero, non-canonical and
  extreme s, bad lengths, all-zero rows and single-bit flips;
* :func:`valid_items` — fresh signatures over random messages;
* :func:`matching_rows` — raw kernel rows (A, R, s, h) whose scalars are
  arbitrary 256-bit values, including s, h >= 2^255, with R set to
  encode(s*B + h*(-A)), so the device bit must be True although the host
  gate would reject most of them;
* :func:`hot_matching_rows` — the same for the hot kernel: rows (signer
  table, R, s, h) with R set to what the 128-entry tables reach, the top
  radix-256 digit of s and h often above 128 (where the select
  saturates);
* :func:`r16_matching_rows` — rows for the radix-16 kernel whose bit is
  True: s and h below :data:`R16_OVERFLOW`, where the top radix-16 digit
  fits the 8-entry table;
* :func:`r16_overflow_rows` — rows with s or h at or above
  :data:`R16_OVERFLOW` (every s >= 9 * 2^252 among them), where the top
  digit selects the zero point: R = 32 zero bytes (bit True) on even
  rows, R = encode(s*B + h*(-A)) (bit False) on odd ones;
* :func:`node_txset` — a set of signed ``TransactionEnvelope`` XDR blobs
  and the account table they are checked against: single-key, 2-of-3
  multisig, two-operation and pre-auth/hashX/signed-payload accounts,
  some signatures corrupted;
* :func:`collect_candidates` — every (pk, msg, sig) triple such a set
  may verify, as the node's TxSet prefetch collects them;
* :func:`check_transaction` — a transaction's signature verdict and the
  checker's ``used`` flags, in the order the node checks them;
* :func:`node_ledger` — a ``LedgerTxnRoot`` holding such an account
  table, each sequence number one below its transaction's, under a
  header the set's transactions validate against;
* :func:`node_close_ledger` — that root plus the entries that let every
  operation of such a set succeed at apply: the payments' destinations,
  the offers' issuers and the sellers' trustlines;
* :func:`catchup_plan` — the payments of a chain for catchup: each of
  ``senders`` single-key accounts pays one of as many destinations in
  every full ledger, amounts and destinations drawn from the generator;
* :func:`catchup_root` — the chain's genesis: those accounts and two
  persistent contract-data entries whose time to live has run out, at
  the protocol before state archival;
* :func:`catchup_upgrades` — ledger 3's upgrades: state archival's
  protocol and ``CATCHUP_MAX_TX_SET_SIZE``;
* :func:`catchup_envelopes` — the plan's payments of some ledgers as
  signed ``TransactionEnvelope`` XDR blobs, signed on a process pool
  when asked;
* :func:`flood_accounts`, :func:`flood_envelopes` — the funded sources
  of a transaction flood over a simulated network and one signed
  payment from each to one destination;
* :func:`core_network` — ``Topologies.core(n)``'s validators, each added
  with a ``Config`` of its own, and :func:`statement_digest`, the digest
  of the statements such a network exchanged;
* :func:`soroban_tamper_accounts`, :func:`soroban_tamper_config`,
  :func:`soroban_tamper_envelopes` — the counter contract deployed and
  invoked by ten sources, one auth entry's signature with a byte
  flipped;
* :func:`operator_genesis`, :func:`operator_rounds`,
  :func:`operator_state_digest` — a standalone node's genesis written
  into its database (the network root holding every coin), the
  transactions a running node takes over its ``tx`` route (one creating
  the accounts, then two rounds of one payment from each), and the
  digest of the accounts' balances and sequence numbers after them.
"""

from __future__ import annotations

import numpy as np

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.crypto.keys import SecretKey
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.ledger.ledger_txn import (
    LedgerTxnRoot, copy_header, entry_to_key, key_bytes,
)
from stellar_tpu_torch.parallel.signer_tables import build_signer_table
from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
from stellar_tpu_torch.tx.account_utils import INT64_MAX
from stellar_tpu_torch.tx.op_frame import account_key
from stellar_tpu_torch.tx import signature_utils as su
from stellar_tpu_torch.tx.signature_checker import SignatureChecker
from stellar_tpu_torch.xdr import tx as xtx
from stellar_tpu_torch.xdr import types as xt
from stellar_tpu_torch.xdr.runtime import from_bytes, to_bytes

__all__ = ["keypair", "valid_items", "edge_corpus", "matching_rows",
           "random_rows", "hot_matching_rows", "r16_matching_rows",
           "r16_overflow_rows", "R16_OVERFLOW", "NODE_NETWORK_ID",
           "node_txset", "collect_candidates", "check_transaction",
           "node_ledger", "node_close_ledger", "NODE_MAX_TX_SET_SIZE",
           "catchup_plan", "catchup_root", "catchup_upgrades",
           "catchup_close_time", "catchup_envelopes",
           "CATCHUP_MAX_TX_SET_SIZE"]

# The least scalar whose signed radix-16 top digit exceeds the 8-entry
# table: 0x8777...78 (an 8, 62 sevens, an 8). Digits in [-8, 8) below
# the top reach at most 0x77...7 (63 nibbles), so the low 252 bits carry
# into the top window from 0x77...78 on; the top digit is 9 from here and
# 8 just below. Every scalar >= 9 * 2^252 overflows.
R16_OVERFLOW = 8 * 16**63 + 7 * (16**63 - 1) // 15 + 1


def keypair(rng: np.random.Generator):
    """(seed, public key) from 32 random bytes."""
    seed = rng.bytes(32)
    return seed, ref.secret_to_public(seed)


def valid_items(rng: np.random.Generator, n: int, msg_len=32) -> list:
    """``n`` good (pk, msg, sig) triples, each from its own signer.
    ``msg_len`` is an int or a function of the item's index."""
    items = []
    for i in range(n):
        seed, pk = keypair(rng)
        msg = rng.bytes(msg_len(i) if callable(msg_len) else msg_len)
        items.append((pk, msg, ref.sign(seed, msg)))
    return items


def edge_corpus(rng: np.random.Generator) -> list:
    """Structured adversarial (pk, msg, sig) triples; item 0 is a good
    control signature."""
    seed, pk = keypair(rng)
    msg = b"edge corpus"
    sig = ref.sign(seed, msg)
    r, s = sig[:32], sig[32:]
    items = [(pk, msg, sig)]
    # small-order A and R, canonical and sign-flipped encodings
    for enc in sorted(ref.SMALL_ORDER_ENCODINGS):
        items.append((enc, msg, sig))
        items.append((enc[:31] + bytes([enc[31] | 0x80]), msg, sig))
        items.append((pk, msg, enc + s))
    # non-canonical y: A with y = p + 3 (it has an x), R with y = p + 3
    items.append(((ref.P + 3).to_bytes(32, "little"), msg, sig))
    items.append((pk, msg, (ref.P + 3).to_bytes(32, "little") + s))
    # undecompressable A: the first three y with no square root
    y, found = 2, 0
    while found < 3:
        enc = y.to_bytes(32, "little")
        if ref.point_decompress(enc) is None:
            items.append((enc, msg, sig))
            found += 1
        y += 1
    # negative zero: y = 1 (x = 0) with the sign bit set
    nz = bytearray((1).to_bytes(32, "little"))
    nz[31] |= 0x80
    items.append((bytes(nz), msg, sig))
    # non-canonical and extreme s
    s_int = int.from_bytes(s, "little")
    for bad in (ref.L, s_int + ref.L, 2**256 - 1, 0, 9 * 2**252,
                15 * 2**252 + s_int % 2**252):
        items.append((pk, msg, r + (bad % 2**256).to_bytes(32, "little")))
    # bad lengths
    items += [(pk[:31], msg, sig), (pk + b"\x00", msg, sig),
              (pk, msg, sig[:63]), (pk, msg, sig + b"\x00"),
              (b"", msg, sig), (pk, msg, b"")]
    # all-zero rows
    items += [(bytes(32), msg, bytes(64)), (bytes(32), b"", bytes(64))]
    # tampered message, R and s
    items.append((pk, msg + b"x", sig))
    for pos, bit in ((5, 0x40), (40, 1)):
        flip = bytearray(sig)
        flip[pos] ^= bit
        items.append((pk, msg, bytes(flip)))
    return items


def _neg(pt):
    return ((ref.P - pt[0]) % ref.P, pt[1], pt[2], (ref.P - pt[3]) % ref.P)


def matching_rows(rng: np.random.Generator, n: int):
    """``n`` raw rows (a, r, s, h), each (n, 32) uint8, whose device bit is
    True: A a valid key, s and h arbitrary 256-bit scalars (the first rows
    take the extremes 0, 2^255 - 1, 2^255, 2^256 - 1), R = encode(s*B +
    h*(-A))."""
    return _rows_for(rng, n, [0, 2**255 - 1, 2**255, 2**256 - 1],
                     lambda: int.from_bytes(rng.bytes(32), "little"))


def r16_matching_rows(rng: np.random.Generator, n: int):
    """``n`` raw rows (a, r, s, h) whose radix-16 device bit is True: s
    and h below :data:`R16_OVERFLOW` (the first rows take 0, 8 * 2^252,
    ``R16_OVERFLOW - 1`` and 2^255 - 1, top digits 0 and 8), R =
    encode(s*B + h*(-A))."""
    return _rows_for(rng, n, [0, 8 * 2**252, R16_OVERFLOW - 1, 2**255 - 1],
                     lambda: int.from_bytes(rng.bytes(32), "little")
                     % R16_OVERFLOW)


def r16_overflow_rows(rng: np.random.Generator, n: int):
    """``n`` raw rows (a, r, s, h) with a valid A and s or h at or above
    :data:`R16_OVERFLOW`, where the radix-16 top digit (9 to 16) selects
    the zero point and the accumulator ends at (0, 0, 0): R = 32 zero
    bytes on even rows (bit True), R = encode(s*B + h*(-A)) on odd rows
    (bit False). The first rows take ``R16_OVERFLOW``, 9 * 2^252 and
    2^256 - 1."""
    a, r, s, h = _rows_for(rng, n, [R16_OVERFLOW, 9 * 2**252, 2**256 - 1],
                           lambda: R16_OVERFLOW + int.from_bytes(
                               rng.bytes(32), "little")
                           % (2**256 - R16_OVERFLOW))
    for i in range(n):
        if i % 4 == 1:  # only h overflows
            s[i] = np.frombuffer((int.from_bytes(s[i].tobytes(), "little")
                                  % R16_OVERFLOW).to_bytes(32, "little"),
                                 np.uint8)
        elif i % 4 == 3:  # only s overflows
            h[i] = np.frombuffer((int.from_bytes(h[i].tobytes(), "little")
                                  % R16_OVERFLOW).to_bytes(32, "little"),
                                 np.uint8)
    for i in range(n):
        sv, hv = (int.from_bytes(x[i].tobytes(), "little") for x in (s, h))
        pk = a[i].tobytes()
        point = ref.point_add(ref.scalarmult_base(sv), ref.point_mul(
            hv, _neg(ref.point_decompress(pk))))
        r[i] = np.frombuffer(bytes(32) if i % 2 == 0
                             else ref.point_compress(point), np.uint8)
    return a, r, s, h


def _rows_for(rng, n, extremes, draw):
    """``n`` rows (a, r, s, h) over fresh keys with R = encode(s*B +
    h*(-A)): s takes ``extremes`` in order and h in reverse order on the
    first rows, then both come from ``draw()``."""
    a = np.zeros((n, 32), np.uint8)
    r, s, h = np.zeros_like(a), np.zeros_like(a), np.zeros_like(a)
    for i in range(n):
        _, pk = keypair(rng)
        sv = extremes[i] if i < len(extremes) else draw()
        hv = extremes[-1 - i] if i < len(extremes) else draw()
        point = ref.point_add(ref.scalarmult_base(sv),
                              ref.point_mul(hv, _neg(ref.point_decompress(pk))))
        a[i] = np.frombuffer(pk, np.uint8)
        r[i] = np.frombuffer(ref.point_compress(point), np.uint8)
        s[i] = np.frombuffer(sv.to_bytes(32, "little"), np.uint8)
        h[i] = np.frombuffer(hv.to_bytes(32, "little"), np.uint8)
    return a, r, s, h


def random_rows(rng: np.random.Generator, n: int):
    """``n`` rows of uniformly random bytes for all four operands."""
    return tuple(rng.integers(0, 256, (n, 32), dtype=np.uint8)
                 for _ in range(4))


def _hot_scalar(v: int) -> int:
    """The multiple of B (or -A) that the hot kernel's 128-entry tables
    give for a 256-bit scalar ``v``: ``v`` itself, unless its top signed
    radix-256 digit (the top byte plus the carry into it) exceeds 128,
    which selects entry 128."""
    carry = 0
    for i in range(31):
        carry = int(((v >> (8 * i)) & 0xFF) + carry >= 128)
    top = (v >> 248) + carry
    return v - (max(top, 128) - 128) * 256 ** 31


def hot_matching_rows(rng: np.random.Generator, n: int):
    """``n`` raw hot rows (tables (n, 128, 3, 20) int16, r, s, h (n, 32)
    uint8) whose device bit is True: each table a valid key's signer
    table, s and h arbitrary 256-bit scalars, R = encode(s'*B + h'*(-A))
    with s' and h' from :func:`_hot_scalar`. The first rows take extremes
    (0, 2^255 - 129, 2^255 - 128, 2^256 - 1, top bytes 0x80 and 0x81);
    after them every other row draws s's and h's top bytes from
    [0x81, 0xff], so the top digit saturates."""
    extremes = [0, 2**255 - 129, 2**255 - 128, 2**256 - 1, 0x81 << 248,
                (0x80 << 248) | (0xFF << 240)]
    tables = np.zeros((n, 128, 3, 20), np.int16)
    r = np.zeros((n, 32), np.uint8)
    s, h = np.zeros_like(r), np.zeros_like(r)
    for i in range(n):
        _, pk = keypair(rng)
        if i < len(extremes):
            sv, hv = extremes[i], extremes[-1 - i]
        else:
            sv, hv = (int.from_bytes(rng.bytes(32), "little")
                      for _ in range(2))
            if i % 2:
                sv = sv % 2**248 + (int(rng.integers(0x81, 0x100)) << 248)
                hv = hv % 2**248 + (int(rng.integers(0x81, 0x100)) << 248)
        point = ref.point_add(
            ref.scalarmult_base(_hot_scalar(sv)),
            ref.point_mul(_hot_scalar(hv), _neg(ref.point_decompress(pk))))
        tables[i] = build_signer_table(pk)
        r[i] = np.frombuffer(ref.point_compress(point), np.uint8)
        s[i] = np.frombuffer(sv.to_bytes(32, "little"), np.uint8)
        h[i] = np.frombuffer(hv.to_bytes(32, "little"), np.uint8)
    return tables, r, s, h


# the network id the node's traffic is signed for: SHA-256 of the public
# test network's passphrase
NODE_NETWORK_ID = sha256(b"Test SDF Network ; September 2015")

# the protocol version the checker is handed (it reads none of it)
NODE_PROTOCOL_VERSION = 21

# node_ledger's maxTxSetSize: room for every operation of node_txset's
# default set (850 one-operation and 150 two-operation transactions), so
# that nomination trims nothing
NODE_MAX_TX_SET_SIZE = 1150


def _signer(arm, value, weight: int):
    return xt.Signer(key=xt.SignerKey.make(arm, value), weight=weight)


def _account(sk: SecretKey, seq: int, thresholds, signers=()):
    return xt.AccountEntry(
        accountID=xt.account_id(sk.public_key.raw), balance=10**10,
        seqNum=seq, numSubEntries=len(signers), inflationDest=None,
        flags=0, homeDomain=b"", thresholds=bytes(thresholds),
        signers=list(signers), ext=xt.AccountEntry._types[9].make(0))


def _operation(rng: np.random.Generator, source=None):
    """A payment or a manage-sell-offer, so payload lengths vary."""
    src = None if source is None else xtx.muxed_account(source)
    if rng.random() < 0.5:
        body = xtx.OperationBody.make(
            xtx.OperationType.PAYMENT, xtx.PaymentOp(
                destination=xtx.muxed_account(rng.bytes(32)),
                asset=xt.NATIVE_ASSET,
                amount=int(rng.integers(1, 10**9))))
    else:
        code = bytes(rng.choice(list(b"ABCDEFGHXYZ"), 4).tolist())
        body = xtx.OperationBody.make(
            xtx.OperationType.MANAGE_SELL_OFFER, xtx.ManageSellOfferOp(
                selling=xt.NATIVE_ASSET,
                buying=xt.asset_alphanum4(code, xt.account_id(
                    rng.bytes(32))),
                amount=int(rng.integers(1, 10**9)),
                price=xt.Price(n=int(rng.integers(1, 1000)),
                               d=int(rng.integers(1, 1000))),
                offerID=0))
    return xtx.Operation(sourceAccount=src, body=body)


def _transaction(rng: np.random.Generator, source: bytes, seq: int, ops):
    n = int(rng.integers(0, 29))
    memo = xtx.Memo.make(xtx.MemoType.MEMO_TEXT, bytes(
        rng.integers(0x20, 0x7f, n, dtype=np.uint8))) if n else \
        xtx.MEMO_NONE
    return xtx.Transaction(
        sourceAccount=xtx.muxed_account(source), fee=100 * len(ops),
        seqNum=seq,
        cond=xtx.Preconditions.make(xtx.PreconditionType.PRECOND_NONE),
        memo=memo, operations=list(ops),
        ext=xtx.Transaction._types[6].make(0))


def node_txset(rng: np.random.Generator, single: int = 100,
               multisig: int = 700, two_op: int = 150, special: int = 50,
               corrupt: float = 0.02, short_multisig: int = 5,
               network_id: bytes = NODE_NETWORK_ID):
    """A TxSet's v1 envelopes, as XDR bytes, and the account table they
    are checked against (raw account key -> ``AccountEntry``), in a
    shuffled order:

    * ``single`` transactions from single-key accounts (master weight 1,
      thresholds 0), one signature each; one of them carries an extra
      signature from a key no account knows, which no signer uses;
    * ``multisig`` from 2-of-3 accounts (master and two ed25519 signers,
      weight 1 each, thresholds 2), signed by two of the three keys, the
      first ``short_multisig`` of them by one only;
    * ``two_op`` whose second operation's source is another single-key
      account, signed by both masters;
    * ``special`` from accounts with a pre-auth-tx signer (another
      transaction's hash, so it never counts), a hashX signer and an
      ed25519 signed-payload signer over the transaction's own hash, all
      weight 1, thresholds 3: the master's signature, the signed
      payload's and the hashX preimage.

    Each operation is a payment or a manage-sell-offer, each memo a text
    of 0-28 bytes. About ``corrupt`` of the ed25519 signatures have one
    byte flipped."""
    T = xt.SignerKeyType
    accounts: dict = {}
    built = []     # (transaction, its decorated signatures)
    extras = []    # (key, seq, signed-payload signer, hashX, tx hash)
    seq = 1 << 32

    def key() -> SecretKey:
        return SecretKey(rng.bytes(32))

    kinds = ["single"] * single + ["multisig"] * multisig + \
        ["two_op"] * two_op + ["special"] * special
    extra_at = 0 if single else None
    for i, kind in enumerate(kinds):
        seq += 1
        src = key()
        if kind == "two_op":
            other = key()
            tx = _transaction(rng, src.public_key.raw, seq, [
                _operation(rng), _operation(rng, other.public_key.raw)])
        else:
            tx = _transaction(rng, src.public_key.raw, seq,
                              [_operation(rng)])
        h = sha256(xtx.transaction_sig_payload(network_id, tx))
        if kind == "single":
            accounts[src.public_key.raw] = _account(src, seq, (1, 0, 0, 0))
            sigs = [src.sign_decorated(h)]
            if i == extra_at:
                sigs.append(key().sign_decorated(h))
        elif kind == "multisig":
            k1, k2 = key(), key()
            accounts[src.public_key.raw] = _account(src, seq, (1, 2, 2, 2), [
                _signer(T.SIGNER_KEY_TYPE_ED25519, k.public_key.raw, 1)
                for k in (k1, k2)])
            trio = [src, k1, k2]
            pick = sorted(rng.choice(3, 2, replace=False).tolist())
            sigs = [trio[j].sign_decorated(h) for j in pick]
            if i - single < short_multisig:
                sigs = sigs[:1]
        elif kind == "two_op":
            accounts[src.public_key.raw] = _account(src, seq, (1, 0, 0, 0))
            accounts[other.public_key.raw] = _account(other, seq,
                                                      (1, 0, 0, 0))
            sigs = [src.sign_decorated(h), other.sign_decorated(h)]
        else:
            payload_key, preimage = key(), rng.bytes(32)
            sp = xt.SignerKeyEd25519SignedPayload(
                ed25519=payload_key.public_key.raw, payload=h)
            sigs = [src.sign_decorated(h),
                    xtx.DecoratedSignature(
                        hint=su.signed_payload_hint(sp),
                        signature=payload_key.sign(h)),
                    su.sign_hash_x(preimage)]
            extras.append((src, seq, sp, sha256(preimage), h))
        built.append((tx, sigs))
    # each pre-auth-tx signer names the next special transaction's hash
    for j, (src, sq, sp, hx, _h) in enumerate(extras):
        other = extras[(j + 1) % len(extras)][4]
        accounts[src.public_key.raw] = _account(src, sq, (1, 3, 3, 3), [
            _signer(T.SIGNER_KEY_TYPE_PRE_AUTH_TX, other, 1),
            _signer(T.SIGNER_KEY_TYPE_HASH_X, hx, 1),
            _signer(T.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD, sp, 1)])
    envs = []
    for tx, sigs in built:
        out = []
        for d in sigs:
            if len(d.signature) == 64 and rng.random() < corrupt:
                k = int(rng.integers(0, 64))
                sig = bytearray(d.signature)
                sig[k] ^= 1 << int(rng.integers(0, 8))
                d = xtx.DecoratedSignature(hint=d.hint,
                                           signature=bytes(sig))
            out.append(d)
        envs.append(to_bytes(xtx.TransactionEnvelope, xtx.TransactionEnvelope
                             .make(xt.EnvelopeType.ENVELOPE_TYPE_TX,
                                   xtx.TransactionV1Envelope(
                                       tx=tx, signatures=out))))
    order = rng.permutation(len(envs))
    return [envs[j] for j in order], accounts


def _account_ids(tx) -> list:
    """The transaction's source, then each distinct operation source."""
    ids = [xtx.muxed_ed25519(tx.sourceAccount)]
    for op in tx.operations:
        if op.sourceAccount is not None:
            raw = xtx.muxed_ed25519(op.sourceAccount)
            if raw not in ids:
                ids.append(raw)
    return ids


def _extra_signers(tx) -> list:
    c = tx.cond
    return list(c.value.extraSigners) \
        if c.arm == xtx.PreconditionType.PRECOND_V2 else []


def collect_candidates(envs, accounts, hashes) -> list:
    """Every (pk, msg, sig) triple the node may verify for these decoded
    v1 envelopes (``TransactionEnvelope`` values), ``hashes`` their
    contents hashes: for each signature, the master key and signers of
    the transaction's source and of each operation source, then the
    extra signers, kept where the hint matches.

    This follows the JAX package's ``herder/tx_set.py:658-723``
    (``collect_signature_triples``, ``_collect_for_account``,
    ``_collect_for_signer_key``) line for line, over the port's
    ``signature_utils``, with the account table in place of the ledger.
    It gives way to the ported ``herder/tx_set.py``."""
    items = []
    for env, h in zip(envs, hashes):
        if env.arm != xt.EnvelopeType.ENVELOPE_TYPE_TX:
            raise ValueError("only v1 envelopes are collected")
        tx = env.value.tx
        accts = [accounts.get(raw) for raw in _account_ids(tx)]
        for sig in env.value.signatures:
            for acc in accts:
                _collect_for_account(acc, h, sig, items)
            for sk in _extra_signers(tx):
                _collect_for_signer_key(sk, h, sig, items)
    return items


def _collect_for_account(acc, h: bytes, sig, items):
    if acc is None:
        return
    pk = acc.accountID.value
    if su.does_hint_match(pk, sig.hint):
        items.append((pk, h, sig.signature))
    for s in acc.signers:
        _collect_for_signer_key(s.key, h, sig, items)


def _collect_for_signer_key(key, h: bytes, sig, items):
    if key.arm == xt.SignerKeyType.SIGNER_KEY_TYPE_ED25519:
        if su.does_hint_match(key.value, sig.hint):
            items.append((key.value, h, sig.signature))
    elif key.arm == xt.SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD:
        if sig.hint == su.signed_payload_hint(key.value):
            items.append((key.value.ed25519, key.value.payload,
                          sig.signature))


def _signers_for(acc) -> list:
    """Master key (when its weight is not 0) and the account's signers,
    as ``TransactionFrame::checkSignature`` lists them."""
    signers = []
    if acc.thresholds[0]:
        signers.append(_signer(xt.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                               acc.accountID.value, acc.thresholds[0]))
    signers.extend(acc.signers)
    return signers


def check_transaction(env, accounts, h: bytes):
    """``(verdict, used)`` of a decoded v1 envelope against the account
    table: one checker over its signatures, the source account at its
    low threshold, then each operation's source at its medium threshold
    (payments and offers), then every signature used — the order of the
    JAX package's ``TransactionFrame`` (``check_signature_for_account``
    in ``common_valid``, then ``process_signatures``). A missing account
    fails. ``used`` is the checker's flags when it stopped."""
    tx = env.value.tx
    checker = SignatureChecker(NODE_PROTOCOL_VERSION, h,
                               env.value.signatures)
    src = accounts.get(xtx.muxed_ed25519(tx.sourceAccount))
    if src is None or not checker.check_signature(
            _signers_for(src), src.thresholds[xt.THRESHOLD_LOW]):
        return False, list(checker.used)
    for op in tx.operations:
        acc = src if op.sourceAccount is None else \
            accounts.get(xtx.muxed_ed25519(op.sourceAccount))
        if acc is None or not checker.check_signature(
                _signers_for(acc), acc.thresholds[xt.THRESHOLD_MED]):
            return False, list(checker.used)
    return checker.check_all_signatures_used(), list(checker.used)


def node_ledger(accounts,
                ledger_version: int = CURRENT_LEDGER_PROTOCOL_VERSION
                ) -> LedgerTxnRoot:
    """A ``LedgerTxnRoot`` whose store holds ``node_txset``'s account
    table (raw account key -> ``AccountEntry``), each ``seqNum`` one
    below the table's (``node_txset`` gives an account its transaction's
    sequence number), so that every transaction's sequence number is the
    next one. The header is the genesis ledger's (base fee 100, base
    reserve 100,000,000, close time 0) at ``ledger_version`` (by default
    the current protocol, so a TxSet carries the Soroban phase, parallel
    and empty), ledger 2, with ``NODE_MAX_TX_SET_SIZE``. The table is
    not changed."""
    root = LedgerTxnRoot()
    for acc in accounts.values():
        acc = xt.AccountEntry.copy(acc)
        acc.seqNum -= 1
        entry = xt.LedgerEntry(
            lastModifiedLedgerSeq=1,
            data=xt.LedgerEntry._types[1].make(xt.LedgerEntryType.ACCOUNT,
                                               acc),
            ext=xt.LedgerEntry._types[2].make(0))
        root.store.put(key_bytes(entry_to_key(entry)), entry)
    header = copy_header(root.header())
    header.ledgerVersion = ledger_version
    header.ledgerSeq = 2
    header.maxTxSetSize = NODE_MAX_TX_SET_SIZE
    root.set_header(header)
    return root


def _entry(entry_type, body) -> "xt.LedgerEntry":
    return xt.LedgerEntry(
        lastModifiedLedgerSeq=1,
        data=xt.LedgerEntry._types[1].make(entry_type, body),
        ext=xt.LedgerEntry._types[2].make(0))


def node_close_ledger(accounts, envelopes,
                      ledger_version: int = CURRENT_LEDGER_PROTOCOL_VERSION
                      ) -> LedgerTxnRoot:
    """:func:`node_ledger`'s root, plus what lets every operation of
    ``node_txset``'s ``envelopes`` (XDR bytes) succeed when the set is
    applied: an account for each payment's destination and for each
    offer's issuer (single-key, balance 10^10, as the table's), and for
    each offer a trustline of its source for the asset it buys,
    authorized, limit ``INT64_MAX`` (the source's ``numSubEntries``
    counts it). Each offer buys an asset of its own, so no two offers
    cross. ``accounts`` is not changed."""
    root = node_ledger(accounts, ledger_version=ledger_version)
    T = xt.LedgerEntryType
    store = root.store

    def entry_of(raw):
        return store.get(key_bytes(account_key(xt.account_id(raw))))

    def ensure_account(raw):
        if entry_of(raw) is None:
            acc = xt.AccountEntry(
                accountID=xt.account_id(raw), balance=10**10,
                seqNum=1 << 32, numSubEntries=0, inflationDest=None,
                flags=0, homeDomain=b"", thresholds=bytes((1, 0, 0, 0)),
                signers=[], ext=xt.AccountEntry._types[9].make(0))
            entry = _entry(T.ACCOUNT, acc)
            store.put(key_bytes(entry_to_key(entry)), entry)

    O = xtx.OperationType
    for raw_env in envelopes:
        tx = from_bytes(xtx.TransactionEnvelope, raw_env).value.tx
        for op in tx.operations:
            source = xtx.muxed_ed25519(op.sourceAccount
                                       if op.sourceAccount is not None
                                       else tx.sourceAccount)
            if op.body.arm == O.PAYMENT:
                ensure_account(xtx.muxed_ed25519(op.body.value.destination))
            elif op.body.arm == O.MANAGE_SELL_OFFER:
                buying = op.body.value.buying
                ensure_account(buying.value.issuer.value)
                line = _entry(T.TRUSTLINE, xt.TrustLineEntry(
                    accountID=xt.account_id(source),
                    asset=xt.TrustLineAsset.make(buying.arm, buying.value),
                    balance=0, limit=INT64_MAX, flags=xt.AUTHORIZED_FLAG,
                    ext=xt.TrustLineEntry._types[5].make(0)))
                store.put(key_bytes(entry_to_key(line)), line)
                seller = entry_of(source)
                seller.data.value.numSubEntries += 1
                store.put(key_bytes(entry_to_key(seller)), seller)
    return root


# ---------------- a chain for catchup ----------------

CATCHUP_BALANCE = 1000 * 10_000_000   # 1,000 XLM an account
CATCHUP_EXPIRED_TAGS = (b"\x51", b"\x52")
# ledger 3's maxTxSetSize: room for a full ledger of 256 payments, so
# that nomination trims nothing
CATCHUP_MAX_TX_SET_SIZE = 1000


def catchup_plan(rng: np.random.Generator, senders: int = 256,
                 first_full: int = 64, last: int = 127,
                 extra: int = 1) -> dict:
    """The traffic of a chain from genesis (ledger 2) to ``last``, as
    plain data: ledger 3 carries :func:`catchup_upgrades`, ledgers 4 to
    ``first_full - 1`` are empty, and every ledger from ``first_full``
    to ``last + extra`` holds one payment from each sender, ``(sender,
    destination, sequence number, stroops)``, the k-th of a sender's
    payments at sequence number ``2^32 + k + 1``. Each full ledger draws
    a permutation of the destinations and the amounts (1 to 10^7
    stroops). The ledgers past ``last`` are closed after a catchup, not
    published."""
    names = [f"catchup-sender-{i}" for i in range(senders)]
    dests = [f"catchup-dest-{i}" for i in range(senders)]
    payments = {}
    for k, ledger in enumerate(range(first_full, last + extra + 1)):
        order = rng.permutation(senders)
        amounts = rng.integers(1, 10**7, senders, endpoint=True)
        payments[ledger] = [(names[i], dests[int(order[i])],
                             (1 << 32) + k + 1, int(amounts[i]))
                            for i in range(senders)]
    return {"senders": names, "destinations": dests, "payments": payments,
            "last": last}


def catchup_close_time(ledger: int) -> int:
    """Five seconds a ledger from genesis' 1,000."""
    return 1000 + 5 * (ledger - 2)


def _expired_entries():
    """Two persistent contract-data entries and their TTL entries, live
    until ledger 2: once ledger 3 upgrades to state archival, the
    eviction scan moves them into the hot archive."""
    from stellar_tpu_torch.soroban.host import (contract_data_key,
                                                scaddress_contract,
                                                ttl_key_for)
    from stellar_tpu_torch.xdr.contract import (ContractDataDurability,
                                                ContractDataEntry, SCVal,
                                                SCValType)
    out = []
    for tag in CATCHUP_EXPIRED_TAGS:
        addr = scaddress_contract(tag * 32)
        key = SCVal.make(SCValType.SCV_SYMBOL, b"k")
        data = ContractDataEntry(
            ext=xt.ExtensionPoint.make(0), contract=addr, key=key,
            durability=ContractDataDurability.PERSISTENT,
            val=SCVal.make(SCValType.SCV_U32, tag[0]))
        lk = contract_data_key(addr, key, ContractDataDurability.PERSISTENT)
        ttl = xt.TTLEntry(keyHash=ttl_key_for(lk).value.keyHash,
                          liveUntilLedgerSeq=2)
        for entry_type, body in ((xt.LedgerEntryType.CONTRACT_DATA, data),
                                 (xt.LedgerEntryType.TTL, ttl)):
            out.append(xt.LedgerEntry(
                lastModifiedLedgerSeq=2,
                data=xt.LedgerEntry._types[1].make(entry_type, body),
                ext=xt.LedgerEntry._types[2].make(0)))
    return out


def catchup_root(plan: dict) -> LedgerTxnRoot:
    """The chain's genesis, ledger 2 at close time 1,000: every sender
    and destination a single-key account of ``CATCHUP_BALANCE`` at
    sequence number 2^32, and :func:`_expired_entries`, under the
    protocol before state archival's."""
    from stellar_tpu_torch.bucket.hot_archive import (
        STATE_ARCHIVAL_PROTOCOL_VERSION)
    from stellar_tpu_torch.tx.tx_test_utils import (keypair,
                                                    seed_root_with_accounts)
    root = seed_root_with_accounts(
        [(keypair(n), CATCHUP_BALANCE)
         for n in plan["senders"] + plan["destinations"]])
    for entry in _expired_entries():
        root.store.put(key_bytes(entry_to_key(entry)), entry)
    header = copy_header(root.header())
    header.ledgerVersion = STATE_ARCHIVAL_PROTOCOL_VERSION - 1
    root.set_header(header)
    return root


def catchup_upgrades() -> list:
    """Ledger 3's upgrades as XDR blobs: state archival's protocol, then
    ``maxTxSetSize`` raised to ``CATCHUP_MAX_TX_SET_SIZE`` (the genesis
    header allows 100 operations, and nomination would drop the rest)."""
    from stellar_tpu_torch.bucket.hot_archive import (
        STATE_ARCHIVAL_PROTOCOL_VERSION)
    from stellar_tpu_torch.xdr.ledger import LedgerUpgrade, LedgerUpgradeType
    return [to_bytes(LedgerUpgrade, LedgerUpgrade.make(arm, value))
            for arm, value in (
                (LedgerUpgradeType.LEDGER_UPGRADE_VERSION,
                 STATE_ARCHIVAL_PROTOCOL_VERSION),
                (LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE,
                 CATCHUP_MAX_TX_SET_SIZE))]


_KEYPAIRS: dict = {}


def _named(name: str) -> SecretKey:
    from stellar_tpu_torch.tx.tx_test_utils import keypair
    if name not in _KEYPAIRS:
        _KEYPAIRS[name] = keypair(name)
    return _KEYPAIRS[name]


def _sign_payments(job) -> list:
    """One chunk of payments, signed: ``job`` is ``(network id, rows)``."""
    from stellar_tpu_torch.tx.tx_test_utils import make_tx, payment_op
    network_id, rows = job
    return [to_bytes(xtx.TransactionEnvelope, make_tx(
        _named(sender), seq, [payment_op(_named(dest), amount)],
        network_id=network_id).envelope)
        for sender, dest, seq, amount in rows]


def catchup_envelopes(plan: dict, ledgers, network_id: bytes,
                      workers: int = 1) -> dict:
    """``{ledger: [envelope XDR, ...]}`` for the plan's payments of
    ``ledgers`` (each payment signed by its sender), in sender order.
    With ``workers`` above 1 the signing runs on that many spawned
    processes; ed25519 signatures are deterministic, so the blobs do not
    depend on it."""
    rows = [(ledger, r) for ledger in ledgers
            for r in plan["payments"].get(ledger, ())]
    if workers <= 1:
        signed = _sign_payments((network_id, [r for _l, r in rows]))
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        step = max(1, -(-len(rows) // (4 * workers)))
        jobs = [(network_id, [r for _l, r in rows[i:i + step]])
                for i in range(0, len(rows), step)]
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            signed = [e for chunk in pool.map(_sign_payments, jobs)
                      for e in chunk]
    out = {}
    for (ledger, _r), env in zip(rows, signed):
        out.setdefault(ledger, []).append(env)
    return out


# ---------------- a flood over loopback ----------------

FLOOD_BALANCE = 1000 * 10_000_000     # 1,000 XLM an account
FLOOD_AMOUNT = 10_000_000             # 1 XLM a payment
FLOOD_DESTINATION = "flood-dest"


def flood_sources(n: int) -> list:
    """The names of the flood's ``n`` single-key sources."""
    return [f"flood-src-{i}" for i in range(n)]


def flood_accounts(n: int) -> list:
    """``(SecretKey, balance)`` of the flood's sources and destination,
    each funded with ``FLOOD_BALANCE`` (``Simulation.add_node``'s
    ``accounts``)."""
    return [(_named(name), FLOOD_BALANCE)
            for name in flood_sources(n) + [FLOOD_DESTINATION]]


def flood_envelopes(n: int, network_id: bytes) -> list:
    """One payment of ``FLOOD_AMOUNT`` to the destination from each of the
    ``n`` sources, its first transaction (sequence number 2^32 + 1 over
    ``seed_root_with_accounts``' 2^32), as signed envelope XDR blobs in
    source order."""
    return _sign_payments((network_id, [
        (name, FLOOD_DESTINATION, (1 << 32) + 1, FLOOD_AMOUNT)
        for name in flood_sources(n)]))


def core_network(n: int, threshold=None, accounts=None, mode=None,
                 **knobs):
    """``Topologies.core(n)``: ``n`` validators with keys
    ``SecretKey.from_seed_str("sim-node-i")``, one quorum set of all of
    them (threshold ``n - (n - 1) // 3`` unless given), fully connected
    over loopback, or over localhost sockets with ``mode``
    ``Simulation.OVER_TCP``. Each node is added through
    ``Simulation.add_node`` with a ``Config`` of its own: ``knobs`` set
    and ``QUORUM_INTERSECTION_CHECKER`` off, as ``Simulation.add_node``
    sets for its default. Returns the ``Simulation``."""
    from stellar_tpu_torch.main.config import Config
    from stellar_tpu_torch.scp.quorum import make_node_id
    from stellar_tpu_torch.simulation.simulation import Simulation
    from stellar_tpu_torch.xdr.scp import SCPQuorumSet
    sim = Simulation(mode=mode or Simulation.OVER_LOOPBACK)
    node_keys = [SecretKey.from_seed_str(f"sim-node-{i}") for i in range(n)]
    qset = SCPQuorumSet(
        threshold=threshold if threshold is not None else n - (n - 1) // 3,
        validators=[make_node_id(k.public_key.raw) for k in node_keys],
        innerSets=[])
    for k in node_keys:
        cfg = Config()
        cfg.QUORUM_INTERSECTION_CHECKER = False
        for name, value in knobs.items():
            setattr(cfg, name, value)
        sim.add_node(k, qset, accounts=accounts, config=cfg)
    ids = [k.public_key.raw for k in node_keys]
    for i in range(n):
        for j in range(i + 1, n):
            sim.add_connection(ids[i], ids[j])
    return sim


def statement_digest(apps, slot=None) -> str:
    """SHA-256 (hex) over the sorted XDR bytes of every distinct
    statement in the nodes' ``statements_history``, of one slot or of
    all."""
    from stellar_tpu_torch.xdr.scp import SCPStatement
    blobs = set()
    for app in apps:
        for index, s in app.herder.scp.known_slots.items():
            if slot is None or index == slot:
                blobs |= {to_bytes(SCPStatement, st)
                          for st, _validated in s.statements_history}
    return sha256(b"".join(sorted(blobs))).hex()


# ---------------- Soroban: a tampered auth entry ----------------

SOROBAN_TAMPER_TXS = 10
SOROBAN_TAMPER_FLIPPED = 3            # the invocation whose auth is bad
SOROBAN_TAMPER_BALANCE = 10**13
SOROBAN_TAMPER_EXPIRY = 1000          # the auth entries' last ledger


def _tamper_sources() -> list:
    return [_named(f"sb-tamper-src-{i}") for i in range(SOROBAN_TAMPER_TXS)]


def soroban_tamper_accounts() -> list:
    """``(SecretKey, balance)`` of the invocations' sources (source 0
    deploys the contract) and of the auth entries' signer
    (``seed_root_with_accounts``' accounts)."""
    return [(k, SOROBAN_TAMPER_BALANCE)
            for k in _tamper_sources() + [_named("sb-tamper-auth")]]


def soroban_tamper_config(cfg):
    """``cfg`` (a ``SorobanNetworkConfig`` of either package) with
    ``soroban_apply_load``'s raised caps and no footprint shaping: a
    thousand transactions a ledger, ten entries read and eight written a
    transaction, two events and two million instructions."""
    import dataclasses
    return dataclasses.replace(
        cfg, ledger_max_tx_count=max(1000, SOROBAN_TAMPER_TXS),
        tx_max_read_ledger_entries=max(cfg.tx_max_read_ledger_entries, 10),
        tx_max_write_ledger_entries=max(cfg.tx_max_write_ledger_entries, 8),
        tx_max_contract_events_size_bytes=max(
            cfg.tx_max_contract_events_size_bytes, 2 * 128),
        tx_max_instructions=max(cfg.tx_max_instructions, 2_000_000))


def soroban_tamper_envelopes(network_id: bytes,
                             flipped: int = SOROBAN_TAMPER_FLIPPED):
    """Three ledgers of envelope XDR blobs over
    ``seed_root_with_accounts(soroban_tamper_accounts())`` at the current
    protocol, built with ``simulation.load_generator``'s own helpers:
    the counter contract's upload and its creation by source 0, each
    alone in a ledger, then ``SOROBAN_TAMPER_TXS`` invocations of its
    ``auth_incr``, one a source, each carrying one auth entry that the
    signer signs for its own nonce. Invocation ``flipped``'s auth
    signature has byte 7 flipped. Returns the three lists and that
    entry's ``(pk, payload, sig)`` triple."""
    from stellar_tpu_torch.simulation.load_generator import (
        _deploy_frames, _soroban_data, _soroban_op,
    )
    from stellar_tpu_torch.soroban.example_contracts import counter_wasm
    from stellar_tpu_torch.soroban.host import (
        auth_payload_hash, contract_code_key, contract_data_key,
        scaddress_account, scaddress_contract, sym,
    )
    from stellar_tpu_torch.tx.tx_test_utils import make_tx
    from stellar_tpu_torch.xdr.contract import (
        ContractDataDurability, HostFunction, HostFunctionType,
        InvokeContractArgs, SCMapEntry, SCNonceKey, SCVal, SCValType,
        SorobanAddressCredentials, SorobanAuthorizationEntry,
        SorobanAuthorizedFunction, SorobanAuthorizedFunctionType,
        SorobanAuthorizedInvocation, SorobanCredentials,
        SorobanCredentialsType,
    )
    T = SCValType
    srcs, signer = _tamper_sources(), _named("sb-tamper-auth")
    start = 1 << 32   # seed_root_with_accounts' sequence numbers
    up, create, contract_id, code_hash, inst_key = _deploy_frames(
        srcs[0], start + 1, start + 2, counter_wasm(), network_id,
        salt=b"\x77" * 32)
    addr = scaddress_contract(contract_id)
    addr_signer = scaddress_account(xt.account_id(signer.public_key.raw))
    counter_key = contract_data_key(addr, sym("count"),
                                    ContractDataDurability.PERSISTENT)
    args = [SCVal.make(T.SCV_ADDRESS, addr_signer)]
    invokes, bad = [], None
    for i, src in enumerate(srcs):
        nonce = i + 1
        invocation = SorobanAuthorizedInvocation(
            function=SorobanAuthorizedFunction.make(
                SorobanAuthorizedFunctionType
                .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
                InvokeContractArgs(contractAddress=addr,
                                   functionName=b"auth_incr", args=args)),
            subInvocations=[])
        payload = auth_payload_hash(network_id, nonce,
                                    SOROBAN_TAMPER_EXPIRY, invocation)
        sig = bytearray(signer.sign(payload))
        if i == flipped:
            sig[7] ^= 0x20
            bad = (signer.public_key.raw, payload, bytes(sig))
        sig_val = SCVal.make(T.SCV_VEC, [SCVal.make(T.SCV_MAP, [
            SCMapEntry(key=sym("public_key"),
                       val=SCVal.make(T.SCV_BYTES, signer.public_key.raw)),
            SCMapEntry(key=sym("signature"),
                       val=SCVal.make(T.SCV_BYTES, bytes(sig)))])])
        auth = SorobanAuthorizationEntry(
            credentials=SorobanCredentials.make(
                SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS,
                SorobanAddressCredentials(
                    address=addr_signer, nonce=nonce,
                    signatureExpirationLedger=SOROBAN_TAMPER_EXPIRY,
                    signature=sig_val)),
            rootInvocation=invocation)
        nonce_key = contract_data_key(
            addr_signer, SCVal.make(T.SCV_LEDGER_KEY_NONCE,
                                    SCNonceKey(nonce=nonce)),
            ContractDataDurability.TEMPORARY)
        tx = make_tx(
            src, start + (3 if i == 0 else 1),
            [_soroban_op(HostFunction.make(
                HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                InvokeContractArgs(contractAddress=addr,
                                   functionName=b"auth_incr", args=args)),
                [auth])],
            fee=5_000_200,
            soroban_data=_soroban_data(
                read_only=[inst_key, contract_code_key(code_hash)],
                read_write=[counter_key, nonce_key]),
            network_id=network_id)
        invokes.append(to_bytes(xtx.TransactionEnvelope, tx.envelope))
    ledgers = [[to_bytes(xtx.TransactionEnvelope, up.envelope)],
               [to_bytes(xtx.TransactionEnvelope, create.envelope)],
               invokes]
    return ledgers, bad


# ---------------- a standalone node taking config 1 ----------------

# The reference's ``Application`` starts from an empty ledger: it has no
# genesis account. :func:`operator_genesis` gives a node's database one,
# the network root (``SecretKey.from_seed_str(passphrase)``, stellar-core's
# root key) holding every coin at ledger 2, and closes ledger 3, empty, at
# a fixed time; two databases so written hold the same chain, so one
# catches up (``catchup <ledger>/complete``) on what the other closed.
OPERATOR_ACCOUNTS = 100
OPERATOR_BALANCE = 10_000 * 10_000_000     # 10,000 XLM an account
OPERATOR_TOTAL_COINS = 100_000_000_000 * 10_000_000
OPERATOR_GENESIS_SEQ = 3                    # the genesis's one close
OPERATOR_MAX_TX_SET_SIZE = 1000
OPERATOR_CHECKPOINT = 63
# the two payment rounds: each account pays the one ``step`` places on,
# ``(i + 1) * unit`` stroops
OPERATOR_ROUNDS = ((1, 1_000_000), (37, 3_000_000))
# SHA-256 of the 101 accounts' ``strkey:balance:seqNum`` lines, sorted,
# after the three transaction ledgers: the reference's closes of
# :func:`operator_rounds` over :func:`operator_genesis`'s ledger
# (tests/test_torch_cli.py recomputes it with both packages)
OPERATOR_STATE_DIGEST = ("fa99a087b89503c2a1670df0ef622e36"
                         "f4ff2e7a520375062eec27c52f5f8e41")


def operator_names(n: int = OPERATOR_ACCOUNTS) -> list:
    """The names of the ``n`` accounts the root creates (each account's
    key is ``SecretKey.from_seed_str(name)``, as the ``testacc`` route
    finds it)."""
    return [f"operator-{i}" for i in range(n)]


def operator_genesis(database: str, bucket_dir: str, passphrase: str,
                     protocol: int = CURRENT_LEDGER_PROTOCOL_VERSION):
    """Writes the genesis into a fresh database and bucket directory:
    the network root's account at ledger 2 and one empty close, ledger
    3, at ``seed_root_with_accounts``' time plus 5. Returns the ledger's
    sequence number and header hash (hex)."""
    from stellar_tpu_torch.bucket.bucket_manager import BucketManager
    from stellar_tpu_torch.database import Database, NodePersistence
    from stellar_tpu_torch.herder.tx_set import make_tx_set_from_transactions
    from stellar_tpu_torch.ledger.ledger_manager import (LedgerCloseData,
                                                         LedgerManager)
    from stellar_tpu_torch.tx.tx_test_utils import seed_root_with_accounts
    db = Database(database)
    try:
        root = seed_root_with_accounts(
            [(SecretKey.from_seed_str(passphrase), OPERATOR_TOTAL_COINS)])
        header = root.header()
        header.ledgerVersion = protocol
        header.maxTxSetSize = OPERATOR_MAX_TX_SET_SIZE
        lm = LedgerManager(sha256(passphrase.encode()), root,
                           persistence=NodePersistence(
                               db, BucketManager(bucket_dir)))
        lcl = lm.last_closed_header
        tx_set, _ = make_tx_set_from_transactions([], lcl,
                                                  lm.last_closed_hash)
        lm.close_ledger(LedgerCloseData(
            ledger_seq=lcl.ledgerSeq + 1, tx_set=tx_set,
            close_time=lcl.scpValue.closeTime + 5))
        return lm.ledger_seq, lm.last_closed_hash.hex()
    finally:
        db.close()


def operator_rounds(passphrase: str, n: int = OPERATOR_ACCOUNTS) -> list:
    """The transaction frames a node over :func:`operator_genesis` takes,
    a ledger each: the root's one transaction creating the ``n``
    accounts with ``OPERATOR_BALANCE`` each (ledger 4), then for each of
    ``OPERATOR_ROUNDS`` one payment from every account (ledgers 5 and 6;
    an account's sequence numbers start at 4 << 32)."""
    from stellar_tpu_torch.tx.tx_test_utils import (create_account_op,
                                                    make_tx, payment_op)
    network_id = sha256(passphrase.encode())
    root = SecretKey.from_seed_str(passphrase)
    keys = [_named(name) for name in operator_names(n)]
    out = [[make_tx(root, (1 << 32) + 1,
                    [create_account_op(k, OPERATOR_BALANCE) for k in keys],
                    network_id=network_id)]]
    base = (OPERATOR_GENESIS_SEQ + 1) << 32
    for r, (step, unit) in enumerate(OPERATOR_ROUNDS, start=1):
        out.append([make_tx(k, base + r,
                            [payment_op(keys[(i + step) % n],
                                        (i + 1) * unit)],
                            network_id=network_id)
                    for i, k in enumerate(keys)])
    return out


def operator_state_digest(accounts) -> str:
    """SHA-256 (hex) of ``strkey:balance:seqNum`` lines, sorted, one for
    each ``(strkey, balance, seq_num)`` of ``accounts``."""
    lines = sorted(f"{k}:{b}:{q}" for k, b, q in accounts)
    return sha256("\n".join(lines).encode()).hex()
