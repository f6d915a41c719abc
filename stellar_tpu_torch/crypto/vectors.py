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
  header the set's transactions validate against.
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
from stellar_tpu_torch.tx import signature_utils as su
from stellar_tpu_torch.tx.signature_checker import SignatureChecker
from stellar_tpu_torch.xdr import tx as xtx
from stellar_tpu_torch.xdr import types as xt
from stellar_tpu_torch.xdr.runtime import to_bytes

__all__ = ["keypair", "valid_items", "edge_corpus", "matching_rows",
           "random_rows", "hot_matching_rows", "r16_matching_rows",
           "r16_overflow_rows", "R16_OVERFLOW", "NODE_NETWORK_ID",
           "node_txset", "collect_candidates", "check_transaction",
           "node_ledger", "NODE_MAX_TX_SET_SIZE"]

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
