"""The port's ``SignatureChecker`` (``stellar_tpu_torch.tx``) against the
reference's (``stellar_tpu.tx``), and a miniature of ``chip_smoke.py``
phase 20 (the node's transactions) on the CPU.

The same signatures and signer lists go through both checkers: the
reference's with its pure-Python oracle as the verify backend, the
port's with a CPU ``BatchVerifier`` at bucket 16 installed and every
candidate prefetched through ``batch_verify_into_cache``, so that each
of the port checker's ed25519 checks is a cache hit. Verdicts and
``used`` flags must be equal.
"""

import numpy as np
import pytest

from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.herder import tx_set as jtx_set
from stellar_tpu.tx import signature_checker as jsc
from stellar_tpu.tx.transaction_frame import TransactionFrame
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_hasher import hash_many
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier
from stellar_tpu_torch.crypto.sha import sha256
from stellar_tpu_torch.parallel import signer_tables
from stellar_tpu_torch.tx import signature_checker as psc
from stellar_tpu_torch.tx import signature_utils as psu
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx
from stellar_tpu_torch.xdr import types as ptypes

T = ptypes.SignerKeyType


@pytest.fixture(autouse=True)
def clean_caches():
    saved = (jkeys._backend, pkeys._backend)
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()


def _signer(arm, value, weight):
    return ptypes.Signer(key=ptypes.SignerKey.make(arm, value),
                         weight=weight)


def _key(rng):
    return pkeys.SecretKey(rng.bytes(32))


def _flip(d):
    sig = bytearray(d.signature)
    sig[40] ^= 4
    return ptx.DecoratedSignature(hint=d.hint, signature=bytes(sig))


def _cases():
    """name -> (contents hash, signatures, signer list, needed weight),
    port values."""
    rng = np.random.default_rng(1220)
    h = rng.bytes(32)
    a, b, c = _key(rng), _key(rng), _key(rng)
    ed = {k: _signer(T.SIGNER_KEY_TYPE_ED25519, k.public_key.raw, 1)
          for k in (a, b, c)}
    sa, sb, sc = (k.sign_decorated(h) for k in (a, b, c))
    pre = rng.bytes(32)
    hx = _signer(T.SIGNER_KEY_TYPE_HASH_X, sha256(pre), 1)
    payload = rng.bytes(29)
    sp = ptypes.SignerKeyEd25519SignedPayload(ed25519=c.public_key.raw,
                                              payload=payload)
    sps = _signer(T.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD, sp, 1)
    sp_sig = ptx.DecoratedSignature(hint=psu.signed_payload_hint(sp),
                                    signature=c.sign(payload))
    heavy = _signer(T.SIGNER_KEY_TYPE_ED25519, a.public_key.raw, 300)
    # a key that shares a's hint but is not a's
    twin = _signer(T.SIGNER_KEY_TYPE_ED25519,
                   rng.bytes(28) + a.public_key.raw[-4:], 1)
    preauth = _signer(T.SIGNER_KEY_TYPE_PRE_AUTH_TX, h, 1)
    other_preauth = _signer(T.SIGNER_KEY_TYPE_PRE_AUTH_TX, rng.bytes(32), 1)
    return {
        "one key": (h, [sa], [ed[a]], 1),
        "no signature": (h, [], [ed[a]], 1),
        "two of three": (h, [sa, sc], list(ed.values()), 2),
        "two of three, one bad": (h, [_flip(sa), sc], list(ed.values()), 2),
        "bad then good": (h, [_flip(sb), sb, sa], [ed[a], ed[b]], 2),
        "wrong message": (rng.bytes(32), [sa], [ed[a]], 1),
        "needed 0 still needs a signer": (h, [sa], [ed[a]], 0),
        "pre-auth alone": (h, [], [preauth], 1),
        "pre-auth beside a signature": (h, [sa], [preauth, ed[a]], 1),
        "pre-auth of another tx": (h, [sa], [other_preauth, ed[a]], 2),
        "hashX": (h, [psu.sign_hash_x(pre)], [hx], 1),
        "hashX wrong preimage": (h, [psu.sign_hash_x(pre + b"!")], [hx], 1),
        "hashX then ed25519": (h, [sa, psu.sign_hash_x(pre)],
                               [ed[a], hx], 2),
        "signed payload": (h, [sp_sig], [sps], 1),
        "signed payload bad": (h, [_flip(sp_sig)], [sps], 1),
        "signed payload beside its key": (h, [sc, sp_sig],
                                          [sps, ed[c]], 2),
        "every kind": (h, [sb, sp_sig, psu.sign_hash_x(pre)],
                       [other_preauth, hx, ed[b], sps], 3),
        "weight 300 clamped, needed 256": (h, [sa], [heavy], 256),
        "weight 300 clamped, needed 255": (h, [sa], [heavy], 255),
        "signer listed twice, one signature": (h, [sa], [ed[a], ed[a]], 2),
        "signer listed twice, signed twice": (h, [sa, sa],
                                              [ed[a], ed[a]], 2),
        "unused extra signature": (h, [sa, sb], [ed[a]], 1),
        "extra signature by a stranger": (
            h, [sa, _key(rng).sign_decorated(h)], [ed[a]], 1),
        "hint collision, twin first": (h, [sa], [twin, ed[a]], 1),
        "hint collision, twin only": (h, [sa], [twin], 1),
        "hint collision, both needed": (h, [sa], [twin, ed[a]], 2),
    }


def _to_ref(t_port, t_ref, v):
    return jrt.from_bytes(t_ref, prt.to_bytes(t_port, v))


def _candidates(h, sigs, signers) -> list:
    """Each (pk, msg, sig) the checker may verify: the node's collection
    over a signer list (``vectors.collect_candidates`` over accounts)."""
    acc = ptypes.AccountEntry(
        accountID=ptypes.account_id(bytes(32)), balance=0, seqNum=0,
        numSubEntries=0, inflationDest=None, flags=0, homeDomain=b"",
        thresholds=bytes(4), signers=signers,
        ext=ptypes.AccountEntry._types[9].make(0))
    tx = ptx.Transaction(
        sourceAccount=ptx.muxed_account(bytes(32)), fee=100, seqNum=1,
        cond=ptx.Preconditions.make(ptx.PreconditionType.PRECOND_NONE),
        memo=ptx.MEMO_NONE, operations=[],
        ext=ptx.Transaction._types[6].make(0))
    env = ptx.TransactionEnvelope.make(
        ptypes.EnvelopeType.ENVELOPE_TYPE_TX,
        ptx.TransactionV1Envelope(tx=tx, signatures=sigs))
    return vectors.collect_candidates([env], {bytes(32): acc}, [h])


def _run(checker_mod, h, sigs, signers, needed):
    c = checker_mod.SignatureChecker(21, h, sigs)
    ok = c.check_signature(signers, needed)
    return ok, c.check_all_signatures_used(), list(c.used)


def test_checker_equals_reference():
    cases = _cases()
    verifier = BatchVerifier(device="cpu", bucket_sizes=(16,))
    verifier.install()
    items = [it for h, sigs, signers, _ in cases.values()
             for it in _candidates(h, sigs, signers)]
    assert len(items) >= pkeys.MIN_DEVICE_BATCH
    pkeys.batch_verify_into_cache(items)
    assert verifier.served["device"] > 0
    stats = pkeys.get_verify_cache_stats()
    jkeys.set_verifier_backend(jref.verify)
    got = {}
    for name, (h, sigs, signers, needed) in cases.items():
        port = _run(psc, h, sigs, signers, needed)
        jsigs = [_to_ref(ptx.DecoratedSignature, jtx.DecoratedSignature, d)
                 for d in sigs]
        jsigners = [_to_ref(ptypes.Signer, jtypes.Signer, s)
                    for s in signers]
        ref = _run(jsc, h, jsigs, jsigners, needed)
        assert port == ref, name
        got[name] = port
    assert pkeys.get_verify_cache_stats()["misses"] == stats["misses"]
    assert got["two of three"] == (True, True, [True, True])
    assert got["two of three, one bad"][0] is False
    assert got["pre-auth alone"] == (True, True, [])
    assert got["pre-auth beside a signature"] == (True, False, [False])
    assert got["hashX"] == (True, True, [True])
    assert got["signed payload"] == (True, True, [True])
    assert got["every kind"] == (True, True, [True, True, True])
    assert got["weight 300 clamped, needed 256"][0] is False
    assert got["weight 300 clamped, needed 255"][0] is True
    assert got["signer listed twice, one signature"][0] is False
    assert got["signer listed twice, signed twice"][0] is True
    assert got["unused extra signature"] == (True, False, [True, False])
    assert got["hint collision, twin first"] == (True, True, [True])
    assert got["hint collision, twin only"][0] is False


def test_always_valid_checker_equals_reference():
    rng = np.random.default_rng(1221)
    h = rng.bytes(32)
    sig = _key(rng).sign_decorated(h)
    for mod in (psc, jsc):
        c = mod.AlwaysValidSignatureChecker(21, h, [sig])
        assert c.check_signature([], 5) and c.check_all_signatures_used()
    assert psc.__all__ == jsc.__all__
    assert psc.UINT8_MAX == jsc.UINT8_MAX == 255


def _reference_verdict(env, accounts, h):
    """The reference's ``TransactionFrame.check_signature_for_account``
    over the source at its low threshold, then each operation's source
    at its medium threshold, then every signature used."""
    check = TransactionFrame.check_signature_for_account
    tx = env.value.tx
    c = jsc.SignatureChecker(21, h, env.value.signatures)
    src = accounts[jtx.muxed_ed25519(tx.sourceAccount)]
    if not check(None, c, src, src.thresholds[jtypes.THRESHOLD_LOW]):
        return False, list(c.used)
    for op in tx.operations:
        acc = src if op.sourceAccount is None else \
            accounts[jtx.muxed_ed25519(op.sourceAccount)]
        if not check(None, c, acc, acc.thresholds[jtypes.THRESHOLD_MED]):
            return False, list(c.used)
    return c.check_all_signatures_used(), list(c.used)


def test_node_txset_miniature_equals_reference():
    """Phase 20 at 40 transactions on the CPU, port against reference,
    verdict for verdict: decode, contents hashes through ``hash_many``
    (the plain K3 on the CPU), the candidates, one prefetch through a CPU
    verifier, then the checker on every transaction with no cache
    miss."""
    rng = np.random.default_rng(1222)
    envs, accounts = vectors.node_txset(
        rng, single=5, multisig=22, two_op=8, special=5, corrupt=0.06,
        short_multisig=2)
    assert len(envs) == 40
    nid = vectors.NODE_NETWORK_ID
    signer_tables.signer_table_cache.configure(enabled=False)
    try:
        verifier = BatchVerifier(device="cpu", bucket_sizes=(16,))
        verifier.install()
        dec = [prt.from_bytes(ptx.TransactionEnvelope, e) for e in envs]
        payloads = [ptx.transaction_sig_payload(nid, d.value.tx)
                    for d in dec]
        hashes = hash_many(payloads, device="cpu")
        items = vectors.collect_candidates(dec, accounts, hashes)
        pkeys.batch_verify_into_cache(items)
        stats = pkeys.get_verify_cache_stats()
        port = [vectors.check_transaction(d, accounts, h)
                for d, h in zip(dec, hashes)]
        assert pkeys.get_verify_cache_stats()["misses"] == stats["misses"]
        assert 0 < verifier.served["device"] <= len(items)
        assert verifier.served["hot"] == 0
    finally:
        signer_tables.signer_table_cache.configure(
            enabled=signer_tables.ENABLED)
    jdec = [jrt.from_bytes(jtx.TransactionEnvelope, e) for e in envs]
    jhashes = [jtx.transaction_hash(nid, d.value.tx) for d in jdec]
    assert hashes == jhashes
    jaccounts = {k: _to_ref(ptypes.AccountEntry, jtypes.AccountEntry, a)
                 for k, a in accounts.items()}
    jitems = []
    for d, h in zip(jdec, jhashes):
        tx = d.value.tx
        ids = [jtx.muxed_ed25519(tx.sourceAccount)]
        for op in tx.operations:
            if op.sourceAccount is not None and \
                    jtx.muxed_ed25519(op.sourceAccount) not in ids:
                ids.append(jtx.muxed_ed25519(op.sourceAccount))
        for sig in d.value.signatures:
            for raw in ids:
                jtx_set._collect_for_account(jaccounts[raw], h, sig, jitems)
    assert items == jitems
    jkeys.set_verifier_backend(jref.verify)
    jkeys.batch_verify_into_cache(jitems)
    ref = [_reference_verdict(d, jaccounts, h)
           for d, h in zip(jdec, jhashes)]
    assert port == ref
    verdicts = [ok for ok, _ in port]
    assert 0 < verdicts.count(False) < 40
    assert any(ok is False and all(used) is False for ok, used in port)
