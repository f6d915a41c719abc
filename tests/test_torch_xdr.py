"""The port's XDR (``stellar_tpu_torch.xdr``) against the reference's
(``stellar_tpu.xdr``).

Decode direction: every pinned vector of ``tests/xdr_fixtures.json``
(but the ``__raw__`` ones) decodes with the port's ``from_bytes`` and
re-encodes to the pinned bytes, its type looked up in the port's ``tx``,
``ledger``, ``scp`` and ``overlay`` as ``tests/test_xdr_fixtures.py``
does. Encode direction: the envelopes and accounts the port builds
(``vectors.node_txset``) decode with the reference's XDR and re-encode to
the same bytes, and both packages' contents hashes agree.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stellar_tpu.crypto.sha import sha256 as jsha256
from stellar_tpu.xdr import runtime as jrt
from stellar_tpu.xdr import tx as jtx
from stellar_tpu.xdr import types as jtypes
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.xdr import runtime as prt
from stellar_tpu_torch.xdr import tx as ptx
from stellar_tpu_torch.xdr import types as ptypes

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = json.loads((Path(__file__).parent / "xdr_fixtures.json")
                      .read_text())
DECODED = sorted(n for n, f in FIXTURES.items() if f["type"] != "__raw__")
MODULES = ["runtime", "types", "contract", "tx", "scp", "results",
           "ledger", "overlay"]


def _port_type(name: str):
    from stellar_tpu_torch.xdr import ledger, overlay, scp, tx
    for mod in (tx, ledger, scp, overlay):
        t = getattr(mod, name, None)
        if t is not None:
            return t
    raise KeyError(name)


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_and_reencodes_byte_exact(name):
    fx = FIXTURES[name]
    raw = bytes.fromhex(fx["hex"])
    t = _port_type(fx["type"])
    v = prt.from_bytes(t, raw)
    out = prt.to_bytes(t, v)
    assert out == raw
    assert jsha256(out).hex() == fx["sha256"]


def test_every_pinned_type_is_decoded():
    assert len(DECODED) == 10
    assert {FIXTURES[n]["type"] for n in DECODED} == {
        "GeneralizedTransactionSet", "LedgerCloseMeta", "LedgerHeader",
        "StellarMessage", "SCPEnvelope", "TransactionEnvelope"}


@pytest.mark.parametrize("module", MODULES)
def test_module_names_equal_reference(module):
    """Each port module defines the reference's public names."""
    import importlib
    import inspect
    ref = importlib.import_module(f"stellar_tpu.xdr.{module}")
    port = importlib.import_module(f"stellar_tpu_torch.xdr.{module}")

    def public(m):
        return {n for n, v in vars(m).items() if not n.startswith("_")
                and not inspect.ismodule(v)}
    assert len(public(port)) > 20
    assert public(port) == public(ref)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_first(module):
    """Each module imports on its own in a fresh interpreter, JAX and
    the JAX package blocked: the bottom-of-module and lazy imports keep
    the package free of import cycles."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        f"import stellar_tpu_torch.xdr.{module}",
        "from stellar_tpu_torch.xdr import overlay",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def txset():
    rng = np.random.default_rng(1201)
    return vectors.node_txset(rng, single=6, multisig=10, two_op=4,
                              special=4, corrupt=0.1, short_multisig=2)


def test_port_envelopes_reencode_through_reference(txset):
    envs, _ = txset
    assert len(envs) == 24
    for raw in envs:
        v = jrt.from_bytes(jtx.TransactionEnvelope, raw)
        assert jrt.to_bytes(jtx.TransactionEnvelope, v) == raw


def test_port_accounts_reencode_through_reference(txset):
    _, accounts = txset
    for raw_key, acc in accounts.items():
        b = prt.to_bytes(ptypes.AccountEntry, acc)
        v = jrt.from_bytes(jtypes.AccountEntry, b)
        assert v.accountID.value == raw_key
        assert jrt.to_bytes(jtypes.AccountEntry, v) == b


def test_contents_hashes_equal_reference(txset):
    """``transaction_hash`` and ``transaction_sig_payload`` of the port's
    decoded envelopes equal the reference's on its own decode."""
    envs, _ = txset
    nid = vectors.NODE_NETWORK_ID
    for raw in envs:
        p = prt.from_bytes(ptx.TransactionEnvelope, raw).value.tx
        j = jrt.from_bytes(jtx.TransactionEnvelope, raw).value.tx
        assert ptx.transaction_sig_payload(nid, p) == \
            jtx.transaction_sig_payload(nid, j)
        assert ptx.transaction_hash(nid, p) == jtx.transaction_hash(nid, j)


def test_feebump_hashes_equal_reference(txset):
    """Fee bumps the port wraps around the set's envelopes: the same
    bytes through the reference, and the same ``feebump_hash``."""
    envs, _ = txset
    nid = vectors.NODE_NETWORK_ID
    rng = np.random.default_rng(1202)
    for raw in envs[:8]:
        inner = prt.from_bytes(ptx.TransactionEnvelope, raw).value
        fb = ptx.FeeBumpTransaction(
            feeSource=ptx.muxed_account(rng.bytes(32)),
            fee=int(rng.integers(200, 10**6)),
            innerTx=ptx.FeeBumpTransaction._types[2].make(
                ptypes.EnvelopeType.ENVELOPE_TYPE_TX, inner),
            ext=ptx.FeeBumpTransaction._types[3].make(0))
        env = ptx.TransactionEnvelope.make(
            ptypes.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
            ptx.FeeBumpTransactionEnvelope(tx=fb, signatures=[]))
        b = prt.to_bytes(ptx.TransactionEnvelope, env)
        j = jrt.from_bytes(jtx.TransactionEnvelope, b)
        assert jrt.to_bytes(jtx.TransactionEnvelope, j) == b
        assert ptx.feebump_hash(nid, fb) == jtx.feebump_hash(nid, j.value.tx)
        assert ptx.feebump_sig_payload(nid, fb) == \
            jtx.feebump_sig_payload(nid, j.value.tx)


def test_malformed_input_raises_as_reference():
    """A truncated envelope and a bad union arm raise ``XdrError`` in
    both packages with the same message."""
    rng = np.random.default_rng(1203)
    envs, _ = vectors.node_txset(rng, single=1, multisig=0, two_op=0,
                                 special=0)
    bad = [envs[0][:-3], b"\x00\x00\x00\x09" + envs[0][4:]]
    for b in bad:
        with pytest.raises(prt.XdrError) as pe:
            prt.from_bytes(ptx.TransactionEnvelope, b)
        with pytest.raises(jrt.XdrError) as je:
            jrt.from_bytes(jtx.TransactionEnvelope, b)
        assert str(pe.value) == str(je.value)
