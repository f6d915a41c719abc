"""The port's load generator (``simulation/load_generator.py``, a copy
held by ``test_torch_soroban.py``) against the reference's.

Each harness runs in both packages with the harness's ``LedgerManager``
recording every close (``_torch_port.harness_closes``): the return
dicts less their timings, the header hashes in close order and the
``LedgerCloseMeta`` bytes must be equal. ``BASELINE.json`` config 5
(``soroban_apply_load``) runs cut to one ledger of 10 transactions, on
the SCVal program and on the compiled counter (the port's native
engine); the classic harnesses ``apply_load``, ``multisig_apply_load``
and ``soroban_compute_load`` at a few transactions;
``LoadGenerator.generate_load`` on a one-validator simulation applies
the same payments. ``chip_smoke.py`` phase 25's pins at full width (3
ledgers of 500, and one of 500 on the compiled counter) are the
reference's: the setup closes' here, the rest in a ``slow`` test.

Both packages verify with their pure-Python oracles, so no JAX program
is compiled; the port hashes on the CPU.
"""

import importlib

import pytest

import stellar_tpu.tx.ops  # noqa: F401 (fills the registry)
import stellar_tpu_torch.tx.ops  # noqa: F401
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu_torch.crypto import batch_hasher as pbh
from stellar_tpu_torch.crypto import ed25519_ref as pref
from stellar_tpu_torch.crypto import keys as pkeys

from tests._torch_node import PORT_PACKAGE, Side, apps, authenticated
from tests._torch_port import chip_smoke_constants, harness_closes

REF_PACKAGE = "stellar_tpu"
_REAL_HASH_MANY = pbh.hash_many


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
    """Both packages verify with their oracles and flush their caches
    around each case; the port hashes on the CPU."""
    saved = (jkeys._backend, pkeys._backend)
    jkeys.set_verifier_backend(jref.verify)
    pkeys.set_verifier_backend(pref.verify)
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    monkeypatch.setattr(pbh, "hash_many", _cpu_hash_many)
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()


def _both(harness, **kwargs):
    return (harness_closes(PORT_PACKAGE, harness, **kwargs),
            harness_closes(REF_PACKAGE, harness, **kwargs))


@pytest.mark.parametrize("use_wasm", [False, True], ids=["scval", "wasm"])
def test_config5_small_equals_reference(use_wasm):
    """``soroban_apply_load(n_ledgers=1, txs_per_ledger=10)``: the two
    setup closes and the load close, 30 signatures, every transaction
    applied; the compiled counter runs on the port's native engine."""
    port, ref = _both("soroban_apply_load", n_ledgers=1, txs_per_ledger=10,
                      use_wasm=use_wasm)
    out, hashes, _meta = port
    assert out["total_applied"] == out["counter_value"] == 10
    assert out["engine"] == ("wasm-native" if use_wasm else "scval")
    assert len(hashes) == 3
    assert port == ref


def test_config5_setup_pins_are_the_reference():
    """Phase 25's setup closes (upload, create) do not depend on the
    load's size: the reference's here equal the pins' first two."""
    c = chip_smoke_constants()
    for use_wasm, pins in ((False, c["SOROBAN_CLOSE_HASHES"]),
                           (True, c["SOROBAN_WASM_CLOSE_HASHES"])):
        _out, hashes, _meta = harness_closes(
            REF_PACKAGE, "soroban_apply_load", n_ledgers=1,
            txs_per_ledger=2, use_wasm=use_wasm)
        assert tuple(hashes[:2]) == tuple(pins[:2])


@pytest.mark.parametrize("harness,kwargs", [
    ("apply_load", {"n_ledgers": 2, "txs_per_ledger": 10}),
    ("multisig_apply_load", {"n_ledgers": 1, "txs_per_ledger": 20}),
    ("soroban_compute_load", {"n_ledgers": 1, "txs_per_ledger": 5}),
    ("soroban_compute_load", {"n_ledgers": 1, "txs_per_ledger": 5,
                              "use_wasm": True}),
], ids=["apply", "multisig", "compute-scval", "compute-wasm"])
def test_harness_equals_reference(harness, kwargs):
    port, ref = _both(harness, **kwargs)
    assert port[0]["total_applied"] == \
        kwargs["n_ledgers"] * kwargs["txs_per_ledger"]
    assert port == ref


@pytest.mark.parametrize("mode", ["pay", "create", "pretend"])
def test_generate_load_on_one_validator_equals_reference(mode):
    """``LoadGenerator(app).generate_load(6, mode)`` through a lone
    validator's herder, cranked two ledgers on: the same submissions and
    the same header hashes in both packages."""
    got = {}
    for package in (PORT_PACKAGE, REF_PACKAGE):
        side = Side(package)
        lg = importlib.import_module(
            f"{package}.simulation.load_generator")
        accounts = [(side.tu.keypair(f"loadgen-{i}"), 10**13)
                    for i in range(16)]
        sim = side.network(1, accounts=accounts)
        sim.start_all_nodes()
        assert authenticated(sim)
        app = apps(sim)[0]
        gen = lg.LoadGenerator(app)
        before = app.lm.ledger_seq
        gen.generate_load(6, mode=mode)
        assert sim.crank_until_ledger(before + 2, timeout=120)
        got[package] = (gen.submitted, gen.rejected, gen.created,
                        dict(app.closes))
    assert got[PORT_PACKAGE][0] == 6 and len(got[PORT_PACKAGE][3]) >= 2
    assert got[PORT_PACKAGE] == got[REF_PACKAGE]


@pytest.mark.slow
def test_phase25_pins_are_the_reference():
    """``chip_smoke.py`` phase 25's pins recomputed from the reference at
    full width: config 5's 3 ledgers of 500 on the SCVal program and one
    of 500 on the compiled counter (about 20 s)."""
    c = chip_smoke_constants()
    for use_wasm, ledgers, pins, meta_pin in (
            (False, c["SOROBAN_LEDGERS"], c["SOROBAN_CLOSE_HASHES"],
             c["SOROBAN_META_HASH"]),
            (True, c["SOROBAN_WASM_LEDGERS"], c["SOROBAN_WASM_CLOSE_HASHES"],
             c["SOROBAN_WASM_META_HASH"])):
        out, hashes, meta = harness_closes(
            REF_PACKAGE, "soroban_apply_load", n_ledgers=ledgers,
            txs_per_ledger=c["SOROBAN_TXS"], use_wasm=use_wasm)
        assert out["total_applied"] == ledgers * c["SOROBAN_TXS"]
        assert (tuple(hashes), meta) == (tuple(pins), meta_pin)
