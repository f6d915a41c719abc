"""The port's fuzz harnesses (``stellar_tpu_torch.main.fuzz``) against the
reference's: the module is the reference's with the port's imports, but
for ``WasmFuzzer.__init__``, which reads no environment option for a
directory of foreign fixtures: its corpus is ``example_contracts``' two
modules. Each fuzzer of both packages, run from the same seed, gives the
same outcome summary: the transactions applied and rejected, and no
crash. Both packages
verify with their oracles; nothing runs on a card and no JAX program is
compiled."""

import importlib

import pytest

from stellar_tpu_torch.crypto import batch_hasher as pbh

from tests._torch_node import Side
from tests._torch_port import check_copy

PORT, REF = Side("stellar_tpu_torch"), Side("stellar_tpu")

_REAL_HASH_MANY = pbh.hash_many


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
    saved = (REF.keys._backend, PORT.keys._backend)
    REF.keys.set_verifier_backend(REF.ref.verify)
    PORT.keys.set_verifier_backend(PORT.ref.verify)
    monkeypatch.setattr(pbh, "hash_many", _cpu_hash_many)
    yield
    REF.keys.set_verifier_backend(saved[0])
    PORT.keys.set_verifier_backend(saved[1])
    for side in (PORT, REF):
        side.keys.flush_verify_cache()


def test_copy_equals_reference():
    check_copy("main/fuzz.py")


def _fuzz(side):
    return importlib.import_module(f"{side.package}.main.fuzz")


@pytest.mark.parametrize("mode,iterations,seed", [
    ("tx", 60, 1234), ("overlay", 60, 99), ("wasm", 120, 7)])
def test_fuzzers_equal_reference(mode, iterations, seed):
    """``run_fuzz`` of both packages from one seed: the same summary
    (iterations, crashes, and for the tx fuzzer the applied and rejected
    counts); the tx fuzzer both applies and rejects, and nothing
    crashes."""
    outs = []
    for side in (PORT, REF):
        side.keys.flush_verify_cache()
        outs.append(_fuzz(side).run_fuzz(mode, iterations, seed))
    port, ref = outs
    assert port == ref
    assert port["crashes"] == []
    if mode == "tx":
        assert port["applied"] > 0 and port["rejected"] > 0


def test_wasm_corpus_is_the_example_contracts():
    """The port's wasm fuzzer mutates ``example_contracts``' two modules,
    byte for byte the reference's, which are the reference's whole
    corpus wherever its fixtures' directory is missing."""
    ref = importlib.import_module("stellar_tpu.soroban.example_contracts")
    got = _fuzz(PORT).WasmFuzzer(0).base_modules
    assert got == [ref.counter_wasm(), ref.sum_wasm()]
