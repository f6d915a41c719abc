"""The port's Soroban slice against the reference's: the host's curves
(``crypto/keccak.py``, ``secp256.py``, ``h2c.py``, ``bls12_381.py``),
the host environment (``soroban/env.py`` and its interface, the legacy
ABI, the asset contract), the three Soroban operation frames
(``tx/ops/soroban_ops.py``, now whole) and the load generator.

The copies are held to the reference's source (``_torch_port.
check_copy``); ``soroban/native_wasm.py`` is a partial copy whose build
(``_LIB``, ``_ext_lib_path``, ``_build_lib``) is the port's own. The
curves give equal outputs on seeded inputs in both packages. The frames:
a restore after eviction (``RestoreFootprint``) and an extension
(``ExtendFootprintTTL``) of the restored entry over a state-archival
chain, and ``vectors.soroban_tamper_envelopes``' ten invocations with
one auth signature flipped, give equal header hashes, result pairs and
``LedgerCloseMeta`` bytes in both packages; ``chip_smoke.py``'s pinned
``SOROBAN_TAMPER_*`` constants are the reference's close of that set.

Both packages verify with their pure-Python oracles, so no JAX program
is compiled. Values cross between the packages only as bytes.
"""

import importlib

import numpy as np
import pytest

import stellar_tpu.tx.ops  # noqa: F401 (fills the registry)
import stellar_tpu_torch.tx.ops  # noqa: F401
from stellar_tpu import invariant as jinv
from stellar_tpu.crypto import bls12_381 as jbls
from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import h2c as jh2c
from stellar_tpu.crypto import keccak as jkeccak
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu.crypto import secp256 as jsecp
from stellar_tpu_torch import invariant as pinv
from stellar_tpu_torch.crypto import bls12_381 as pbls
from stellar_tpu_torch.crypto import ed25519_ref as pref
from stellar_tpu_torch.crypto import h2c as ph2c
from stellar_tpu_torch.crypto import keccak as pkeccak
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.crypto import secp256 as psecp
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.soroban import native_wasm as pnative

from tests._torch_port import (PARTIAL, REPLACED, ROOT, check_copy,
                               chip_smoke_constants)

MODULES = [
    "crypto/keccak.py", "crypto/secp256.py", "crypto/_h2c_constants.py",
    "crypto/h2c.py", "crypto/bls12_381.py", "soroban/wasm.py",
    "soroban/env_interface.py", "soroban/legacy_abi.py",
    "soroban/asset_contract.py", "soroban/env.py", "soroban/native_wasm.py",
    "soroban/wasm_builder.py", "soroban/example_contracts.py",
    "simulation/load_generator.py"]  # tx/ops/soroban_ops.py: in
# test_torch_tx_frame.py


@pytest.fixture(autouse=True)
def oracles():
    """Both packages verify with their pure-Python oracles, no invariant
    manager is active, and the caches are flushed around each case."""
    saved = (jkeys._backend, pkeys._backend)
    jkeys.set_verifier_backend(jref.verify)
    pkeys.set_verifier_backend(pref.verify)
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    jinv.set_active_manager(None)
    pinv.set_active_manager(None)


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


def test_native_wasm_is_the_one_partial_copy_of_the_slice():
    """``native_wasm.py`` defines its build anew (``REPLACED``): the
    port's libraries land in ``build/torch_native/``; the operation
    frames' module has no partial entry left."""
    assert PARTIAL["soroban/native_wasm.py"] == {
        "_LIB", "_ext_lib_path", "_build_lib"}
    assert "soroban/native_wasm.py" in REPLACED
    assert "tx/ops/soroban_ops.py" not in PARTIAL
    out = ROOT / "build" / "torch_native"
    assert pnative._LIB == str(out / "libwasmexec.so")
    assert pnative._ext_lib_path().startswith(str(out / "wasm_ext."))


# ---------------- the curves ----------------

@pytest.mark.parametrize("length", [0, 1, 55, 135, 136, 137, 300])
def test_keccak256_equals_reference(length):
    msg = np.random.default_rng(1700 + length).bytes(length)
    assert pkeccak.keccak256(msg) == jkeccak.keccak256(msg)


def _ecdsa_sign(curve, d: int, k: int, digest: bytes) -> bytes:
    """A low-S ECDSA signature ``r || s`` over ``digest`` with nonce
    ``k`` on ``curve`` (the port's curve arithmetic)."""
    n = curve.n
    r = curve.mul(k, curve.g)[0] % n
    s = pow(k, n - 2, n) * (int.from_bytes(digest, "big") + r * d) % n
    s = min(s, n - s)
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def _sec1(curve, d: int) -> bytes:
    x, y = curve.mul(d, curve.g)
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return type(e).__name__


@pytest.mark.parametrize("curve", ["SECP256K1", "SECP256R1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_secp256_verification_equals_reference(curve, seed):
    rng = np.random.default_rng(1710 + seed)
    pc, jc = getattr(psecp, curve), getattr(jsecp, curve)
    d = int.from_bytes(rng.bytes(32), "big") % pc.n
    k = int.from_bytes(rng.bytes(32), "big") % pc.n
    digest = rng.bytes(32)
    sig = _ecdsa_sign(pc, d, k, digest)
    pk = _sec1(pc, d)
    bad = bytearray(sig)
    bad[10] ^= 1
    high = sig[:32] + (pc.n - int.from_bytes(sig[32:], "big")).to_bytes(
        32, "big")
    for s in (sig, bytes(bad), high):
        assert _outcome(psecp.verify_ecdsa, pc, pk, digest, s) == \
            _outcome(jsecp.verify_ecdsa, jc, pk, digest, s)
    assert psecp.verify_ecdsa(pc, pk, digest, sig) is True
    if curve == "SECP256K1":
        got = [_outcome(psecp.recover_secp256k1, digest, sig, rid)
               for rid in range(4)]
        assert got == [_outcome(jsecp.recover_secp256k1, digest, sig, rid)
                       for rid in range(4)]
        assert pk in got


@pytest.mark.parametrize("seed", [0, 1])
def test_bls12_381_group_operations_equal_reference(seed):
    rng = np.random.default_rng(1720 + seed)
    a, b = (int.from_bytes(rng.bytes(8), "big") for _ in "ab")
    out = {}
    for name, m in (("port", pbls), ("ref", jbls)):
        p1, p2 = m.g1_mul(a, m.G1_GEN), m.g1_mul(b, m.G1_GEN)
        q1, q2 = m.g2_mul(a, m.G2_GEN), m.g2_mul(b, m.G2_GEN)
        out[name] = (
            m.g1_encode(m.g1_add(p1, p2)), m.g2_encode(m.g2_add(q1, q2)),
            m.g1_encode(m.g1_msm([(a, m.G1_GEN), (b, p1)])),
            m.g2_encode(m.g2_msm([(a, m.G2_GEN), (b, q1)])),
            m.fr_mul(a, b), m.fr_inv(a), m.fr_sub(a, b),
            m.g1_encode(m.g1_decode(m.g1_encode(p1))))
    assert out["port"] == out["ref"]


def test_bls12_381_pairing_check_equals_reference():
    """e(aG1, bG2) * e(-abG1, G2) == 1 holds, and fails with ab + 1, in
    both packages."""
    a, b = 11, 29
    for m in (pbls, jbls):
        lhs = (m.g1_mul(a, m.G1_GEN), m.g2_mul(b, m.G2_GEN))
        assert m.pairing_check([lhs, (m.g1_mul(m.R - a * b, m.G1_GEN),
                                      m.G2_GEN)]) is True
        assert m.pairing_check([lhs, (m.g1_mul(m.R - a * b - 1, m.G1_GEN),
                                      m.G2_GEN)]) is False


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_to_curve_equals_reference(seed):
    rng = np.random.default_rng(1730 + seed)
    msg, dst = rng.bytes(int(rng.integers(0, 80))), b"QUUX-V01-CS02-TEST"
    assert ph2c.expand_message_xmd(msg, dst, 96) == \
        jh2c.expand_message_xmd(msg, dst, 96)
    assert pbls.g1_encode(ph2c.hash_to_g1(msg, dst)) == \
        jbls.g1_encode(jh2c.hash_to_g1(msg, dst))
    if seed == 0:
        assert pbls.g2_encode(ph2c.hash_to_g2(msg, dst)) == \
            jbls.g2_encode(jh2c.hash_to_g2(msg, dst))


# ---------------- the three operation frames ----------------

class _Side:
    """One package's modules for a Soroban close."""

    MODULES = {
        "tu": "tx.tx_test_utils", "lm": "ledger.ledger_manager",
        "ts": "herder.tx_set", "lt": "ledger.ledger_txn",
        "tf": "tx.transaction_frame", "keys": "crypto.keys",
        "rt": "xdr.runtime", "xtx": "xdr.tx", "xt": "xdr.types",
        "xc": "xdr.contract", "xl": "xdr.ledger", "xr": "xdr.results",
        "host": "soroban.host", "lg": "simulation.load_generator",
        "ha": "bucket.hot_archive", "proto": "protocol"}

    def __init__(self, package):
        for attr, rel in self.MODULES.items():
            setattr(self, attr, importlib.import_module(f"{package}.{rel}"))

    def manager(self, accounts, version=None):
        """A ``LedgerManager`` over ``seed_root_with_accounts`` of
        ``(seed, balance)`` pairs (its genesis at ``version`` if given),
        every close's ``LedgerCloseMeta`` bytes kept in ``lm.metas``."""
        root = self.tu.seed_root_with_accounts(
            [(self.keys.SecretKey(seed), b) for seed, b in accounts])
        if version is not None:
            root.header().ledgerVersion = version
        lm = self.lm.LedgerManager(self.tu.TEST_NETWORK_ID, root)
        lm.metas = []
        lm.close_meta_stream.append(lambda m: lm.metas.append(
            self.rt.to_bytes(self.xl.LedgerCloseMeta, m)))
        return lm

    def close(self, lm, envelopes=(), upgrades=()):
        frames = [self.tf.make_transaction_frame(
            lm.network_id, self.rt.from_bytes(self.xtx.TransactionEnvelope,
                                              e)) for e in envelopes]
        txset, excluded = self.ts.make_tx_set_from_transactions(
            frames, lm.last_closed_header, lm.last_closed_hash,
            soroban_config=lm.soroban_config)
        assert not excluded
        res = lm.close_ledger(self.lm.LedgerCloseData(
            lm.ledger_seq + 1, txset,
            lm.last_closed_header.scpValue.closeTime + 5,
            upgrades=list(upgrades)))
        return res, frames

    def outcome(self, res):
        return {"hash": res.header_hash.hex(),
                "applied": res.applied_count, "failed": res.failed_count,
                "pairs": [self.rt.to_bytes(self.xr.TransactionResultPair, p)
                          for p in res.result_pairs]}


PORT, REF = _Side("stellar_tpu_torch"), _Side("stellar_tpu")
ARCHIVAL_TAGS = (b"\x51", b"\x52")
EXTEND_TO = 10_000


def _archival_entry(p, tag):
    """``tests/test_archival_catchup.py``'s persistent entry of ``tag``
    (its TTL already expired at ledger 2): the entry, its key, its TTL."""
    T = p.xc.SCValType
    addr = p.host.scaddress_contract(tag * 32)
    cd = p.xc.ContractDataEntry(
        ext=p.xt.ExtensionPoint.make(0), contract=addr,
        key=p.xc.SCVal.make(T.SCV_SYMBOL, b"k"),
        durability=p.xc.ContractDataDurability.PERSISTENT,
        val=p.xc.SCVal.make(T.SCV_U32, tag[0]))
    entry = p.xt.LedgerEntry(
        lastModifiedLedgerSeq=2,
        data=p.xt.LedgerEntry._types[1].make(
            p.xt.LedgerEntryType.CONTRACT_DATA, cd),
        ext=p.xt.LedgerEntry._types[2].make(0))
    lk = p.host.contract_data_key(addr, p.xc.SCVal.make(T.SCV_SYMBOL, b"k"),
                                  p.xc.ContractDataDurability.PERSISTENT)
    ttl = p.xt.LedgerEntry(
        lastModifiedLedgerSeq=2,
        data=p.xt.LedgerEntry._types[1].make(
            p.xt.LedgerEntryType.TTL,
            p.xt.TTLEntry(keyHash=p.host.ttl_key_for(lk).value.keyHash,
                          liveUntilLedgerSeq=2)),
        ext=p.xt.LedgerEntry._types[2].make(0))
    return entry, lk, ttl


def _footprint_tx(p, lm, kp, seq, op_type, body, read_only=(),
                  read_write=()):
    op = p.xtx.Operation(sourceAccount=None, body=p.xtx.OperationBody.make(
        op_type, body))
    tx = p.tu.make_tx(kp, seq, [op], fee=6_000_000,
                      soroban_data=p.lg._soroban_data(
                          read_only=read_only, read_write=read_write),
                      network_id=lm.network_id)
    return p.rt.to_bytes(p.xtx.TransactionEnvelope, tx.envelope)


def _archival_chain(p):
    """Genesis at the protocol before state archival with two expired
    persistent entries; ledger 3 upgrades to it (the eviction scan moves
    both into the hot archive); ledger 4 empty; ledger 5 restores entry
    0x51 (``RestoreFootprint``: live for the minimum persistent time to
    live); ledger 6 extends it ``EXTEND_TO`` ledgers past itself
    (``ExtendFootprintTTL``). Returns each close's outcome
    and meta bytes, and where the two entries are after."""
    seed = p.tu.keypair("arch-a").seed
    lm = p.manager([(seed, 10**13), (p.tu.keypair("arch-b").seed, 10**13)],
                   p.ha.STATE_ARCHIVAL_PROTOCOL_VERSION - 1)
    keys = {}
    with p.lt.LedgerTxn(lm.root) as ltx:
        for tag in ARCHIVAL_TAGS:
            entry, lk, ttl = _archival_entry(p, tag)
            ltx.create(entry).deactivate()
            ltx.create(ttl).deactivate()
            keys[tag] = lk
        ltx.commit()
    kp = p.keys.SecretKey(seed)
    start = 1 << 32
    up = p.xl.LedgerUpgrade.make(p.xl.LedgerUpgradeType.LEDGER_UPGRADE_VERSION,
                                 p.ha.STATE_ARCHIVAL_PROTOCOL_VERSION)
    OT = p.xtx.OperationType
    ledgers = [
        ((), [p.rt.to_bytes(p.xl.LedgerUpgrade, up)]), ((), ()),
        ([_footprint_tx(p, lm, kp, start + 1, OT.RESTORE_FOOTPRINT,
                        p.xtx.RestoreFootprintOp(
                            ext=p.xt.ExtensionPoint.make(0)),
                        read_write=[keys[b"\x51"]])], ()),
        ([_footprint_tx(p, lm, kp, start + 2, OT.EXTEND_FOOTPRINT_TTL,
                        p.xtx.ExtendFootprintTTLOp(
                            ext=p.xt.ExtensionPoint.make(0),
                            extendTo=EXTEND_TO),
                        read_only=[keys[b"\x51"]])], ())]
    outcomes = []
    for envs, upgrades in ledgers:
        res, _frames = p.close(lm, envs, upgrades)
        outcomes.append(p.outcome(res))
    where = {tag.hex(): (lm.root.store.get(p.lt.key_bytes(lk)) is not None,
                         lm.hot_archive.get_archived(p.lt.key_bytes(lk))
                         is not None)
             for tag, lk in keys.items()}
    ttl = lm.root.store.get(p.lt.key_bytes(p.host.ttl_key_for(
        keys[b"\x51"]))).data.value.liveUntilLedgerSeq
    return outcomes, lm.metas, where, ttl


def test_restore_after_eviction_and_extend_equal_reference():
    """Both frames apply; the restored entry is live until ledger 6 +
    ``EXTEND_TO``, the other stays in the hot archive; every header
    hash, result pair and meta byte is the reference's."""
    port, ref = _archival_chain(PORT), _archival_chain(REF)
    outcomes, metas, where, ttl = port
    assert [(o["applied"], o["failed"]) for o in outcomes] == \
        [(0, 0), (0, 0), (1, 0), (1, 0)]
    assert where == {"51": (True, False), "52": (False, True)}
    assert ttl == 6 + EXTEND_TO
    assert port == ref


def _tamper(p):
    """``vectors.soroban_tamper_envelopes``' three ledgers closed by
    ``p`` over ``vectors.soroban_tamper_accounts``, the last closed
    header raised to the current protocol and the caps
    ``soroban_apply_load``'s, as ``chip_smoke.py`` phase 25 (c) does:
    the outcomes, the metas, and the flipped invocation's transaction
    and operation result codes."""
    nid = p.tu.TEST_NETWORK_ID
    ledgers, bad = vectors.soroban_tamper_envelopes(nid)
    lm = p.manager([(k.seed, b) for k, b in vectors.soroban_tamper_accounts()])
    lm.last_closed_header.ledgerVersion = \
        p.proto.CURRENT_LEDGER_PROTOCOL_VERSION
    lm.soroban_config = vectors.soroban_tamper_config(lm.soroban_config)
    lm.root.soroban_config = lm.soroban_config
    outcomes = []
    for envs in ledgers:
        res, frames = p.close(lm, envs)
        outcomes.append(p.outcome(res))
    flipped = frames[vectors.SOROBAN_TAMPER_FLIPPED].contents_hash()
    pair = next(x for x in res.result_pairs
                if x.transactionHash == flipped)
    r = pair.result.result
    codes = (p.xr.TransactionResultCode.name_of(r.arm),
             p.xr.InvokeHostFunctionResultCode.name_of(
                 r.value[0].value.value.arm))
    return outcomes, lm.metas, codes, bad


def test_tampered_auth_entry_fails_as_in_the_reference():
    port, ref = _tamper(PORT), _tamper(REF)
    outcomes, _metas, codes, bad = port
    assert [(o["applied"], o["failed"]) for o in outcomes] == \
        [(1, 0), (1, 0), (vectors.SOROBAN_TAMPER_TXS - 1, 1)]
    assert codes == ("txFAILED", "INVOKE_HOST_FUNCTION_TRAPPED")
    assert pref.verify(*bad) is False and jref.verify(*bad) is False
    assert port[:3] == ref[:3]


def test_chip_smoke_tamper_pins_are_the_reference_close():
    c = chip_smoke_constants()
    outcomes, _metas, codes, _bad = _tamper(REF)
    assert c["SOROBAN_TAMPER_CLOSE_HASH"] == outcomes[-1]["hash"]
    assert ("txFAILED", c["SOROBAN_TAMPER_CODE"]) == codes


def test_registry_holds_the_soroban_frames():
    """``op_frame.make_op_frame`` finds the three Soroban types, each the
    reference's class by name."""
    from stellar_tpu.tx import op_frame as jop
    from stellar_tpu_torch.tx import op_frame as pop
    OT = PORT.xtx.OperationType
    for t, name in ((OT.INVOKE_HOST_FUNCTION, "InvokeHostFunctionOpFrame"),
                    (OT.EXTEND_FOOTPRINT_TTL, "ExtendFootprintTTLOpFrame"),
                    (OT.RESTORE_FOOTPRINT, "RestoreFootprintOpFrame")):
        assert pop._REGISTRY[t].__name__ == jop._REGISTRY[t].__name__ == name
