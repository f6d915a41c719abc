"""The port's interval prover over the aten op stream of the plain
versions (``stellar_tpu_torch.analysis.intervals`` / ``overflow``).

* **Transfer functions**: exact multiply and add, int32 overflow flagged,
  the carry step, the one-hot union bound and its soundness against a
  varying operand, the OR/XOR bit ceiling, unsigned NOT, exact 64-bit
  arithmetic, the narrowing reinterpretation, and ``Unsupported`` on an
  op with no rule or a Python branch on a value.
* **The proof**: every stage of the reference's split, built from the
  port's ops and proven at batch 2, has outputs equal to the reference's
  committed ``docs/limb_bounds.json`` / ``docs/sha256_bounds.json`` limb
  for limb, every op's dtype fit proven; ``max_abs`` equals the
  reference's too, but for K3, whose words the port holds in int64; the
  port's own goldens are reproduced, and batch 1 and 3 prove the same
  envelope.
* **Vacuity guards**: a dropped carry round seeded into the port's field
  multiply is caught on a synthetic chain and in the real ``dsm`` stage;
  a repeated call served from the interpreter's table gives what
  re-interpreting its ops gives.
"""

import json
import os

import numpy as np
import pytest
import torch

from stellar_tpu_torch.analysis import overflow
from stellar_tpu_torch.analysis.intervals import (
    AbsVal, IntervalInterpreter, Unsupported,
)
from stellar_tpu_torch.analysis.lint_base import repo_root
from stellar_tpu_torch.ops import edwards as ed
from stellar_tpu_torch.ops import field25519 as fe

ROOT = str(repo_root())


def _run(fn, *ins, memo=()):
    interp = IntervalInterpreter("unit")
    return interp, interp.run(fn, ins, memo=memo)


def _i32(shape, lo, hi):
    return AbsVal.from_range(shape, np.int32, lo, hi)


def _bounds(v):
    return int(v.lo.min()), int(v.hi.max())


# ---------------- transfer functions ----------------

def test_interval_mul_add_exact():
    interp, out = _run(lambda a, b: a * b + a, _i32((4,), 2, 10),
                       _i32((4,), -3, 5))
    assert _bounds(out) == (10 * -3 + 2, 10 * 5 + 10)
    assert not interp.violations


def test_interval_flags_int32_overflow():
    interp, _ = _run(lambda a, b: a * b, _i32((4,), 0, 1 << 20),
                     _i32((4,), 0, 1 << 20))
    assert len(interp.violations) == 1
    v = interp.violations[0]
    assert v.primitive == "mul" and v.dtype == "int32"
    assert v.hi == 1 << 40
    assert "test_torch_intervals.py" in v.where


def test_interval_carry_step_bound():
    """The field layer's parallel carry round maps loose limbs back under
    MASK + fold headroom — the analyzer must see that."""
    interp, out = _run(fe._carry_step,
                       _i32((fe.NLIMBS, 3), 0, 20 * fe.LOOSE_MAX ** 2 // 1000))
    assert not interp.violations
    assert int(out.hi.max()) < 1 << 22


def test_onehot_select_union_bound():
    """The one-hot contraction idiom (``ed.table_select``'s radix-16
    window select) gets the union bound, not the 8x sum."""
    def select(table, digit):
        idx = torch.arange(1, 9, dtype=torch.int32).reshape(8, 1)
        onehot = (idx == digit[None]).to(torch.int32)
        return (table * onehot).sum(dim=0, dtype=torch.int32)

    interp, out = _run(select, _i32((8, 5), 0, 9000), _i32((5,), -8, 8))
    assert not interp.violations
    assert _bounds(out) == (0, 9000)  # union, not 8 * 9000


def test_onehot_select_union_bound_in_table_select():
    """The port's own select: a selected limb is bounded by an entry, as
    the reference's envelope needs."""
    interp, out = _run(
        lambda t, d: ed.table_select(t, d)[0],
        AbsVal.from_range((8, 4, fe.NLIMBS, 3), np.int32, 0, fe.LOOSE_MAX),
        _i32((3,), -8, 8))
    assert not interp.violations
    assert int(out.hi.max()) <= fe.LOOSE_MAX + 1  # the digit-0 patch


def test_onehot_refinement_sound_against_varying_operand():
    """eq(arange(8), an (8,) operand) is NOT one-hot: the operand varies
    per position (it could equal the arange everywhere), so the sum must
    be the full 8-fold sum. Uniform BOUNDS (stored-size-1) must not be
    mistaken for uniform VALUES."""
    def select(table, y):
        idx = torch.arange(8, dtype=torch.int32)
        onehot = (idx == y).to(torch.int32)
        return (table[:, None] * onehot[:, None]).sum(dim=0,
                                                      dtype=torch.int32)

    _interp, out = _run(select, _i32((8,), 0, 9000), _i32((8,), 0, 7))
    assert int(out.hi.max()) == 8 * 9000  # all positions can match


def _u32(lo, hi):
    return AbsVal.from_range((4,), np.uint32, lo, hi)


def _words(x):
    """K3's word load: uint32 viewed as int32, widened and masked."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def test_or_xor_bitmask_refinement():
    """OR/XOR of non-negative operands never set a bit above either
    operand's highest bit — the refinement that keeps the SHA-256
    schedule and round mixing inside 32 bits. The bound must COVER the
    true range and be the bit ceiling."""
    interp, (o1, o2) = _run(
        lambda a, b: (_words(a) | _words(b), _words(a) ^ _words(b)),
        _u32(0, 5), _u32(0, 9))
    assert not interp.violations
    # min(sum bound 5+9, bit ceiling of max(5, 9) = 15) = 14, which
    # covers the true max (5|8 = 5^8 = 13)
    assert _bounds(o1) == (0, 14) and _bounds(o2) == (0, 14)
    interp2, (p1, p2) = _run(
        lambda a, b: (_words(a) | _words(b), _words(a) ^ _words(b)),
        _u32(0, 0xFFFFFFFF), _u32(0, 0xFFFFFFFF))
    assert not interp2.violations
    assert _bounds(p1) == (0, 0xFFFFFFFF) == _bounds(p2)
    # signed operands that may be negative fall back to the wide bound
    _interp3, n1 = _run(lambda a, b: a ^ b, _i32((4,), -1, 5),
                        _i32((4,), 0, 9))
    assert int(n1.lo.min()) < 0


def test_unsigned_not_transfer():
    """Unsigned bitwise-not is dtype_max - x, not -1 - x."""
    interp, out = _run(lambda a: ~a, AbsVal.from_range((4,), np.uint8, 0,
                                                       10))
    assert not interp.violations
    assert _bounds(out) == (255 - 10, 255)


def test_int64_is_exact_not_saturated():
    """K3's words in int64: a rotation's left shift reaches 2^63 - 2^31,
    past the 2^61 saturation, and is proven to fit exactly; one bit
    further is an int64 overflow, and is caught."""
    fits = AbsVal.from_range((4,), np.int64, 0, 0xFFFFFFFF)
    interp, out = _run(lambda x: x << 31, fits)
    assert not interp.violations
    assert _bounds(out) == (0, 0xFFFFFFFF << 31)
    interp, _ = _run(lambda x: x << 32, fits)
    assert [v.primitive for v in interp.violations] == ["__lshift__"]
    assert interp.violations[0].hi == 0xFFFFFFFF << 32


def test_narrowing_reinterpretation():
    """``.to(int32)`` of a word in [0, 2^32 - 1] keeps its bits (K3's
    digest): no overflow, and viewing it as uint32 recovers the word's
    exact interval. A value past 32 bits is an overflow."""
    interp, out = _run(
        lambda x: x.to(torch.int32).view(torch.uint32),
        AbsVal.from_range((4,), np.int64, 0, 0xFFFFFFFF))
    assert not interp.violations
    assert _bounds(out) == (0, 0xFFFFFFFF) and out.dtype == np.uint32
    interp, out = _run(lambda x: x.to(torch.int32),
                       AbsVal.from_range((4,), np.int64, 0, 1 << 33))
    assert [v.primitive for v in interp.violations] == ["_to_copy"]


def test_unsupported_op_is_loud():
    with pytest.raises(Unsupported, match="no interval rule"):
        _run(lambda a: torch.cumsum(a, 0), _i32((3,), 0, 1))
    with pytest.raises(Unsupported, match="float32"):
        _run(lambda a: torch.sin(a.to(torch.float32)), _i32((3,), 0, 1))


def test_python_branch_on_a_value_is_loud():
    with pytest.raises(Unsupported, match="Python branch"):
        _run(lambda a: a * 2 if a.sum() > 0 else a, _i32((3,), 0, 1))


def test_repeated_calls_equal_reinterpretation():
    """A call served from the interpreter's table gives exactly what
    interpreting its ops again gives: a doubling and a cached add of a
    loose point, with and without the table."""
    def two_rounds(x, y, z, t):
        p = (x, y, z, t)
        for _ in range(3):
            p = ed.point_double(p)
            p = ed.point_add_cached(p, ed.to_cached(p))
        return p

    pt = [_i32((fe.NLIMBS, 2), 0, fe.LOOSE_MAX) for _ in range(4)]
    plain, outs = _run(two_rounds, *pt)
    memo, mouts = IntervalInterpreter("unit"), None
    mouts = memo.run(two_rounds, pt)
    assert memo.memo_hits > 0 and memo.ops < plain.ops
    assert memo.max_abs == plain.max_abs
    assert memo.violations == plain.violations == []
    for a, b in zip(outs, mouts):
        assert a.key() == b.key()


# ---------------- the proof against the reference's goldens ----------------

def _ref_golden(name):
    with open(os.path.join(ROOT, "docs", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def proofs():
    return {}


def _proof(proofs, stage, batch=2):
    if (stage, batch) not in proofs:
        proofs[(stage, batch)] = overflow.prove(batch, stages=[stage])
    return proofs[(stage, batch)]


@pytest.mark.parametrize("stage", overflow.STAGES)
def test_stage_outputs_equal_the_reference(proofs, stage):
    """The port's plain version, op for op the reference's kernel,
    proves the reference's envelope: the same outputs limb for limb and
    the same worst intermediate, every op's dtype fit proven and the loose
    contract held."""
    rec = _proof(proofs, stage)
    assert rec["unsupported"] == []
    assert rec["violations"] == [], rec["violations"][:3]
    assert rec["contract_breaches"] == []
    assert rec["ok"]
    want = _ref_golden("limb_bounds.json")
    assert rec["envelope"]["limb_layout"] == want["limb_layout"]
    got = rec["envelope"]["stages"][stage]
    assert got["outputs"] == want["stages"][stage]["outputs"]
    assert got["max_abs"] == want["stages"][stage]["max_abs"]
    golden = overflow.load_golden(ROOT)
    assert not overflow.diff_golden(rec["envelope"], golden, [stage])


@pytest.mark.parametrize("stage", ["decompress", "compress_compare",
                                   "dsm_hot"])
@pytest.mark.parametrize("batch", [1, 3])
def test_envelope_does_not_depend_on_the_batch(proofs, stage, batch):
    rec = _proof(proofs, stage, batch)
    assert rec["ok"]
    assert not overflow.diff_golden(rec["envelope"],
                                    overflow.load_golden(ROOT), [stage])


def test_sha256_outputs_equal_the_reference():
    """K3's plain version: digest words spanning exactly uint32, as the
    reference's; with the reference's masked rotation and half-word
    adds, its worst intermediate is 2^32 - 1, the reference's too."""
    rec = overflow.prove_sha256(2)
    assert rec["ok"], (rec["violations"][:3], rec["unsupported"])
    want = _ref_golden("sha256_bounds.json")
    got = rec["envelope"]
    assert got["word_layout"] == want["word_layout"]
    stage = got["stages"]["sha256_kernel"]
    assert stage["outputs"] == want["stages"]["sha256_kernel"]["outputs"] \
        == {"digest": [[0, 0xFFFFFFFF]]}
    assert want["stages"]["sha256_kernel"]["max_abs"] == 0xFFFFFFFF
    assert stage["max_abs"] == 0xFFFFFFFF
    assert got == overflow.load_sha_golden(ROOT)


def test_sha256_goldens_equal():
    """The port's committed K3 golden is the reference's, envelope and
    hash alike."""
    port = overflow.load_sha_golden(ROOT)
    want = _ref_golden("sha256_bounds.json")
    assert port["stages"]["sha256_kernel"] == \
        want["stages"]["sha256_kernel"]
    assert port == want
    assert overflow.envelope_sha256(port) == overflow.envelope_sha256(want)


def test_ports_goldens_reproduced_and_committed(proofs):
    """The port's committed limb golden equals the reference's, and its
    hash is what the proof at batch 2 gives for every stage together."""
    golden = overflow.load_golden(ROOT)
    assert golden == _ref_golden("limb_bounds.json")
    stages = {s: _proof(proofs, s)["envelope"]["stages"][s]
              for s in overflow.STAGES}
    env = dict(_proof(proofs, "dsm")["envelope"], stages=stages)
    assert overflow.envelope_sha256(env) == \
        overflow.envelope_sha256(golden)


def test_headroom_is_the_documented_claim(proofs):
    """The binding constraint is the documented one: the multiply
    accumulator's worst coefficient is exactly NLIMBS * LOOSE_MAX^2 under
    int32; the hot stage, whose cached table ships canonical limbs, is
    strictly tighter."""
    dsm = _proof(proofs, "dsm")["envelope"]["stages"]["dsm"]["max_abs"]
    assert dsm == fe.NLIMBS * fe.LOOSE_MAX ** 2 < 2 ** 31
    hot = _proof(proofs, "dsm_hot")["envelope"]["stages"]["dsm_hot"]
    assert hot["max_abs"] < dsm


# ---------------- vacuity guards ----------------

def _mul_dropped_carry(a, b):
    """fe.mul with the final carry round removed — the seeded overflow:
    limbs leave a single round around 2^23, so the NEXT multiply's
    accumulator blows through int32."""
    a, b = torch.broadcast_tensors(a, b)
    acc = torch.zeros((2 * fe.NLIMBS - 1,) + tuple(a.shape[1:]),
                      dtype=torch.int32)
    for i in range(fe.NLIMBS):
        acc[i:i + fe.NLIMBS] += a[i] * b
    lo = acc & fe.MASK
    hi = acc >> fe.BITS
    c40_low = lo + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], dim=0)
    high = torch.cat([c40_low[fe.NLIMBS:], hi[-1:]], dim=0)
    low = c40_low[:fe.NLIMBS] + fe.FOLD * high
    return fe._carry_step(low)  # ONE round; the field layer does two


def test_mutant_dropped_carry_caught_synthetic():
    interp, _ = _run(
        lambda a, b: _mul_dropped_carry(_mul_dropped_carry(a, b), b),
        _i32((fe.NLIMBS, 2), 0, fe.LOOSE_MAX),
        _i32((fe.NLIMBS, 2), 0, fe.LOOSE_MAX))
    assert interp.violations, "dropped carry must overflow the 2nd mul"


def test_mutant_dropped_carry_caught_in_real_dsm(monkeypatch):
    """The strong vacuity guard: the dropped carry seeded into the port's
    REAL field layer, the REAL dsm stage interpreted — the prover must
    fail it."""
    monkeypatch.setattr(fe, "mul", _mul_dropped_carry)
    res = overflow.prove_stage("dsm", 2)
    assert res["violations"], (
        "the overflow prover accepted a field multiply with a dropped "
        "carry — the proof is vacuous")
    assert {v.dtype for v in res["violations"]} == {"int32"}
    rec = overflow.prove(2, stages=["dsm"])
    assert not rec["ok"]
