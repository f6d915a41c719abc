"""Overflow prover for the plain versions of the verify and hash kernels.

Interprets each stage of the port's plain PyTorch kernels — op for op the
reference's — with the interval domain
(:mod:`stellar_tpu_torch.analysis.intervals`), proving:

1. **dtype fit**: every integer intermediate's exact-arithmetic interval
   stays inside the dtype of the op that makes it (int32 for limbs — the
   ``NLIMBS * LOOSE_MAX^2 < 2^31`` headroom claim of the limb layout, per
   op, not per comment; int16 for the cached tables, uint8 for bytes,
   int64 and uint32 for the SHA-256 words);
2. **loose contract**: every limb-shaped stage *output* stays inside
   ``[0, LOOSE_MAX]`` — the inter-stage contract that makes the per-stage
   proofs compose (dsm consumes decompress's point, compress_compare
   consumes dsm's) and that the next field multiply's headroom assumes.

The stages are the reference's, built from the port's ops:

* ``decompress``: ``ed.decompress`` of ``(batch, 32)`` uint8 bytes in
  ``[0, 255]``;
* ``dsm``: the radix-32 recode of s and h plus ``ed.double_scalarmult``
  (the reference's ``dsm_stage``) on scalar bytes and an extended point
  whose limbs are anywhere in ``[0, LOOSE_MAX]`` — so the proof covers
  *any* loose point, not just decompress outputs;
* ``dsm_hot``: the radix-256 recode plus ``ed.double_scalarmult_hot`` (the
  reference's ``dsm_stage_hot``) on the batch-leading ``(batch, 128, 3,
  20)`` int16 table with canonical limbs in ``[0, MASK]``;
* ``compress_compare``: a loose point plus encoded bytes;
* ``kernel_total`` / ``kernel_hot_total``: K1's and K2's plain versions
  end to end from raw operands (the actual composition, ``negate``
  between decompress and dsm included);
* ``sha256_kernel``: K3's plain version on full-range uint32 words and
  any active-block mask.

The proven envelope is summarized per limb (batch axes collapse) and
committed as ``stellar_tpu_torch/analysis/limb_bounds.json`` and
``sha256_bounds.json``, in the reference's format, so kernel changes
diff the proof itself.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from stellar_tpu_torch.analysis.intervals import (
    AbsVal, IntervalInterpreter, Unsupported,
)

__all__ = [
    "DEFAULT_BUCKETS", "STAGES", "STAGE_OUTPUT_NAMES", "LOOSE_OUTPUTS",
    "prove", "prove_stage", "prove_buckets", "stage_functions",
    "stage_inputs", "envelope_sha256", "load_golden", "diff_golden",
    "GOLDEN_PATH", "SHA_GOLDEN_PATH", "load_sha_golden", "prove_sha256",
    "prove_sha256_buckets", "Unsupported",
]

# The batches a stage is proven at by default. Bounds are batch-collapsed,
# so the envelope does not depend on the batch; the op stream does in one
# place: fe.batch_inv's cross-lane tree has log2(batch) levels, none at
# batch 1. Batch 2 runs one level, and every further level repeats its
# ops on the same intervals, so batch 2 covers every batch above 1.
DEFAULT_BUCKETS = (2,)

GOLDEN_PATH = "stellar_tpu_torch/analysis/limb_bounds.json"
SHA_GOLDEN_PATH = "stellar_tpu_torch/analysis/sha256_bounds.json"

STAGES = ("decompress", "dsm", "dsm_hot", "compress_compare",
          "kernel_total", "kernel_hot_total")

STAGE_OUTPUT_NAMES = {
    "decompress": ("ok", "x", "y", "z", "t"),
    "dsm": ("x", "y", "z"),
    "dsm_hot": ("x", "y", "z"),
    "compress_compare": ("ok",),
    "kernel_total": ("ok",),
    "kernel_hot_total": ("ok",),
}

# Limb-shaped stage outputs that must honor the loose contract
# [0, LOOSE_MAX]: the inter-stage composition invariant.
LOOSE_OUTPUTS = {
    "decompress": ("x", "y", "z", "t"),
    "dsm": ("x", "y", "z"),
    "dsm_hot": ("x", "y", "z"),
    "compress_compare": (),
    "kernel_total": (),
    "kernel_hot_total": (),
}


def _fe():
    from stellar_tpu_torch.ops import field25519 as fe
    return fe


def _flatten(out) -> list:
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flatten(o)]
    return [out]


def stage_functions() -> Dict[str, object]:
    """The stages as functions of the port's ops (looked up at call time,
    so a patched field layer is what runs)."""
    from stellar_tpu_torch.ops import edwards as ed
    from stellar_tpu_torch.ops import verify as vk

    def dsm(s_bytes, h_bytes, x, y, z, t):
        return ed.double_scalarmult(vk.signed_digits32(s_bytes),
                                    vk.signed_digits32(h_bytes),
                                    (x, y, z, t))

    def dsm_hot(s_bytes, h_bytes, a_table):
        return ed.double_scalarmult_hot(vk.signed_digits256(s_bytes),
                                        vk.signed_digits256(h_bytes),
                                        a_table.movedim(0, -1))

    return {
        "decompress": lambda a: ed.decompress(a),
        "dsm": dsm,
        "dsm_hot": dsm_hot,
        "compress_compare": lambda x, y, z, t, r: ed.compress_equals(
            (x, y, z, t), r),
        "kernel_total": lambda a, r, s, h: vk.verify_kernel_plain(
            a, r, s, h),
        "kernel_hot_total": lambda tab, r, s, h: vk.verify_kernel_hot_plain(
            tab, r, s, h),
    }


def stage_inputs(stage: str, batch: int) -> List[AbsVal]:
    """The reference's input contract of each stage, at ``batch`` rows."""
    from stellar_tpu_torch.ops import edwards as ed
    fe = _fe()

    def byte_val():
        return AbsVal.from_range((batch, 32), np.uint8, 0, 255)

    def limb_val():
        return AbsVal.from_range((fe.NLIMBS, batch), np.int32, 0,
                                 fe.LOOSE_MAX)

    def table_val():
        # signer tables are host-built with CANONICAL limbs
        # (parallel/signer_tables.py packs fe.from_int output): [0, MASK]
        return AbsVal.from_range(
            (batch, ed.TABLE_ENTRIES256, ed.AFFINE_COORDS, fe.NLIMBS),
            np.int16, 0, fe.MASK)

    if stage == "decompress":
        return [byte_val()]
    if stage == "dsm":
        return [byte_val(), byte_val()] + [limb_val() for _ in range(4)]
    if stage == "dsm_hot":
        return [byte_val(), byte_val(), table_val()]
    if stage == "compress_compare":
        return [limb_val() for _ in range(4)] + [byte_val()]
    if stage == "kernel_total":
        return [byte_val() for _ in range(4)]
    if stage == "kernel_hot_total":
        return [table_val()] + [byte_val() for _ in range(3)]
    raise ValueError(stage)


def _summarize_output(val: AbsVal) -> list:
    """Collapse batch axes: (20, batch) -> 20 [lo, hi] pairs; (batch,)
    bool -> one [lo, hi] pair."""
    fe = _fe()
    lo, hi = val.lo, val.hi
    if len(val.shape) >= 1 and val.shape[0] == fe.NLIMBS and \
            val.dtype == np.int32:
        axes = tuple(range(1, lo.ndim))
        llo = lo.min(axis=axes) if axes else lo
        lhi = hi.max(axis=axes) if axes else hi
        llo = np.broadcast_to(llo, (fe.NLIMBS,))
        lhi = np.broadcast_to(lhi, (fe.NLIMBS,))
        return [[int(a), int(b)] for a, b in zip(llo, lhi)]
    return [list(val.bounds())]


def prove_stage(stage: str, batch: int, memo=None) -> dict:
    """Interpret one stage at ``batch`` rows: ``{violations, max_abs,
    outputs, ops, memo_hits}`` (outputs as AbsVals). Raises
    :class:`Unsupported` on an op outside the verified subset."""
    interp = IntervalInterpreter(path=stage)
    kw = {} if memo is None else {"memo": memo}
    outs = interp.run(stage_functions()[stage],
                      stage_inputs(stage, batch), **kw)
    return {"violations": interp.violations, "max_abs": interp.max_abs,
            "outputs": _flatten(outs), "ops": interp.ops,
            "memo_hits": interp.memo_hits}


def _limb_layout() -> dict:
    fe = _fe()
    return {"nlimbs": fe.NLIMBS, "bits": fe.BITS, "mask": fe.MASK,
            "loose_max": fe.LOOSE_MAX, "fold": fe.FOLD}


def prove(batch: int = DEFAULT_BUCKETS[0],
          stages: Sequence[str] = STAGES) -> dict:
    """Prove the listed stages at one batch size. Returns a record with
    ``ok``, the per-stage envelope, violations and contract breaches."""
    fe = _fe()
    out_stages = {}
    violations: List[dict] = []
    contract: List[str] = []
    unsupported: List[str] = []
    for stage in stages:
        try:
            res = prove_stage(stage, batch)
        except Unsupported as e:
            unsupported.append(str(e))
            out_stages[stage] = {"max_abs": None, "outputs": {}}
            continue
        names = STAGE_OUTPUT_NAMES[stage]
        outs = res["outputs"]
        if len(names) != len(outs):
            unsupported.append(
                f"{stage}: expected {len(names)} outputs, got {len(outs)} "
                "— the stage split drifted, update STAGE_OUTPUT_NAMES")
            continue
        summ = {n: _summarize_output(v) for n, v in zip(names, outs)}
        out_stages[stage] = {"max_abs": int(res["max_abs"]),
                             "outputs": summ}
        violations.extend(v.to_dict() for v in res["violations"])
        for name in LOOSE_OUTPUTS[stage]:
            for limb, (lo, hi) in enumerate(summ[name]):
                if lo < 0 or hi > fe.LOOSE_MAX:
                    contract.append(
                        f"{stage}.{name} limb {limb} in [{lo}, {hi}] "
                        f"escapes the loose contract [0, {fe.LOOSE_MAX}]"
                        " — the next stage's multiply headroom is gone")
    envelope = {"format": 1, "limb_layout": _limb_layout(),
                "stages": out_stages}
    return {
        "batch": batch,
        "ok": not violations and not contract and not unsupported,
        "violations": violations,
        "contract_breaches": contract,
        "unsupported": unsupported,
        "envelope": envelope,
        "envelope_sha256": envelope_sha256(envelope),
    }


def _merge(records: List[dict], buckets: Sequence[int]) -> dict:
    """One record over several batches: the envelope must be identical
    across them (bounds are batch-uniform — a difference means the
    kernel's math depends on the batch, itself a red flag), and every
    failure class is merged, tagged with its batch."""
    first = records[0]
    mismatch = [r["batch"] for r in records[1:]
                if r["envelope_sha256"] != first["envelope_sha256"]]
    out = dict(first)
    out["buckets"] = list(buckets)
    out["ok"] = all(r["ok"] for r in records) and not mismatch
    out["envelope_mismatch_buckets"] = mismatch
    for r in records[1:]:
        out["violations"] = out["violations"] + [
            v for v in r["violations"] if v not in out["violations"]]
        for key in ("contract_breaches", "unsupported"):
            out[key] = out[key] + [f"[batch={r['batch']}] {m}"
                                   for m in r[key] if m not in out[key]]
    return out


def prove_buckets(buckets: Sequence[int] = DEFAULT_BUCKETS,
                  stages: Sequence[str] = STAGES) -> dict:
    """Prove the stages at every listed batch size."""
    return _merge([prove(b, stages) for b in buckets], buckets)


# ---------------- SHA-256 (K3) ----------------

def _sha_max_blocks() -> int:
    from stellar_tpu_torch.crypto.batch_hasher import MAX_BLOCKS
    return MAX_BLOCKS


def prove_sha256(batch: int = DEFAULT_BUCKETS[0],
                 max_blocks: Optional[int] = None) -> dict:
    """Prove K3's plain version at one batch size: full-range uint32
    message words, any active-block mask. One stage
    (``sha256_kernel``), one output (the digest words, which must span
    exactly uint32)."""
    from stellar_tpu_torch.ops import sha256 as sk
    max_blocks = max_blocks or _sha_max_blocks()
    words = AbsVal.from_range((batch, max_blocks, 16), np.uint32, 0,
                              0xFFFFFFFF)
    active = AbsVal.from_range((batch, max_blocks), np.bool_, 0, 1)
    violations: List[dict] = []
    unsupported: List[str] = []
    stages = {}
    try:
        interp = IntervalInterpreter(path="sha256_kernel")
        out = interp.run(sk.sha256_kernel_plain, [words, active])
        lo, hi = out.bounds()
        stages["sha256_kernel"] = {"max_abs": int(interp.max_abs),
                                   "outputs": {"digest": [[lo, hi]]}}
        violations = [v.to_dict() for v in interp.violations]
    except Unsupported as e:
        unsupported.append(str(e))
        stages["sha256_kernel"] = {"max_abs": None, "outputs": {}}
    envelope = {
        "format": 1,
        "word_layout": {"word_bits": 32, "max_blocks": int(max_blocks),
                        "rounds": 64},
        "stages": stages,
    }
    return {
        "batch": batch,
        "ok": not violations and not unsupported,
        "violations": violations,
        "contract_breaches": [],
        "unsupported": unsupported,
        "envelope": envelope,
        "envelope_sha256": envelope_sha256(envelope),
    }


def prove_sha256_buckets(buckets: Sequence[int] = DEFAULT_BUCKETS,
                         max_blocks: Optional[int] = None) -> dict:
    """Prove K3's plain version at every listed batch size."""
    return _merge([prove_sha256(b, max_blocks) for b in buckets], buckets)


# ---------------- goldens ----------------

def envelope_sha256(envelope: dict) -> str:
    canon = json.dumps(envelope, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def _load(repo_root: str, rel: str) -> Optional[dict]:
    path = os.path.join(repo_root, rel)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_golden(repo_root: str) -> Optional[dict]:
    return _load(repo_root, GOLDEN_PATH)


def load_sha_golden(repo_root: str) -> Optional[dict]:
    return _load(repo_root, SHA_GOLDEN_PATH)


def diff_golden(envelope: dict, golden: dict,
                stages: Optional[Sequence[str]] = None) -> List[str]:
    """Human-readable envelope-vs-golden differences (empty = match),
    over ``stages`` (default: every stage in either)."""
    diffs: List[str] = []
    for layout in ("limb_layout", "word_layout"):
        if golden.get(layout) != envelope.get(layout):
            diffs.append(f"{layout} changed: {golden.get(layout)} -> "
                         f"{envelope.get(layout)}")
    gst = golden.get("stages", {})
    est = envelope.get("stages", {})
    names = sorted(set(gst) | set(est)) if stages is None else stages
    for stage in names:
        g, e = gst.get(stage), est.get(stage)
        if g is None or e is None:
            diffs.append(f"stage {stage}: "
                         f"{'added' if g is None else 'removed'}")
            continue
        if g.get("max_abs") != e.get("max_abs"):
            diffs.append(f"{stage}.max_abs: {g.get('max_abs')} -> "
                         f"{e.get('max_abs')}")
        go, eo = g.get("outputs", {}), e.get("outputs", {})
        for name in sorted(set(go) | set(eo)):
            if go.get(name) != eo.get(name):
                diffs.append(f"{stage}.{name}: {go.get(name)} -> "
                             f"{eo.get(name)}")
    return diffs
