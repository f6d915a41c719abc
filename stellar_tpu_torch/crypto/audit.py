"""Deterministic sampler for the result-integrity audit — the port's
copy of ``stellar_tpu/crypto/audit.py`` (the sampler and the verdict
record; the verify service's load-shed draw waits for the service).

A corrupting card returns wrong bits instead of failing, which breakers
never see; the engine therefore re-verifies a sample of every
device-served part through the host oracle. The sample is derived from
the part's own bytes: replicas verifying the same batch audit the same
rows, with no clock, RNG state or hash salt. Indices come counter-mode
from SHA-256 of the material.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

__all__ = ["sample_indices", "sample_rows", "verdict_record"]


def sample_indices(material: bytes, n: int, rate: float) -> List[int]:
    """Indices in ``[0, n)`` to audit, derived deterministically from
    ``material`` (the chunk's raw bytes).

    ``rate <= 0`` disables the audit (empty sample). Otherwise the
    sample size is ``max(1, int(n * rate))`` — at least one row per
    chunk, so even a tiny rate cross-checks every dispatch. ``rate >=
    1`` audits every row (the fault tests use this to make a single
    corrupted sub-chunk a guaranteed catch).

    Collisions are resolved by drawing more counters, with a bounded
    budget — the sample may come up slightly short of ``k`` for
    mid-range rates, never over, and stays deterministic.
    """
    if n <= 0 or rate <= 0.0:
        return []
    k = min(n, max(1, int(n * rate + 1e-9)))
    if k >= n:
        return list(range(n))
    digest = hashlib.sha256(material).digest()
    picked: List[int] = []
    seen = set()
    ctr = 0
    budget = 4 * k + 16
    while len(picked) < k and ctr < budget:
        h = hashlib.sha256(digest + ctr.to_bytes(4, "little")).digest()
        idx = int.from_bytes(h[:8], "little") % n
        if idx not in seen:
            seen.add(idx)
            picked.append(idx)
        ctr += 1
    return picked


def sample_rows(material: bytes, eligible_rows: Sequence[int],
                rate: float) -> List[int]:
    """Sample among ELIGIBLE rows only — the rows whose device verdict
    actually decides the composed outcome (host policy gate passed).

    Rows the host policy gate already rejected compare ``False ==
    False`` against the oracle no matter what the device returned —
    sampling them would be vacuous, and since the sample is derived
    from the exact bytes the device holds, a corrupting chip could
    even predict such a blind spot. Restricting to eligible rows keeps
    every drawn sample a REAL cross-check; the eligibility mask is
    host-computed and deterministic, so replicas still agree.

    Returns row indices (in the caller's row numbering), possibly
    empty — a part with no eligible rows needs no audit, because no
    device bit in it can reach a verdict.
    """
    picks = sample_indices(material, len(eligible_rows), rate)
    return [eligible_rows[p] for p in picks]


def verdict_record(device: Optional[int], lo: int, hi: int,
                   sampled: int, ok: bool) -> dict:
    """The evidence shape of one audit verdict, as the engine keeps it
    (``BatchEngine.audit_log``). Pure data: no clock, no RNG."""
    return {"device": -1 if device is None else int(device),
            "rows": [int(lo), int(hi)],
            "sampled": int(sampled),
            "ok": bool(ok)}
