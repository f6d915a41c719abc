"""Deterministic sampler for the result-integrity audit and the verify
service's load-shed draw — the port's copy of
``stellar_tpu/crypto/audit.py``.

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

__all__ = ["sample_indices", "sample_rows", "keep_under_shed",
           "verdict_record"]


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


def keep_under_shed(material: bytes, keep_fraction: float,
                    tenant: bytes = b"") -> bool:
    """Deterministic content-seeded keep/drop draw — the verify service's
    load-shed rule, same discipline as the audit sampler above: under
    identical overload pressure, replicas holding the same queued work
    shed identical rows, because the draw is SHA-256 of the work's own
    bytes mapped uniformly into [0, 1), with no clock, RNG state or hash
    salt. A submission's draw is fixed by its bytes, so survivors keep
    surviving while their effective keep fraction holds; only a change
    of the fraction (pressure level, tenant pressure) can shed a previous
    survivor.

    ``tenant`` mixes the submitting tenant's key into the draw,
    length-prefixed so distinct (tenant, material) splits never alias:
    each tenant gets an independent shed stream. The empty key (the
    default, un-tenanted stream) keeps the plain draw.

    Returns True to keep (verify) the work, False to shed it.
    ``keep_fraction >= 1`` keeps everything and ``<= 0`` sheds
    everything, without hashing."""
    if keep_fraction >= 1.0:
        return True
    if keep_fraction <= 0.0:
        return False
    if tenant:
        material = (len(tenant).to_bytes(2, "little") + tenant
                    + material)
    h = hashlib.sha256(material).digest()
    draw = int.from_bytes(h[:8], "little") / float(1 << 64)
    return draw < keep_fraction


def verdict_record(device: Optional[int], lo: int, hi: int,
                   sampled: int, ok: bool) -> dict:
    """The evidence shape of one audit verdict, as the engine keeps it
    (``BatchEngine.audit_log``). Pure data: no clock, no RNG."""
    return {"device": -1 if device is None else int(device),
            "rows": [int(lo), int(hi)],
            "sampled": int(sampled),
            "ok": bool(ok)}
