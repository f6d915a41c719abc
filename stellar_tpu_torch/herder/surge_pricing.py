"""Multi-lane surge pricing (reference ``src/herder/SurgePricingUtils.h``
/ ``.cpp`` — ``SurgePricingLaneConfig`` + ``SurgePricingPriorityQueue``).

Transactions compete for block space by inclusion-fee *rate*; lanes put
independent ceilings on sub-classes of traffic (the reference ships a
DEX lane for classic and a generic lane for Soroban). Lane 0 is the
GENERIC lane whose limit is the whole capacity; limited lanes also count
against it. Selection pops the highest-fee-rate eligible head while
every account's sequence chain stays gapless; the per-lane base fee
under surge is the lowest included bid in that lane.

The port's copy of ``stellar_tpu/herder/surge_pricing.py``, with the
port's imports.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["SurgePricingLaneConfig", "SurgePricingPriorityQueue",
           "GENERIC_LANE"]

GENERIC_LANE = 0


class SurgePricingLaneConfig:
    """lane_limits[0] is total capacity; further entries cap specific
    lanes. ``lane_of`` classifies a frame; ``resources_of`` is its cost
    (ops for classic, tx count for Soroban)."""

    def __init__(self, lane_limits: List[int],
                 lane_of: Optional[Callable] = None,
                 resources_of: Optional[Callable] = None):
        self.lane_limits = lane_limits
        self._lane_of = lane_of or (lambda f: GENERIC_LANE)
        self._resources_of = resources_of or \
            (lambda f: max(1, f.num_operations()))

    def lane_of(self, frame) -> int:
        return self._lane_of(frame)

    def resources_of(self, frame) -> int:
        return self._resources_of(frame)


def _fee_rate_less_than(a, b) -> bool:
    return a.inclusion_fee() * b.num_operations() < \
        b.inclusion_fee() * a.num_operations()


class SurgePricingPriorityQueue:
    """Greedy top-bid selection under lane limits with gapless account
    chains (the ``getMostTopTxsWithinLimits`` role)."""

    @staticmethod
    def most_top_txs_within_limits(
            frames: Sequence, config: SurgePricingLaneConfig
    ) -> Tuple[List, List, Dict[int, bool]]:
        """(included, excluded, lane_was_full). Whole account tails are
        excluded on overflow so sequence numbers stay gapless."""
        queues: Dict[bytes, List] = {}
        for f in frames:
            queues.setdefault(f.source_account_id().value, []).append(f)
        for q in queues.values():
            q.sort(key=lambda f: f.seq_num)

        included: List = []
        excluded: List = []
        used = [0] * len(config.lane_limits)
        lane_full: Dict[int, bool] = {}
        heads = [(q[0], aid) for aid, q in queues.items()]
        while heads:
            best_i = 0
            for i in range(1, len(heads)):
                a, b = heads[i][0], heads[best_i][0]
                if _fee_rate_less_than(b, a) or (
                        not _fee_rate_less_than(a, b)
                        and a.contents_hash() < b.contents_hash()):
                    best_i = i
            frame, aid = heads.pop(best_i)
            q = queues[aid]
            lane = config.lane_of(frame)
            res = config.resources_of(frame)
            fits = used[GENERIC_LANE] + res <= \
                config.lane_limits[GENERIC_LANE]
            if lane != GENERIC_LANE and lane < len(config.lane_limits):
                fits = fits and \
                    used[lane] + res <= config.lane_limits[lane]
            if not fits:
                lane_full[lane] = True
                excluded.extend(q)
                queues[aid] = []
                continue
            used[GENERIC_LANE] += res
            if lane != GENERIC_LANE and lane < len(config.lane_limits):
                used[lane] += res
            included.append(frame)
            q.pop(0)
            if q:
                heads.append((q[0], aid))
        return included, excluded, lane_full

    @staticmethod
    def lane_base_fee(included: Sequence, default_base_fee: int,
                      surged: bool) -> int:
        """Lowest included per-op bid under surge, else the ledger base
        fee (reference ``computeLaneBaseFee``)."""
        if not surged or not included:
            return default_base_fee
        return min(f.inclusion_fee() // max(1, f.num_operations())
                   for f in included)
