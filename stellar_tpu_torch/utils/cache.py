"""RandomEvictionCache: a fixed-size map with uniform random eviction —
the port's copy of ``stellar_tpu/utils/cache.py``.

The contract of the reference's ``src/util/RandomEvictionCache.h`` (the
0xffff-entry signature-verify cache, ``crypto/SecretKey.cpp:44-48``):
O(1) put, get and exists, a uniformly random resident entry evicted when
full, and hit and miss counters for the metrics. The eviction draws from
an explicit ``random.Random`` that the caller may pass (a seeded one
makes eviction reproducible).
"""

from __future__ import annotations

import random
from typing import Dict, Generic, List, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")

__all__ = ["RandomEvictionCache"]


class RandomEvictionCache(Generic[K, V]):
    __slots__ = ("_max", "_map", "_keys", "_pos", "_rng", "hits", "misses")

    def __init__(self, max_size: int, rng: Optional[random.Random] = None):
        if max_size <= 0:
            raise ValueError("max_size must be positive")
        self._max = max_size
        self._map: Dict[K, V] = {}
        self._keys: List[K] = []        # dense array for an O(1) random pick
        self._pos: Dict[K, int] = {}    # key -> index in _keys
        self._rng = rng or random.Random()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    def max_size(self) -> int:
        return self._max

    def put(self, key: K, value: V) -> None:
        if key in self._map:
            self._map[key] = value
            return
        if len(self._map) >= self._max:
            self._evict_one()
        self._map[key] = value
        self._pos[key] = len(self._keys)
        self._keys.append(key)

    def _remove_at(self, i: int) -> None:
        victim = self._keys[i]
        last = self._keys[-1]
        self._keys[i] = last
        self._pos[last] = i
        self._keys.pop()
        del self._pos[victim]
        del self._map[victim]

    def _evict_one(self) -> None:
        self._remove_at(self._rng.randrange(len(self._keys)))

    def exists(self, key: K, count_stats: bool = True) -> bool:
        ok = key in self._map
        if count_stats:
            if ok:
                self.hits += 1
            else:
                self.misses += 1
        return ok

    def get(self, key: K) -> V:
        """Counts a hit or a miss, as the reference's maybeGet and get
        pairing does."""
        if key not in self._map:
            self.misses += 1
            raise KeyError(key)
        self.hits += 1
        return self._map[key]

    def maybe_get(self, key: K) -> Optional[V]:
        if key in self._map:
            self.hits += 1
            return self._map[key]
        self.misses += 1
        return None

    def erase_if(self, pred) -> None:
        doomed = [k for k in self._keys if pred(self._map[k])]
        for k in doomed:
            self._remove_at(self._pos[k])

    def clear(self) -> None:
        self._map.clear()
        self._keys.clear()
        self._pos.clear()
