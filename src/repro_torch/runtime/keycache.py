"""Capacity-aware LRU cache for evk / rotation keys / plaintext constants.

The paper's load-save insight (§IV-F) is that constant movement, not
compute, bounds sustained throughput: a pipeline stage whose constants
are already resident costs nothing to "load" for the next batch. The
mapper's ``const_bytes`` accounting (core/trace.py OpCost) already sizes
each stage's resident set, so cache entries are keyed per
``(workload, stage)`` and charged exactly that footprint; eviction is
LRU under a byte capacity — the serving-time mirror of a partition's
constant budget.

Entries may carry a value (device arrays for the mesh backend) or be
pure residency markers (analytic backend, where only the load-time
accounting matters).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Hashable, Optional, Tuple

from repro_torch.runtime.metrics import MetricsRegistry


@dataclasses.dataclass
class CacheEntry:
    key: Hashable
    nbytes: int
    value: object = None
    pinned: bool = False


class KeyCache:
    """LRU over constant footprints with a hard byte capacity.

    ``get_or_load`` returns ``(value, hit, load_seconds)`` where
    ``load_seconds`` is the analytic cost of streaming the entry's bytes
    at ``load_bw`` on a miss (0.0 on a hit). An entry larger than the
    whole capacity is loaded but never retained — every use pays the
    stream, exactly the paper's reload-per-use regime.
    """

    def __init__(self, capacity_bytes: int, load_bw: float = 64e9,
                 metrics: Optional[MetricsRegistry] = None):
        assert capacity_bytes >= 0
        self.capacity_bytes = capacity_bytes
        self.load_bw = load_bw
        self.metrics = metrics or MetricsRegistry()
        self._entries: "OrderedDict[Hashable, CacheEntry]" = OrderedDict()
        self.used_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def load_seconds(self, nbytes: int) -> float:
        return nbytes / self.load_bw if self.load_bw > 0 else 0.0

    # -- core ----------------------------------------------------------------

    def get_or_load(self, key: Hashable, nbytes: int,
                    loader: Optional[Callable[[], object]] = None,
                    pin: bool = False) -> Tuple[object, bool, float]:
        if key in self._entries:
            e = self._entries[key]
            self._entries.move_to_end(key)
            self.metrics.incr("keycache_hits")
            self.metrics.incr("keycache_hit_bytes", e.nbytes)
            return e.value, True, 0.0

        self.metrics.incr("keycache_misses")
        self.metrics.incr("keycache_loaded_bytes", nbytes)
        value = loader() if loader is not None else None
        if nbytes <= self.capacity_bytes:
            self._evict_to(self.capacity_bytes - nbytes)
            self._entries[key] = CacheEntry(key, nbytes, value, pinned=pin)
            self.used_bytes += nbytes
        else:
            self.metrics.incr("keycache_uncacheable")
        return value, False, self.load_seconds(nbytes)

    def _evict_to(self, target_bytes: int) -> None:
        while self.used_bytes > target_bytes:
            victim_key = None
            for k, e in self._entries.items():        # LRU order
                if not e.pinned:
                    victim_key = k
                    break
            if victim_key is None:
                raise RuntimeError(
                    "keycache: pinned entries exceed capacity "
                    f"({self.used_bytes}B used, want <= {target_bytes}B)")
            e = self._entries.pop(victim_key)
            self.used_bytes -= e.nbytes
            self.metrics.incr("keycache_evictions")

    # -- management ----------------------------------------------------------

    def invalidate(self, key: Hashable) -> bool:
        """Drop one entry (e.g. tenant key rotation). Returns found."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self.used_bytes -= e.nbytes
        self.metrics.incr("keycache_invalidations")
        return True

    def has_prefix(self, prefix: Tuple) -> bool:
        """Any resident entry whose tuple-key starts with ``prefix``?
        (The fleet router's cache-affinity warmth probe — e.g.
        ``has_prefix((workload,))`` asks whether any of a workload's
        stage constants survived eviction.)"""
        return any(isinstance(k, tuple) and k[:len(prefix)] == prefix
                   for k in self._entries)

    def invalidate_prefix(self, prefix: Tuple) -> int:
        """Drop every entry whose tuple-key starts with ``prefix``
        (e.g. all stages of one workload). Returns count dropped."""
        victims = [k for k in self._entries
                   if isinstance(k, tuple) and k[:len(prefix)] == prefix]
        for k in victims:
            self.invalidate(k)
        return len(victims)

    def clear(self) -> None:
        self._entries.clear()
        self.used_bytes = 0
