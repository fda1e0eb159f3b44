"""Online maintenance: the hot-set ranking the partition-group superblock
former consumes.

Only ``HotSetPolicy`` is ported so far; the density-triggered
repartitioning loop (``RepartitionTrigger``) and the online partitioner
land with the migration slice (ROADMAP A.6).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .checkout import get_density_stats


class HotSetPolicy:
    """Hot-partition ranking for the partition-group superblock former
    (``core.checkout.SuperblockGroups``).

    Two O(P) signals, blended lexicographically:

      * a per-partition WAVE-TOUCH EWMA — ``core.checkout.checkout_wave``
        reports every wave's touched partitions via ``touch``; partitions
        absent from a wave decay, so the ranking tracks the served hot set
        rather than all-time popularity;
      * the per-vid run-density EWMA ``DensityStats.per_vid``, aggregated to
        each vid's partition — between two equally-touched partitions the
        DENSER one ranks hotter: its tiles fuse into run copies, so pinning
        it buys more.

    ``remap`` carries the heat through a migration's ``matched_old`` map
    and ``reset`` drops everything (naive ``repartition``).

    Decay is LAZY: ``touch`` only writes the wave's touched partitions and
    stores (ewma-at-last-touch, wave-seen); readers apply the pending
    ``(1-alpha)^(waves - seen)`` decay on the fly, and ``rank`` prunes
    fully-cooled entries so the dict stays bounded by the live hot set."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        # pid -> (EWMA value at last touch, wave it was touched)
        self.touch_ewma: dict[int, tuple[float, int]] = {}
        self.waves = 0

    def weight(self, pid: int) -> float:
        """The partition's touch EWMA as of the current wave."""
        v = self.touch_ewma.get(int(pid))
        if v is None:
            return 0.0
        val, seen = v
        return val * (1.0 - self.alpha) ** (self.waves - seen)

    def touch(self, pids) -> None:
        """Record one wave's touched partitions (duplicates collapse)."""
        self.waves += 1
        a = self.alpha
        for p in {int(q) for q in pids}:
            self.touch_ewma[p] = (self.weight(p) + a, self.waves)

    def partition_density(self, store) -> dict[int, float]:
        """Mean per-vid density EWMA per partition (empty when the store
        has no ``DensityStats`` or it was reset)."""
        stats = get_density_stats(store)
        if stats is None or not stats.per_vid:
            return {}
        n = len(store.vid_to_pid)
        acc: dict[int, list[float]] = {}
        for v, d in stats.per_vid.items():
            if 0 <= int(v) < n:
                pid = int(store.vid_to_pid[int(v)])
                if pid >= 0:
                    acc.setdefault(pid, []).append(float(d))
        return {p: sum(ds) / len(ds) for p, ds in acc.items()}

    def rank(self, store, n_partitions: int) -> np.ndarray:
        """Partitions sorted hot -> cold: touch EWMA first, density EWMA
        as the tiebreak, partition index last (deterministic).  Fully
        cooled entries are pruned here."""
        for p in list(self.touch_ewma):
            if self.weight(p) < 1e-9:
                del self.touch_ewma[p]
        t = np.array([self.weight(p) for p in range(n_partitions)],
                     np.float64)
        dens = self.partition_density(store)
        d = np.array([dens.get(p, 0.0)
                      for p in range(n_partitions)], np.float64)
        return np.lexsort((np.arange(n_partitions), -d, -t))

    def remap(self, matched_old) -> None:
        new: dict[int, tuple[float, int]] = {}
        for i, j in enumerate(np.asarray(matched_old)):
            w = self.weight(int(j)) if int(j) >= 0 else 0.0
            if w > 1e-9:
                new[int(i)] = (w, self.waves)
        self.touch_ewma = new

    def reset(self) -> None:
        self.touch_ewma.clear()


def get_hot_set_policy(store, *, create: bool = False
                       ) -> Optional[HotSetPolicy]:
    """The store's HotSetPolicy (None when absent and ``create`` is False
    or the store forbids attributes)."""
    pol = getattr(store, "_hot_set_policy", None)
    if pol is None and create:
        pol = HotSetPolicy()
        try:
            store._hot_set_policy = pol
        except AttributeError:
            return None
    return pol
