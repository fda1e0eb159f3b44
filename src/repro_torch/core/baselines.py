"""Competing partitioners from NScale [42], re-implemented per paper §5.1.

Both operate on the version-record *bipartite* graph (record sets), which is
why they are orders of magnitude slower than LYRESPLIT (paper Figs 9-10).
Plain numpy over ``core.graph``: they run on the host, as in the paper.

AGGLO  (NScale Alg. 4): shingle-ordered agglomerative merging under a
        per-partition record cap BC; binary-search BC for a storage budget.
KMEANS (NScale Alg. 5): K centroids (record sets), assign to max-overlap
        centroid, centroid = union of members; refine by single-version moves
        minimizing total storage; binary-search K for a storage budget.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .graph import BipartiteGraph, union_size


@dataclasses.dataclass
class BaselineResult:
    assignment: np.ndarray
    storage: int
    checkout: float
    wall_s: float
    param: float            # the BC or K that produced this partitioning


def _partition_cost(graph: BipartiteGraph, assignment: np.ndarray) -> tuple[int, float]:
    n = graph.n_versions
    storage = 0
    total_c = 0.0
    for k in np.unique(assignment):
        vids = np.flatnonzero(assignment == k)
        r = graph.distinct_records(vids)
        storage += r
        total_c += len(vids) * r
    return storage, total_c / n


# ---------------------------------------------------------------- AGGLO ----
def _shingles(rlist: np.ndarray, n_hashes: int, mods: np.ndarray, mults: np.ndarray) -> np.ndarray:
    """Min-hash signature of a record set."""
    if len(rlist) == 0:
        return np.zeros(n_hashes, dtype=np.int64)
    h = (rlist[None, :] * mults[:, None] + mods[:, None]) % np.int64(2_147_483_647)
    return h.min(axis=1)


def agglo(graph: BipartiteGraph, bc: int, n_hashes: int = 16, window: int = 100,
          seed: int = 0, max_rounds: int = 8) -> np.ndarray:
    """One AGGLO run at partition capacity ``bc`` -> assignment array."""
    rng = np.random.default_rng(seed)
    mults = rng.integers(1, 1 << 30, size=n_hashes, dtype=np.int64)
    mods = rng.integers(0, 1 << 30, size=n_hashes, dtype=np.int64)
    n = graph.n_versions
    parts: list[set[int]] = [{v} for v in range(n)]
    recs: list[np.ndarray] = [graph.rlist(v).copy() for v in range(n)]
    sigs = [_shingles(r, n_hashes, mods, mults) for r in recs]

    # τ via uniform sampling of pairwise common-shingle counts
    pairs = rng.integers(0, n, size=(min(200, n * n), 2))
    common = [int((sigs[a] == sigs[b]).sum()) for a, b in pairs if a != b]
    tau = max(1, int(np.mean(common))) if common else 1

    for _ in range(max_rounds):
        order = sorted(range(n), key=lambda i: tuple(sigs[i]))  # shingle order
        merged_any = False
        alive = [i for i in order if parts[i]]
        pos = {p: i for i, p in enumerate(alive)}
        for p in list(alive):
            if not parts[p]:
                continue
            best, best_c = -1, tau - 1
            for q in alive[pos[p] + 1: pos[p] + 1 + window]:
                if not parts[q] or q == p:
                    continue
                c = int((sigs[p] == sigs[q]).sum())
                if c > best_c:
                    merged = union_size([recs[p], recs[q]])
                    if merged <= bc:
                        best, best_c = q, c
            if best >= 0:
                parts[p] |= parts[best]
                recs[p] = np.union1d(recs[p], recs[best])
                sigs[p] = _shingles(recs[p], n_hashes, mods, mults)
                parts[best] = set()
                merged_any = True
        if not merged_any:
            break
    assignment = np.full(n, -1, dtype=np.int64)
    k = 0
    for p in range(n):
        if parts[p]:
            assignment[list(parts[p])] = k
            k += 1
    return assignment


# --------------------------------------------------------------- KMEANS ----
def kmeans(graph: BipartiteGraph, k: int, bc: Optional[int] = None,
           iters: int = 10, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = graph.n_versions
    k = min(k, n)
    seeds = rng.choice(n, size=k, replace=False)
    centroids: list[np.ndarray] = [graph.rlist(int(s)).copy() for s in seeds]
    assignment = np.zeros(n, dtype=np.int64)

    for it in range(iters):
        # assign to max-common-records centroid (respecting BC when set)
        sizes = np.zeros(k, dtype=np.int64)
        for v in range(n):
            rl = graph.rlist(v)
            overlaps = np.array([len(np.intersect1d(rl, c, assume_unique=True))
                                 for c in centroids])
            order = np.argsort(-overlaps)
            chosen = int(order[0])
            if bc is not None:
                for cand in order:
                    if sizes[cand] + len(rl) <= bc:
                        chosen = int(cand)
                        break
            assignment[v] = chosen
            sizes[chosen] += len(rl)
        # centroid = union of member record sets
        new_centroids = []
        for c in range(k):
            vids = np.flatnonzero(assignment == c)
            if len(vids):
                new_centroids.append(np.unique(np.concatenate([graph.rlist(v) for v in vids])))
            else:
                new_centroids.append(centroids[c])
        centroids = new_centroids
    return assignment


# ------------------------------------------------- budgeted binary search --
def agglo_for_budget(graph: BipartiteGraph, gamma: int, seed: int = 0,
                     max_iters: int = 12, tol: float = 0.99,
                     time_budget_s: float = 3600.0) -> BaselineResult:
    t0 = time.perf_counter()
    lo, hi = graph.version_sizes().max(), graph.n_edges
    best: Optional[tuple[np.ndarray, int, float, int]] = None
    for _ in range(max_iters):
        bc = int((lo + hi) // 2)
        a = agglo(graph, bc, seed=seed)
        s, c = _partition_cost(graph, a)
        if s <= gamma and (best is None or c < best[2]):
            best = (a, s, c, bc)
        # smaller BC -> more partitions -> more storage
        if s > gamma:
            lo = bc
        else:
            hi = bc
        if best is not None and tol * gamma <= best[1] <= gamma:
            break
        if time.perf_counter() - t0 > time_budget_s:
            break
    if best is None:
        a = agglo(graph, int(graph.n_edges), seed=seed)
        s, c = _partition_cost(graph, a)
        best = (a, s, c, graph.n_edges)
    return BaselineResult(assignment=best[0], storage=best[1], checkout=best[2],
                          wall_s=time.perf_counter() - t0, param=best[3])


def kmeans_for_budget(graph: BipartiteGraph, gamma: int, seed: int = 0,
                      max_iters: int = 8, tol: float = 0.99,
                      time_budget_s: float = 3600.0) -> BaselineResult:
    t0 = time.perf_counter()
    lo, hi = 1, graph.n_versions
    best: Optional[tuple[np.ndarray, int, float, int]] = None
    for _ in range(max_iters):
        k = max(1, (lo + hi) // 2)
        a = kmeans(graph, k, seed=seed)
        s, c = _partition_cost(graph, a)
        if s <= gamma and (best is None or c < best[2]):
            best = (a, s, c, k)
        # more partitions -> more storage
        if s > gamma:
            hi = k
        else:
            lo = k
        if best is not None and tol * gamma <= best[1] <= gamma:
            break
        if time.perf_counter() - t0 > time_budget_s:
            break
    if best is None:
        a = kmeans(graph, 1, seed=seed)
        s, c = _partition_cost(graph, a)
        best = (a, s, c, 1)
    return BaselineResult(assignment=best[0], storage=best[1], checkout=best[2],
                          wall_s=time.perf_counter() - t0, param=best[3])
