"""Versioned query layer (paper §2.2): the operations OrpheusDB translates to
SQL, realized as array programs over the split-by-rlist representation.

These are the "advanced querying capabilities for free" that justify the
array-based models over deltas (paper §3.1): every query below is a single
vectorized pass — the delta model would need to materialize every version.

Device-scale variants of the aggregate and membership queries are the
bitmap kernels ``kernels.ops.version_aggregate`` and ``membership_scan``
over bitset vlists (``kernels.ops.build_bitmap``); as in the JAX package,
no query here calls them, and this module is the engine-level numpy
implementation.  Multi-version materialization routes through the
batched checkout engine (core.checkout): ONE fused gather for every version
a query touches, on device a single ``checkout_batched`` kernel launch.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .checkout import checkout_versions, checkout_wave
from .graph import BipartiteGraph


def _is_store(graph) -> bool:
    """PartitionedCVD (or any store exposing vid_to_pid/partitions) — the
    multi-version queries then route through the cross-partition wave
    engine: ONE fused gather for every version the query touches."""
    return hasattr(graph, "vid_to_pid") and hasattr(graph, "partitions")


def _materialize(graph, data, vids, use_kernel):
    if _is_store(graph):
        return checkout_wave(graph, vids, use_kernel=use_kernel)
    return checkout_versions(graph, data, vids, use_kernel=use_kernel)


def version_scan(graph: BipartiteGraph, data: np.ndarray, vid: int,
                 predicate: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """SELECT * FROM VERSION vid OF CVD WHERE predicate."""
    rows = data[graph.rlist(vid)]
    return rows[predicate(rows)]


def versions_with_record(graph: BipartiteGraph, data: np.ndarray,
                         predicate: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Which versions contain >=1 record matching the predicate.
    (e.g. 'versions with a specific gene annotation record')."""
    mask = predicate(data)                     # (n_records,) bool over the pool
    hit = mask[graph.indices]                  # per (version, record) edge
    counts = np.add.reduceat(hit, graph.indptr[:-1]) if graph.n_edges else \
        np.zeros(graph.n_versions, bool)
    sizes = graph.version_sizes()
    counts = np.where(sizes > 0, counts, 0)
    return np.flatnonzero(counts)


def per_version_aggregate(graph: BipartiteGraph, data: np.ndarray, col: int,
                          agg: str = "sum",
                          predicate: Optional[Callable[[np.ndarray], np.ndarray]] = None
                          ) -> np.ndarray:
    """GROUP BY version: aggregate ``col`` over each version's records.
    (e.g. 'aggregate count of tuples with confidence > 0.9, per version')."""
    vals = data[graph.indices, col].astype(np.float64)
    if predicate is not None:
        keep = predicate(data)[graph.indices]
        vals = np.where(keep, vals, 0.0 if agg in ("sum", "count") else np.nan)
        if agg == "count":
            vals = keep.astype(np.float64)
    elif agg == "count":
        vals = np.ones_like(vals)
    out = np.zeros(graph.n_versions, np.float64)
    seg = np.repeat(np.arange(graph.n_versions), graph.version_sizes())
    if agg in ("sum", "count"):
        np.add.at(out, seg, np.nan_to_num(vals))
    elif agg == "max":
        out[:] = -np.inf
        np.maximum.at(out, seg, np.nan_to_num(vals, nan=-np.inf))
    elif agg == "min":
        out[:] = np.inf
        np.minimum.at(out, seg, np.nan_to_num(vals, nan=np.inf))
    elif agg == "mean":
        np.add.at(out, seg, np.nan_to_num(vals))
        cnt = np.maximum(graph.version_sizes(), 1)
        out = out / cnt
    else:
        raise ValueError(agg)
    return out


def diff(graph, data: Optional[np.ndarray], v1: int, v2: int, *,
         use_kernel: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Records in v1 not in v2, and vice versa (the `diff` command).

    ``graph`` may be a BipartiteGraph (+ the record pool ``data``) or a
    PartitionedCVD store (``data`` ignored): the store path materializes
    both versions in ONE fused cross-partition wave, then masks each side by
    global-rid membership — versions in different partitions never touch
    each other's blocks on the host.
    """
    if _is_store(graph):
        rows_a, rows_b = checkout_wave(graph, [v1, v2],
                                       use_kernel=use_kernel)
        ga, gb = graph.global_rlist(v1), graph.global_rlist(v2)
        keep_a = ~np.isin(ga, gb, assume_unique=True)
        keep_b = ~np.isin(gb, ga, assume_unique=True)
        return np.asarray(rows_a)[keep_a], np.asarray(rows_b)[keep_b]
    a, b = graph.rlist(v1), graph.rlist(v2)
    only_a = np.setdiff1d(a, b, assume_unique=True)
    only_b = np.setdiff1d(b, a, assume_unique=True)
    return data[only_a], data[only_b]


def versions_with_bulk_delete(graph: BipartiteGraph, parents: Sequence[Sequence[int]],
                              threshold: int = 100) -> np.ndarray:
    """Versions with > ``threshold`` records deleted vs any parent
    (the intro's 'bulk delete' query)."""
    out = []
    for v in range(graph.n_versions):
        rl = graph.rlist(v)
        for p in parents[v]:
            dropped = len(np.setdiff1d(graph.rlist(p), rl, assume_unique=True))
            if dropped > threshold:
                out.append(v)
                break
    return np.asarray(out, dtype=np.int64)


def join_versions(graph, data: Optional[np.ndarray], v1: int, v2: int,
                  on: int = 0, *, use_kernel: bool = True) -> np.ndarray:
    """Inner join of two versions on attribute ``on`` — the multi-version
    renaming query of §2.2.  Returns concatenated row pairs.

    Both versions materialize in one fused batched-checkout pass (``graph``
    may be a PartitionedCVD store, in which case the pass is ONE
    cross-partition wave even when v1 and v2 live in different partitions);
    the join itself is a vectorized sort-merge (stable sort of the build
    side, binary search per probe key) with output ordered exactly like the
    seed's hash-probe loop: probe order major, build order minor.
    """
    a, b = _materialize(graph, data, [v1, v2], use_kernel)
    a, b = np.asarray(a), np.asarray(b)
    if _is_store(graph):
        data = graph.data
    bo = np.argsort(b[:, on], kind="stable")
    bs = b[bo, on]
    lo = np.searchsorted(bs, a[:, on], side="left")
    hi = np.searchsorted(bs, a[:, on], side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return np.zeros((0, 2 * data.shape[1]), data.dtype)
    ai = np.repeat(np.arange(len(a)), cnt)
    offs = np.concatenate([[0], np.cumsum(cnt)])
    bi = np.arange(total) - np.repeat(offs[:-1], cnt) + np.repeat(lo, cnt)
    return np.concatenate([a[ai], b[bo[bi]]], axis=1)


def join_versions_loop(graph: BipartiteGraph, data: np.ndarray, v1: int,
                       v2: int, on: int = 0) -> np.ndarray:
    """Seed per-row hash-probe join — kept as the oracle for tests."""
    a, b = data[graph.rlist(v1)], data[graph.rlist(v2)]
    keys_b: dict[int, list[int]] = {}
    for i, k in enumerate(b[:, on]):
        keys_b.setdefault(int(k), []).append(i)
    rows = []
    for i, k in enumerate(a[:, on]):
        for j in keys_b.get(int(k), ()):
            rows.append(np.concatenate([a[i], b[j]]))
    return np.stack(rows) if rows else np.zeros((0, 2 * data.shape[1]), data.dtype)
