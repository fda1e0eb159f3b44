"""Version-record bipartite graph and CSR utilities.

The bipartite graph G = (V, R, E) (paper §4.1) is stored in CSR form keyed by
version: for version i, ``rlist(i)`` is the sorted int64 array of record ids it
contains.  Record ids are dense row indices into the CVD data block, so the
CSR *is* the split-by-rlist versioning table.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass
class BipartiteGraph:
    """CSR membership: version -> sorted rid array."""

    indptr: np.ndarray   # (n_versions + 1,) int64
    indices: np.ndarray  # (n_edges,) int64, sorted within each version
    n_records: int       # |R| — records ever allocated (dense rid space)

    @classmethod
    def from_rlists(cls, rlists: Sequence[np.ndarray], n_records: int | None = None) -> "BipartiteGraph":
        indptr = np.zeros(len(rlists) + 1, dtype=np.int64)
        for i, r in enumerate(rlists):
            indptr[i + 1] = indptr[i] + len(r)
        if rlists:
            indices = np.concatenate([np.sort(np.asarray(r, dtype=np.int64)) for r in rlists]) \
                if indptr[-1] else np.zeros(0, dtype=np.int64)
        else:
            indices = np.zeros(0, dtype=np.int64)
        if n_records is None:
            n_records = int(indices.max()) + 1 if len(indices) else 0
        return cls(indptr=indptr, indices=indices, n_records=n_records)

    # -- basic accessors ---------------------------------------------------
    @property
    def n_versions(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indptr[-1])

    def rlist(self, vid: int) -> np.ndarray:
        return self.indices[self.indptr[vid]:self.indptr[vid + 1]]

    def version_sizes(self) -> np.ndarray:
        return np.diff(self.indptr)

    def rlists(self) -> list[np.ndarray]:
        return [self.rlist(i) for i in range(self.n_versions)]

    # -- derived quantities --------------------------------------------------
    def edge_weight(self, vi: int, vj: int) -> int:
        """w(vi, vj) = |R(vi) ∩ R(vj)| (paper §4.2)."""
        return int(len(np.intersect1d(self.rlist(vi), self.rlist(vj), assume_unique=True)))

    def distinct_records(self, vids: Iterable[int]) -> int:
        parts = [self.rlist(v) for v in vids]
        if not parts:
            return 0
        return int(len(np.unique(np.concatenate(parts))))

    def vlists(self) -> list[np.ndarray]:
        """Invert the CSR: record -> sorted array of versions (the vlist view)."""
        owners = np.repeat(np.arange(self.n_versions, dtype=np.int64), np.diff(self.indptr))
        order = np.argsort(self.indices, kind="stable")
        rec_sorted = self.indices[order]
        own_sorted = owners[order]
        out: list[np.ndarray] = [np.zeros(0, dtype=np.int64)] * self.n_records
        if len(rec_sorted):
            bounds = np.flatnonzero(np.diff(rec_sorted)) + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(rec_sorted)]])
            for s, e in zip(starts, ends):
                out[int(rec_sorted[s])] = own_sorted[s:e]
        return out


def union_size(rlists: Sequence[np.ndarray]) -> int:
    if not rlists:
        return 0
    return int(len(np.unique(np.concatenate([np.asarray(r) for r in rlists]))))


def intersect_size(a: np.ndarray, b: np.ndarray) -> int:
    return int(len(np.intersect1d(a, b, assume_unique=True)))


def storage_cost(partition_rlists: Sequence[Sequence[np.ndarray]]) -> int:
    """S = Σ_k |R_k| (paper eq. 4.1): distinct records per partition, summed."""
    return sum(union_size(list(p)) for p in partition_rlists)


def checkout_cost(partition_rlists: Sequence[Sequence[np.ndarray]]) -> float:
    """C_avg = Σ_k |V_k||R_k| / n (paper eq. 4.2)."""
    n = sum(len(p) for p in partition_rlists)
    if n == 0:
        return 0.0
    total = sum(len(p) * union_size(list(p)) for p in partition_rlists)
    return total / n
