"""Partitioned CVD store (paper §4): the physical realization of a
partitioning — one (data block, versioning CSR) pair per partition.

Each version lives in exactly ONE partition; records may be duplicated across
partitions.  Checkout touches a single partition: local-rid gather from that
partition's data block.  The store carries the torch ``device`` its
superblocks upload to and its kernels run on: the card unless the caller
names the CPU.

Cost accounting matches the paper exactly:
    S      = Σ_k |R_k|                    (eq 4.1)
    C_avg  = Σ_k |V_k| |R_k| / n          (eq 4.2)
    C_i    = |R_k| where v_i ∈ P_k        (App. D.1 linear cost model)

The write path (``commit_version``/``commit_many``) and incremental
migration (``apply_migration``) land with their slices (ROADMAP A.5, A.6).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from ..kernels.ops import resolve_device
from .checkout import _no_journal, checkout_partitioned, evict_superblocks
from .graph import BipartiteGraph

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Partition:
    pid: int
    vids: np.ndarray              # versions assigned here
    grids: np.ndarray             # global rids stored in this partition (sorted)
    block: np.ndarray             # (|grids|, n_attrs) data rows
    indptr: np.ndarray            # local CSR: version -> local rid ranges
    indices: np.ndarray           # local rids (positions into block)
    vid_to_slot: dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def n_records(self) -> int:
        return len(self.grids)

    @property
    def n_versions(self) -> int:
        return len(self.vids)

    def local_rlist(self, vid: int) -> np.ndarray:
        s = self.vid_to_slot[vid]
        return self.indices[self.indptr[s]:self.indptr[s + 1]]


class PartitionedCVD:
    """A CVD materialized under a partitioning assignment.

    ``device`` (None = the card; raises when there is none) is where the
    store's superblocks live and its kernels run; ``device="cpu"`` runs the
    kernels' plain torch versions.  ``superblock_max_bytes`` (None =
    unlimited) caps the device-resident superblock the wave engine may pin
    for this store; over-budget waves route through partition groups."""

    superblock_max_bytes: Optional[int] = None

    def __init__(self, graph: BipartiteGraph, data: np.ndarray,
                 assignment: np.ndarray, *, device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.data = data
        self.assignment = np.asarray(assignment, dtype=np.int64)
        self.partitions: list[Partition] = []
        self.vid_to_pid: np.ndarray = np.full(graph.n_versions, -1, np.int64)
        self.epoch = -1   # bumped by every _build; keys the superblock cache
        self._build()

    def _build(self) -> None:
        self.partitions = []
        self.epoch += 1
        for k in np.unique(self.assignment):
            vids = np.flatnonzero(self.assignment == k)
            self.partitions.append(build_partition(self.graph, self.data, int(k), vids))
            self.vid_to_pid[vids] = len(self.partitions) - 1

    def repartition(self, assignment: np.ndarray) -> None:
        """Rebuild under a new assignment from scratch (naive migration);
        bumps the epoch and EAGERLY evicts cached superblocks — pinned
        partition-GROUP superblocks included — so stale device copies are
        released immediately.  Any attached hot-set ranking is dropped too
        (partition indices changed meaning)."""
        assignment = np.asarray(assignment, dtype=np.int64)
        _no_journal(self, "repartition")
        self.assignment = assignment
        self.vid_to_pid = np.full(self.graph.n_versions, -1, np.int64)
        self._build()
        evict_superblocks(self)
        pol = getattr(self, "_hot_set_policy", None)
        if pol is not None:
            pol.reset()

    # -- paper cost model ----------------------------------------------------
    def storage_cost(self) -> int:
        return sum(p.n_records for p in self.partitions)

    def checkout_cost(self, vid: int) -> int:
        return self.partitions[self.vid_to_pid[vid]].n_records

    def avg_checkout_cost(self) -> float:
        return sum(p.n_versions * p.n_records for p in self.partitions) / self.graph.n_versions

    # -- data plane ------------------------------------------------------------
    def checkout(self, vid: int) -> np.ndarray:
        p = self.partitions[self.vid_to_pid[vid]]
        return p.block[p.local_rlist(vid)]

    def global_rlist(self, vid: int) -> np.ndarray:
        """The version's GLOBAL rids (sorted) — local rids mapped back
        through the partition's grid set."""
        p = self.partitions[self.vid_to_pid[vid]]
        return p.grids[p.local_rlist(vid)]

    def checkout_many(self, vids, *, use_kernel: bool = True,
                      engine: str = "wave") -> list[np.ndarray]:
        """Batched multi-version checkout.  Default engine="wave": the whole
        wave is ONE fused gather over the epoch-cached device-resident
        superblock; engine="perpart" keeps one launch per partition."""
        return checkout_partitioned(self, vids, use_kernel=use_kernel,
                                    engine=engine)

    def checkout_bytes_touched(self, vid: int) -> int:
        """Bytes streamed for the checkout under the sequential-scan (hash
        join probe) model of App. D.1: the whole partition block."""
        p = self.partitions[self.vid_to_pid[vid]]
        return p.block.nbytes


def build_partition(graph: BipartiteGraph, data: np.ndarray, pid: int,
                    vids: np.ndarray) -> Partition:
    rls = [graph.rlist(int(v)) for v in vids]
    cat = np.concatenate(rls) if rls else np.zeros(0, np.int64)
    grids = np.unique(cat)
    indptr = np.zeros(len(vids) + 1, dtype=np.int64)
    for i, rl in enumerate(rls):
        indptr[i + 1] = indptr[i] + len(rl)
    # global -> local rid remap: one binary search over the sorted grid set
    indices = np.searchsorted(grids, cat).astype(np.int64)
    block = data[grids] if len(grids) else np.zeros((0, data.shape[1]), data.dtype)
    return Partition(pid=pid, vids=np.asarray(vids, np.int64), grids=grids,
                     block=block, indptr=indptr, indices=indices,
                     vid_to_slot={int(v): i for i, v in enumerate(vids)})


def single_partition(graph: BipartiteGraph, data: np.ndarray, *,
                     device=None) -> PartitionedCVD:
    return PartitionedCVD(graph, data, np.zeros(graph.n_versions, np.int64),
                          device=device)


def per_version_partitions(graph: BipartiteGraph, data: np.ndarray, *,
                           device=None) -> PartitionedCVD:
    return PartitionedCVD(graph, data,
                          np.arange(graph.n_versions, dtype=np.int64),
                          device=device)


def store_from_arrays(indptr, indices, n_records: int, data, assignment, *,
                      device=None) -> PartitionedCVD:
    """A store built from the plain arrays that define one: the version ->
    rid CSR (``indptr``, ``indices``, ``n_records``), the record pool
    ``data`` and a partition ``assignment`` (e.g. LyreSplit's).  The arrays
    are copied, so the store owns its state."""
    graph = BipartiteGraph(indptr=np.array(indptr, dtype=np.int64),
                           indices=np.array(indices, dtype=np.int64),
                           n_records=int(n_records))
    return PartitionedCVD(graph, np.array(data),
                          np.array(assignment, dtype=np.int64),
                          device=device)
