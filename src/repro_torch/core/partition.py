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

The store is live: ``commit_version``/``commit_many`` append versions (one
ingest wave, one epoch bump, the superblock extended in place), and
``plan_migration`` diffs the current partitioning against a target
assignment into a ``MigrationPlan`` — per new partition, the exact
(move | insert) row segments plus the paper's intelligent-vs-naive
record-row costs — which ``apply_migration`` adopts by morphing the
partition set (old blocks are the copy source; only new rows gather from
base data) and ``core.checkout.migrate_superblock`` replays against the
device-resident superblock (paper §4.3).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np

from ..kernels.build import KernelError
from ..kernels.ops import resolve_device
from .checkout import (checkout_partitioned, evict_superblocks,
                       migrate_groups, refresh_superblocks_after_commit,
                       take_group_superblocks)
from .datamodels import diff_against_parents
from .faults import fault_point
from .graph import BipartiteGraph, intersect_size
from .journal import _enc, get_journal

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
        (partition indices changed meaning).

        Journaled (``core.journal``): the ``repartition`` record is
        appended + fsynced BEFORE the in-memory rebuild — a failed append
        leaves the store untouched (plain retry), and a crash after the
        append replays the rebuild deterministically."""
        assignment = np.asarray(assignment, dtype=np.int64)
        j = get_journal(self)
        if j is not None:
            j.append("repartition", {"assignment": _enc(assignment),
                                     "epoch_after": int(self.epoch) + 1},
                     sync=True)
        self.assignment = assignment
        self.vid_to_pid = np.full(self.graph.n_versions, -1, np.int64)
        self._build()
        evict_superblocks(self)
        pol = getattr(self, "_hot_set_policy", None)
        if pol is not None:
            pol.reset()

    def commit_version(self, rlist, *, parent: Optional[int] = None,
                       new_rows: Optional[np.ndarray] = None,
                       pid: Optional[int] = None) -> int:
        """Append ONE new version to the live store — the write path's
        minimal unit (the paper's commit, on the partitioned layout).

        ``rlist`` are the GLOBAL rids the version contains; it may reference
        existing records and the ``len(new_rows)`` fresh rids allocated
        densely at the end of the base data.  The version lands in its
        parent's partition (the online append rule) unless ``pid`` names a
        partition label; a parentless commit opens a fresh partition.  Bumps
        the epoch; superblock maintenance is TARGETED
        (``core.checkout.refresh_superblocks_after_commit``): the receiving
        partition's superblock is extended in place, cold pinned groups
        revalidate at the new epoch.

        TRANSACTIONAL in memory: the staged arrays AND the receiving
        partition's rebuild happen before any field swap, so a failure in
        staging (allocator, injected ``ingest.commit`` fault) leaves the
        store bit-identical; the COMMIT half is pure field swaps.

        Journaled (``core.journal``): the commit record is appended +
        fsynced AFTER staging and BEFORE the swap.  A failed append mutates
        nothing (retry-safe); once ``commit_version`` returns, the commit
        survives any crash — the zero-RPO contract ``StoreDurability``
        replays on restore."""
        rlist = np.unique(np.asarray(rlist, dtype=np.int64))
        if new_rows is not None and len(new_rows) == 0:
            new_rows = None
        if new_rows is not None:
            new_rows = np.ascontiguousarray(
                np.asarray(new_rows, dtype=self.data.dtype))
            if new_rows.ndim != 2 or new_rows.shape[1] != self.data.shape[1]:
                raise ValueError(
                    f"new_rows shape {new_rows.shape} does not match the "
                    f"base data width {self.data.shape[1]}")
        k = 0 if new_rows is None else len(new_rows)
        n0 = int(self.graph.n_records)
        if len(rlist) and (rlist[0] < 0 or rlist[-1] >= n0 + k):
            raise ValueError(
                f"rlist references rid {int(rlist[-1])} outside "
                f"[0, {n0 + k}) (existing records + new rows)")
        if parent is not None:
            parent = int(parent)
            if not 0 <= parent < self.graph.n_versions:
                raise ValueError(f"parent vid {parent} out of range")
        if pid is None:
            pid = (int(self.assignment[parent]) if parent is not None
                   else int(self.assignment.max()) + 1
                   if len(self.assignment) else 0)
        pid = int(pid)
        vid = int(self.graph.n_versions)
        # -- STAGE: everything off to the side, store still untouched -------
        data = (self.data if new_rows is None
                else np.concatenate([self.data, new_rows], axis=0))
        indptr = np.append(self.graph.indptr,
                           self.graph.indptr[-1] + len(rlist))
        indices = np.concatenate([self.graph.indices, rlist])
        assignment = np.append(self.assignment, pid)
        # the receiving partition rebuilds AGAINST THE STAGED state
        staged_graph = BipartiteGraph(indptr=indptr, indices=indices,
                                      n_records=n0 + k)
        vids = np.flatnonzero(assignment == pid)
        part = build_partition(staged_graph, data, pid, vids)
        slot = next((i for i, p in enumerate(self.partitions)
                     if p.pid == pid), None)
        old_grids = (np.zeros(0, np.int64) if slot is None
                     else self.partitions[slot].grids)
        edge_w = (intersect_size(self.graph.rlist(parent), rlist)
                  if parent is not None else 0)
        # fires at the stage->journal boundary: store AND journal are both
        # still untouched, so a plain retry re-stages from scratch
        fault_point("ingest.commit", self)
        j = get_journal(self)
        if j is not None:
            j.append("commit", {
                "vid": vid,
                "parent": parent,
                "pid": pid,
                "rlist": _enc(rlist),
                "new_rows": None if new_rows is None else _enc(new_rows),
                "epoch_after": int(self.epoch) + 1,
                "n_versions_after": vid + 1}, sync=True)
        # -- COMMIT: pure field swaps (nothing below can fail) --------------
        self.data = data
        self.graph.indptr = indptr
        self.graph.indices = indices
        self.graph.n_records = n0 + k
        self.assignment = assignment
        if slot is None:
            self.partitions.append(part)
            slot = len(self.partitions) - 1
        else:
            self.partitions[slot] = part
        self.vid_to_pid = np.append(self.vid_to_pid, -1)
        self.vid_to_pid[vids] = slot
        self.epoch += 1
        _log_commit(self, vid, parent, edge_w, len(rlist))
        _refresh_after_commit(self, {slot: old_grids}, [vid])
        return vid

    def commit_many(self, commits: Sequence[dict], *,
                    extend_superblocks: bool = True) -> list[int]:
        """Batch K commits into ONE ingest wave — the write-side twin of
        ``checkout_many``'s wave engine.

        Each element of ``commits`` is a mapping describing one commit:

        * ``rlist`` (+ optional ``new_rows``) — the explicit form
          ``commit_version`` takes, or
        * ``table`` — a full row table; the delta against the parent's rows
          is extracted by ``core.datamodels.diff_against_parents`` (matched
          rows keep their parent rids, the rest become fresh rows),

        plus optional ``parent`` / ``pid``.  A commit may name a parent
        staged EARLIER IN THE SAME WAVE (its vid is ``vid0 + i``) — chains
        ingest in one call.

        One wave does the batch's work once: a single bulk CSR /
        assignment / data append, ONE partition rebuild per touched
        partition label, ONE journal record (``commit.batch``) fsynced once
        for the whole wave with all-or-nothing replay semantics, ONE epoch
        bump, and targeted superblock maintenance
        (``refresh_superblocks_after_commit``) that extends the touched
        superblocks in place with BN-aligned new tiles — ONE
        ``segment_append`` launch each.

        TRANSACTIONAL exactly like ``commit_version``: staging (including
        every partition rebuild) completes before the journal append, and
        the COMMIT half is pure field swaps.  Fault sites:
        ``ingest.extract`` at entry (nothing staged), ``ingest.commit`` at
        the stage->journal boundary (store and journal untouched).

        Returns the new vids, ``[vid0, vid0 + K)``."""
        commits = [dict(c) for c in commits]
        if not commits:
            return []
        fault_point("ingest.extract", self)
        vid0 = int(self.graph.n_versions)
        n0 = int(self.graph.n_records)
        width = self.data.shape[1]
        # -- STAGE 1: per-commit delta extraction against (possibly staged)
        #    parents; the store is read, never written --------------------
        data_blocks: list[np.ndarray] = [self.data]
        n_cur = n0
        cat_cache: list[Optional[np.ndarray]] = [None]

        def staged_rows(rids: np.ndarray) -> np.ndarray:
            # gather parent rows across the staged blocks; concatenate
            # lazily and only re-concatenate after the staged data grew
            if len(data_blocks) == 1:
                return self.data[rids]
            if cat_cache[0] is None or len(cat_cache[0]) < n_cur:
                cat_cache[0] = np.concatenate(data_blocks, axis=0)
            return cat_cache[0][rids]

        assignment = self.assignment.copy()
        rlists: list[np.ndarray] = []
        parents: list[Optional[int]] = []
        pids: list[int] = []
        new_blocks: list[Optional[np.ndarray]] = []
        for i, c in enumerate(commits):
            vid = vid0 + i
            parent = c.get("parent")
            if parent is not None:
                parent = int(parent)
                if not 0 <= parent < vid:
                    raise ValueError(
                        f"commit #{i}: parent vid {parent} out of range "
                        f"[0, {vid}) (earlier wave entries are allowed)")
            if c.get("table") is not None:
                if parent is None:
                    raise ValueError(
                        f"commit #{i}: table-form commits need a parent "
                        f"to diff against")
                table = np.ascontiguousarray(
                    np.asarray(c["table"], dtype=self.data.dtype))
                if table.ndim != 2 or table.shape[1] != width:
                    raise ValueError(
                        f"commit #{i}: table shape {table.shape} does not "
                        f"match the base data width {width}")
                p_rids = (self.graph.rlist(parent) if parent < vid0
                          else rlists[parent - vid0])
                matched, new_rows = diff_against_parents(
                    table, staged_rows(p_rids), p_rids)
                if len(new_rows) == 0:
                    new_rows = None
                k = 0 if new_rows is None else len(new_rows)
                rlist = np.unique(np.concatenate(
                    [matched, n_cur + np.arange(k, dtype=np.int64)]))
            else:
                rlist = np.unique(np.asarray(c["rlist"], dtype=np.int64))
                new_rows = c.get("new_rows")
                if new_rows is not None and len(new_rows) == 0:
                    new_rows = None
                if new_rows is not None:
                    new_rows = np.ascontiguousarray(
                        np.asarray(new_rows, dtype=self.data.dtype))
                    if new_rows.ndim != 2 or new_rows.shape[1] != width:
                        raise ValueError(
                            f"commit #{i}: new_rows shape {new_rows.shape} "
                            f"does not match the base data width {width}")
                k = 0 if new_rows is None else len(new_rows)
                if len(rlist) and (rlist[0] < 0 or rlist[-1] >= n_cur + k):
                    raise ValueError(
                        f"commit #{i}: rlist references rid "
                        f"{int(rlist[-1])} outside [0, {n_cur + k})")
            pid = c.get("pid")
            if pid is None:
                pid = (int(assignment[parent]) if parent is not None
                       else int(assignment.max()) + 1
                       if len(assignment) else 0)
            pid = int(pid)
            if new_rows is not None:
                data_blocks.append(new_rows)
                n_cur += k
            assignment = np.append(assignment, pid)
            rlists.append(rlist)
            parents.append(parent)
            pids.append(pid)
            new_blocks.append(new_rows)
        # -- STAGE 2: one bulk CSR append + one rebuild per touched
        #    partition label ---------------------------------------------
        counts = np.array([len(r) for r in rlists], dtype=np.int64)
        indptr = np.concatenate([
            self.graph.indptr,
            self.graph.indptr[-1] + np.cumsum(counts)])
        indices = np.concatenate([self.graph.indices] + rlists)
        data = (data_blocks[0] if len(data_blocks) == 1
                else np.concatenate(data_blocks, axis=0))
        staged_graph = BipartiteGraph(indptr=indptr, indices=indices,
                                      n_records=n_cur)
        slot_of = {p.pid: s for s, p in enumerate(self.partitions)}
        staged_parts: dict[int, Partition] = {}
        slot_for_pid: dict[int, int] = {}
        old_grids: dict[int, np.ndarray] = {}
        next_slot = len(self.partitions)
        for pid in sorted(set(pids)):
            vids = np.flatnonzero(assignment == pid)
            staged_parts[pid] = build_partition(staged_graph, data, pid, vids)
            s = slot_of.get(pid)
            if s is None:
                s, next_slot = next_slot, next_slot + 1
                old_grids[s] = np.zeros(0, np.int64)
            else:
                old_grids[s] = self.partitions[s].grids
            slot_for_pid[pid] = s
        edge_ws = [intersect_size(staged_graph.rlist(p), rlists[i])
                   if (p := parents[i]) is not None else 0
                   for i in range(len(commits))]
        # fires at the stage->journal boundary: store AND journal are both
        # still untouched, so a plain retry re-stages from scratch
        fault_point("ingest.commit", self)
        j = get_journal(self)
        if j is not None:
            # group commit: ONE fsynced record covers the whole wave —
            # replay applies all K commits or none of them
            j.append("commit.batch", {
                "vid0": vid0,
                "commits": [{
                    "vid": vid0 + i,
                    "parent": parents[i],
                    "pid": pids[i],
                    "rlist": _enc(rlists[i]),
                    "new_rows": (None if new_blocks[i] is None
                                 else _enc(new_blocks[i]))}
                    for i in range(len(commits))],
                "epoch_after": int(self.epoch) + 1,
                "n_versions_after": vid0 + len(commits)}, sync=True)
        # -- COMMIT: pure field swaps (nothing below can fail) --------------
        self.data = data
        self.graph.indptr = indptr
        self.graph.indices = indices
        self.graph.n_records = n_cur
        self.assignment = assignment
        self.vid_to_pid = np.concatenate(
            [self.vid_to_pid, np.full(len(commits), -1, np.int64)])
        for pid in sorted(slot_for_pid):   # new slots append in order
            part, s = staged_parts[pid], slot_for_pid[pid]
            if s < len(self.partitions):
                self.partitions[s] = part
            else:
                self.partitions.append(part)
            self.vid_to_pid[part.vids] = s
        self.epoch += 1
        for i in range(len(commits)):
            _log_commit(self, vid0 + i, parents[i], edge_ws[i],
                        int(counts[i]))
        vids = list(range(vid0, vid0 + len(commits)))
        _refresh_after_commit(self, old_grids, vids,
                              extend=extend_superblocks)
        return vids

    def apply_migration(self, plan: "MigrationPlan") -> None:
        """Adopt a ``plan_migration`` plan IN PLACE: morph the partition set
        segment-by-segment instead of rebuilding from scratch.

        Rows the plan sourced from an existing partition are block-copied
        out of the OLD partition blocks (the morph half of the paper's
        intelligent migration); only genuinely new rows gather from the
        base data.  Bumps the epoch and eagerly evicts cached WHOLE-STORE
        superblocks — grab the old one with ``core.checkout.take_superblock``
        FIRST to migrate it incrementally.  Pinned partition-GROUP
        superblocks are detached before the morph and migrated-or-evicted
        PER GROUP afterwards (``core.checkout.migrate_groups``), and any
        attached hot-set ranking is remapped through ``plan.matched_old``.

        TRANSACTIONAL: STAGE builds the whole new partition set off to the
        side, reading but never mutating the store; COMMIT swaps the
        fields, bumps the epoch and migrates caches.  A failure during
        staging (including an injected ``migration.commit`` fault at the
        boundary) leaves the store bit-identical to its pre-migration state
        — same epoch, same partitions, same pinned groups.

        Journaled (``core.journal``) as an intent->commit pair bracketing
        the stage: the buffered ``migration.intent`` record lands after
        staging, the fsynced ``migration.commit`` record BEFORE the swap.
        An intent without a commit is the crashed-mid-migration signature
        replay ignores; a failed commit-record append leaves the store
        unmutated (retry restages), and once the record is durable the
        swap is deterministic."""
        if len(plan.assignment) != self.graph.n_versions:
            raise ValueError(
                f"plan covers {len(plan.assignment)} versions, store has "
                f"{self.graph.n_versions}")
        # -- STAGE: read-only against the store ------------------------------
        old_parts = self.partitions
        data = self.data
        new_parts: list[Partition] = []
        vid_to_pid = np.full(self.graph.n_versions, -1, np.int64)
        for i, (label, vids, grids) in enumerate(
                zip(plan.new_labels, plan.new_vids, plan.new_grids)):
            d = data.shape[1]
            block = np.empty((len(grids), d), data.dtype) if len(grids) \
                else np.zeros((0, d), data.dtype)
            spid = plan.src_pid_rows[i]
            sloc = plan.src_loc_rows[i]
            for j in np.unique(spid[spid >= 0]):
                m = spid == j
                block[m] = old_parts[int(j)].block[sloc[m]]
            miss = spid < 0
            if miss.any():
                block[miss] = data[grids[miss]]
            rls = [self.graph.rlist(int(v)) for v in vids]
            cat = np.concatenate(rls) if rls else np.zeros(0, np.int64)
            indptr = np.zeros(len(vids) + 1, dtype=np.int64)
            for k, rl in enumerate(rls):
                indptr[k + 1] = indptr[k] + len(rl)
            indices = np.searchsorted(grids, cat).astype(np.int64)
            new_parts.append(Partition(
                pid=int(label), vids=np.asarray(vids, np.int64), grids=grids,
                block=block, indptr=indptr, indices=indices,
                vid_to_slot={int(v): k for k, v in enumerate(vids)}))
            vid_to_pid[vids] = i
        new_assignment = plan.assignment.copy()
        j = get_journal(self)
        if j is not None:
            j.append_advisory("migration.intent",
                              {"assignment": _enc(new_assignment),
                               "epoch_before": int(self.epoch)})
        fault_point("migration.commit", self)
        if j is not None:
            j.append("migration.commit",
                     {"assignment": _enc(new_assignment),
                      "epoch_after": int(self.epoch) + 1}, sync=True)
        # -- COMMIT: point of no return --------------------------------------
        taken_groups = take_group_superblocks(self)
        self.assignment = new_assignment
        self.partitions = new_parts
        self.vid_to_pid = vid_to_pid
        self.epoch += 1
        evict_superblocks(self)
        pol = getattr(self, "_hot_set_policy", None)
        if pol is not None:
            pol.remap(plan.matched_old)
        if taken_groups:
            migrate_groups(self, plan, taken_groups)

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


def _refresh_after_commit(store: PartitionedCVD, old_grids: dict,
                          vids: list[int], *, extend: bool = True) -> None:
    """``refresh_superblocks_after_commit`` behind the commit's
    warn-and-continue guard.  Device-state refresh is an optimization:
    every superblock cache is epoch-keyed and rebuilds lazily, so a
    transient failure must not torpedo a landed commit (a retry would
    double-append the versions).  A ``KernelError`` is not transient and
    propagates, carrying the landed ``vids`` as ``committed_vids`` so that
    no caller retries the commit."""
    try:
        refresh_superblocks_after_commit(store, old_grids, extend=extend)
    except KernelError as exc:
        exc.committed_vids = list(vids)
        raise
    except Exception:
        logger.warning("post-commit superblock refresh failed; stale "
                       "device copies will lapse on next access",
                       exc_info=True)


def _log_commit(store: PartitionedCVD, vid: int, parent: Optional[int],
                edge_w: int, size: int) -> None:
    """Record commit lineage on the store — ``vid -> (parent, w, |rlist|)``
    — so late observers (``online.RepartitionTrigger`` resyncing its
    weighted tree after commits landed between observations) can extend
    their state without recomputing record intersects."""
    try:
        log = store._commit_log
    except AttributeError:
        log = store._commit_log = {}
    log[int(vid)] = (-1 if parent is None else int(parent),
                     int(edge_w), int(size))


# ------------------------------------------------------------- migration --

@dataclasses.dataclass(frozen=True)
class SegmentOp:
    """One contiguous row range of a NEW partition block and where it comes
    from: ``move`` copies rows [src_start, src_start+n_rows) of OLD
    partition ``src_pid``'s block; ``insert`` gathers from the base data."""
    kind: str                 # "move" | "insert"
    new_pid: int              # index into the plan's new partition list
    dst_start: int            # first local row of the new block
    n_rows: int
    src_pid: int = -1         # old partition index (kind == "move")
    src_start: int = -1       # first local row in the old block


@dataclasses.dataclass
class MigrationPlan:
    """An explicit, costed migration from a store's current partitioning to
    ``assignment`` (paper §4.3's intelligent migration, made physical).

    ``ops`` lists, per new partition, the exact (move | insert) segments
    that assemble its block; ``src_pid_rows``/``src_loc_rows`` are the same
    mapping at row granularity (the vectorized form ``apply_migration`` and
    ``migrate_superblock`` consume).  ``cost_intelligent``/``cost_naive``
    follow the paper's record-row unit: morph the closest old partition
    (inserts + deletes, matched one-to-one on record overlap, falling back
    to from-scratch when morphing costs more) vs rebuild every partition.
    """
    assignment: np.ndarray            # (n_versions,) new version -> label
    new_labels: np.ndarray            # (P_new,) partition labels, sorted
    new_vids: list                    # per new partition: version ids
    new_grids: list                   # per new partition: sorted global rids
    src_pid_rows: list                # per new partition: (R_i,) old pid|-1
    src_loc_rows: list                # per new partition: (R_i,) old local row
    ops: list                         # list[list[SegmentOp]] per new partition
    matched_old: np.ndarray           # (P_new,) morph source old pid | -1
    cost_intelligent: int             # record rows inserted+deleted (morph)
    cost_naive: int                   # record rows written (from scratch)
    rows_moved: int                   # rows block-copied from old partitions
    rows_loaded: int                  # rows gathered from base data

    @property
    def n_partitions(self) -> int:
        return len(self.new_labels)


def _row_segments(new_pid: int, spid: np.ndarray, sloc: np.ndarray
                  ) -> list[SegmentOp]:
    """Compress per-row (src pid, src row) arrays into maximal contiguous
    SegmentOps: a move run breaks when the pid changes or the source rows
    stop being consecutive; insert rows (-1) coalesce into one segment."""
    n = len(spid)
    if n == 0:
        return []
    brk = np.flatnonzero((spid[1:] != spid[:-1])
                         | ((spid[1:] >= 0) & (sloc[1:] != sloc[:-1] + 1))) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [n]])
    return [SegmentOp(kind="move" if spid[s] >= 0 else "insert",
                      new_pid=new_pid, dst_start=int(s), n_rows=int(e - s),
                      src_pid=int(spid[s]), src_start=int(sloc[s]))
            for s, e in zip(starts, ends)]


def plan_migration(store: PartitionedCVD, assignment: np.ndarray
                   ) -> MigrationPlan:
    """Plan the migration from ``store``'s current partitioning to
    ``assignment`` without touching any data block.

    Physical sourcing: every record of every new partition is looked up in
    the OLD partitions — its morph source first, then any old partition
    (first occurrence wins: records may be duplicated across partitions);
    found rows become ``move`` segments, the rest ``insert`` segments.  Cost
    accounting: the paper's morph-closest matching — each new partition is
    paired (one-to-one, greedy smallest modification cost) with the old
    partition it shares the most records with, and pays inserts + deletes,
    unless building from scratch is cheaper."""
    assignment = np.asarray(assignment, dtype=np.int64)
    if len(assignment) != store.graph.n_versions:
        raise ValueError(
            f"assignment covers {len(assignment)} versions, store has "
            f"{store.graph.n_versions}")
    graph = store.graph
    old_parts = store.partitions
    new_labels = np.unique(assignment)
    new_vids = [np.flatnonzero(assignment == k) for k in new_labels]
    new_grids = []
    for vids in new_vids:
        rls = [graph.rlist(int(v)) for v in vids]
        new_grids.append(np.unique(np.concatenate(rls)) if rls
                         else np.zeros(0, np.int64))

    # paper cost model: greedy closest-pair morph matching (one-to-one)
    new_R = [len(g) for g in new_grids]
    old_R = [p.n_records for p in old_parts]
    pairs: list[tuple[int, int, int]] = []
    for i, (vids, grids) in enumerate(zip(new_vids, new_grids)):
        cand = np.unique(store.vid_to_pid[vids]) if len(vids) else []
        for j in cand:
            j = int(j)
            if j < 0:
                continue
            common = int(len(np.intersect1d(grids, old_parts[j].grids,
                                            assume_unique=True)))
            mod = (new_R[i] - common) + (old_R[j] - common)
            pairs.append((mod, i, j))
    pairs.sort()
    matched_old = np.full(len(new_labels), -1, np.int64)
    used_old: set[int] = set()
    cost_int = 0
    for mod, i, j in pairs:
        if matched_old[i] >= 0 or j in used_old:
            continue
        if mod >= new_R[i]:      # from scratch beats morphing this pair
            continue
        matched_old[i] = j
        used_old.add(j)
        cost_int += mod
    for i in range(len(new_labels)):
        if matched_old[i] < 0:
            cost_int += new_R[i]
    cost_naive = int(sum(new_R))

    # global record -> (old pid, old local row) map, first occurrence wins
    # (fallback source for rows the matched partition doesn't hold) — built
    # LAZILY: an identity/near-identity migration resolves everything
    # through the matched partitions and skips the store-wide sort
    _map: list = []

    def global_map():
        if not _map:
            all_g = np.concatenate([p.grids for p in old_parts])
            all_pid = np.repeat(np.arange(len(old_parts), dtype=np.int64),
                                [p.n_records for p in old_parts])
            all_loc = np.concatenate([np.arange(p.n_records, dtype=np.int64)
                                      for p in old_parts])
            order = np.argsort(all_g, kind="stable")
            g, pid, loc = all_g[order], all_pid[order], all_loc[order]
            first = np.ones(len(g), bool)
            first[1:] = g[1:] != g[:-1]
            _map.append((g[first], pid[first], loc[first]))
        return _map[0]

    src_pid_rows, src_loc_rows, ops = [], [], []
    rows_moved = rows_loaded = 0
    for i, grids in enumerate(new_grids):
        spid = np.full(len(grids), -1, np.int64)
        sloc = np.full(len(grids), -1, np.int64)
        # matched partition first: records it holds resolve to ITS rows, so
        # an unchanged stretch keeps consecutive source positions (the
        # superblock migration turns those into whole-tile device copies)
        j = int(matched_old[i])
        if j >= 0 and len(grids):
            og = old_parts[j].grids
            if len(og):
                pos = np.clip(np.searchsorted(og, grids), 0, len(og) - 1)
                hit = og[pos] == grids
                spid[hit] = j
                sloc[hit] = pos[hit]
        un = spid < 0
        if un.any() and old_parts:
            g_s, pid_s, loc_s = global_map()
            if len(g_s):
                pos = np.clip(np.searchsorted(g_s, grids[un]), 0,
                              len(g_s) - 1)
                hit = g_s[pos] == grids[un]
                idx = np.flatnonzero(un)[hit]
                spid[idx] = pid_s[pos[hit]]
                sloc[idx] = loc_s[pos[hit]]
        src_pid_rows.append(spid)
        src_loc_rows.append(sloc)
        ops.append(_row_segments(i, spid, sloc))
        rows_moved += int((spid >= 0).sum())
        rows_loaded += int((spid < 0).sum())

    return MigrationPlan(
        assignment=assignment, new_labels=new_labels, new_vids=new_vids,
        new_grids=new_grids, src_pid_rows=src_pid_rows,
        src_loc_rows=src_loc_rows, ops=ops, matched_old=matched_old,
        cost_intelligent=int(cost_int), cost_naive=cost_naive,
        rows_moved=rows_moved, rows_loaded=rows_loaded)


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
