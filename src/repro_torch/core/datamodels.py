"""The five CVD storage models of paper §3 (Fig 1, Table 1, Fig 3).

All five expose the same interface:

    commit(table, parents)  -> vid     # table: (rows, n_attrs) int32
    checkout(vid)           -> rows
    storage_cells()         -> int     # stored data cells + versioning cells

Commit follows the paper's *no cross-version diff* rule: the incoming table is
compared against its parent version(s) only; any row not present in a parent
(by full-row value) is allocated a fresh rid.  Rows are value-immutable.  The
same extraction serves ``PartitionedCVD.commit_many``'s table form.

The models differ exactly as in the paper:
  * combined-table     — one table, per-row ``vlist`` arrays; commit appends
                         vid to every contained row's vlist (expensive).
  * split-by-vlist     — data table + (rid -> vlist) versioning table; commit
                         same append pattern, checkout scans vlists then joins.
  * split-by-rlist     — data table + (vid -> rlist) versioning table; commit
                         inserts ONE versioning tuple (cheap).  The winner, and
                         the model ``train.checkpoint.CheckpointStore`` keeps
                         its checkpoints in.
  * delta-based        — per-version (+rows, tombstones) against a single base
                         parent (the max-overlap parent); checkout replays the
                         chain to the root.
  * table-per-version  — full copy per version.

They keep numpy arrays: the paper measures them inside a relational database,
and no kernel of the port runs here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .version_graph import VersionGraph


def _row_keys(rows: np.ndarray) -> np.ndarray:
    """Hashable per-row view (void dtype over the row bytes)."""
    rows = np.ascontiguousarray(rows)
    return rows.view([("", rows.dtype)] * rows.shape[1]).ravel()


def _raw_keys(rows: np.ndarray) -> np.ndarray:
    """Per-row raw-bytes view (plain void, compares as the row's bytes), so
    sorting and joining work on the ``.tobytes()`` identity of each row."""
    rows = np.ascontiguousarray(rows)
    width = rows.dtype.itemsize * (rows.shape[1] if rows.ndim == 2 else 1)
    return rows.view(np.dtype((np.void, width))).ravel()


def diff_against_parents(table: np.ndarray, parent_rows: np.ndarray,
                         parent_rids: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Split ``table`` into (matched parent rids, new row block).

    Row identity is full-row value equality against the parent's rows only.
    A sorted join on raw-byte row keys; on a key collision among parent rows
    the LAST parent rid wins."""
    table = np.asarray(table)
    if len(parent_rids) == 0:
        return np.zeros(0, np.int64), table
    if len(table) == 0:
        return np.zeros(0, np.int64), table
    pkeys = _raw_keys(parent_rows)
    tkeys = _raw_keys(table)
    if pkeys.dtype != tkeys.dtype:    # row byte-widths differ: no matches
        return np.zeros(0, np.int64), table
    order = np.argsort(pkeys, kind="stable")
    skeys = pkeys[order]
    # last equal key in stable order wins
    pos = np.searchsorted(skeys, tkeys, side="right") - 1
    hit = (pos >= 0) & (skeys[pos.clip(0)] == tkeys)
    matched = np.asarray(parent_rids)[order[pos[hit]]].astype(np.int64)
    new = table[~hit]
    if len(new) == 0:
        new = np.zeros((0, table.shape[1]), table.dtype)
    return matched, new


class StorageModel:
    """Shared bookkeeping: a VersionGraph and per-version row sets."""

    name = "abstract"

    def __init__(self, n_attrs: int):
        self.n_attrs = n_attrs
        self.vgraph = VersionGraph()

    # API ------------------------------------------------------------------
    def commit(self, table: np.ndarray, parents: Sequence[int] = (), t: float = 0.0) -> int:
        raise NotImplementedError

    def checkout(self, vid: int) -> np.ndarray:
        raise NotImplementedError

    def checkout_multi(self, vids: Sequence[int]) -> np.ndarray:
        """Merge checkout with PK-precedence order (paper §2.2): first two
        attribute columns are the composite PK; earlier vids win.

        One concatenated materialization, then first-occurrence dedup on
        the PK via ``np.unique(..., return_index=True)``.
        """
        mats = [self.checkout(v) for v in vids]
        if not mats or sum(len(m) for m in mats) == 0:
            return np.zeros((0, self.n_attrs), np.int32)
        rows = np.concatenate(mats, axis=0)
        pk = _raw_keys(rows[:, :2])
        _, first = np.unique(pk, return_index=True)
        return rows[np.sort(first)]

    def checkout_multi_loop(self, vids: Sequence[int]) -> np.ndarray:
        """Per-row dict-probe merge — kept as the oracle for tests."""
        out_rows: list[np.ndarray] = []
        seen: set[bytes] = set()
        for v in vids:
            rows = self.checkout(v)
            for r in rows:
                pk = r[:2].tobytes()
                if pk not in seen:
                    seen.add(pk)
                    out_rows.append(r)
        return np.stack(out_rows) if out_rows else np.zeros((0, self.n_attrs), np.int32)

    def storage_cells(self) -> int:
        raise NotImplementedError

    # helpers ----------------------------------------------------------------
    def _diff_against_parents(self, table: np.ndarray, parent_rows: np.ndarray,
                              parent_rids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Split ``table`` into (matched parent rids, new row block).

        Row identity is full-row value equality against the parent(s) only
        (*no cross-version diff* rule).  Delegates to the module-level
        ``diff_against_parents`` (shared with the partitioned ingest wave).
        """
        return diff_against_parents(table, parent_rows, parent_rids)

    def _diff_against_parents_loop(self, table, parent_rows, parent_rids
                                   ) -> tuple[np.ndarray, np.ndarray]:
        """Per-row dict-probe diff — kept as the oracle for tests."""
        if len(parent_rids) == 0:
            return np.zeros(0, np.int64), table
        pk = {k.tobytes(): int(r) for k, r in zip(_row_keys(parent_rows), parent_rids)}
        matched: list[int] = []
        new_rows: list[np.ndarray] = []
        for row in table:
            rid = pk.get(np.ascontiguousarray(row).tobytes())
            if rid is None:
                new_rows.append(row)
            else:
                matched.append(rid)
        new = np.stack(new_rows) if new_rows else np.zeros((0, table.shape[1]), table.dtype)
        return np.asarray(matched, dtype=np.int64), new


def _single_parent_edge_w(parents: Sequence[int], matched: np.ndarray
                          ) -> Optional[list[int]]:
    """Commit-time parent-edge weight for the common single-parent case:
    every matched rid came from THE parent, so w(p, v) is the count of
    distinct matched rids.  Multi-parent commits return None (the matched
    rids don't attribute per parent here) and fall back to the lazy memo
    in ``version_graph._edge_weight``."""
    if len(parents) != 1:
        return None
    return [int(len(np.unique(matched)))]


class _RidStore(StorageModel):
    """A dense data table keyed by rid (the base of the array models)."""

    def __init__(self, n_attrs: int):
        super().__init__(n_attrs)
        self._chunks: list[np.ndarray] = []
        self._n_rows = 0
        self._cache: Optional[np.ndarray] = None

    def _append_rows(self, rows: np.ndarray) -> np.ndarray:
        rids = np.arange(self._n_rows, self._n_rows + len(rows), dtype=np.int64)
        if len(rows):
            self._chunks.append(np.asarray(rows, dtype=np.int32))
            self._n_rows += len(rows)
            self._cache = None
        return rids

    @property
    def data_table(self) -> np.ndarray:
        if self._cache is None:
            self._cache = (np.concatenate(self._chunks, axis=0) if self._chunks
                           else np.zeros((0, self.n_attrs), np.int32))
        return self._cache

    def rlist(self, vid: int) -> np.ndarray:
        raise NotImplementedError

    def _parent_view(self, parents: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        if not parents:
            return np.zeros((0, self.n_attrs), np.int32), np.zeros(0, np.int64)
        rids = np.unique(np.concatenate([self.rlist(p) for p in parents]))
        return self.data_table[rids], rids


class _VlistStore(_RidStore):
    """Shared machinery for the two vlist models.

    The LOGICAL layout is per-row vlist arrays (the paper's expensive commit
    pattern — every contained row's vlist grows by one cell per commit, which
    ``storage_cells`` still charges for).  The PHYSICAL index is incremental
    CSR kept commit-side: per vid, the sorted rid array — so ``rlist`` and
    ``checkout`` are O(|rlist|) array reads instead of a Python scan over
    every row's vlist.
    """

    def __init__(self, n_attrs: int):
        super().__init__(n_attrs)
        self._rlists: list[np.ndarray] = []   # vid -> sorted unique rids
        self._n_edges = 0                     # vlist cells incl. multiplicity

    def rlist(self, vid: int) -> np.ndarray:
        return self._rlists[vid]

    @property
    def vlists(self) -> list[np.ndarray]:
        """rid -> sorted vid array, materialized from the CSR index
        (kept for introspection; the scan-based models' logical view)."""
        out: list[np.ndarray] = [np.zeros(0, np.int64) for _ in range(self._n_rows)]
        if not self._rlists:
            return out
        owners = np.concatenate([np.full(len(rl), v, np.int64)
                                 for v, rl in enumerate(self._rlists)])
        rids = np.concatenate(self._rlists)
        order = np.argsort(rids, kind="stable")
        rids, owners = rids[order], owners[order]
        bounds = np.flatnonzero(np.diff(rids)) + 1
        for s, e in zip(np.concatenate([[0], bounds]),
                        np.concatenate([bounds, [len(rids)]])):
            if e > s:
                out[int(rids[s])] = owners[s:e]
        return out

    def commit(self, table, parents=(), t=0.0):
        p_rows, p_rids = self._parent_view(parents)
        matched, new = self._diff_against_parents(table, p_rows, p_rids)
        new_rids = self._append_rows(new)
        # logical cost: a vlist cell per contained row (with multiplicity,
        # like a per-row append); physical index: one CSR entry
        self._n_edges += len(matched) + len(new_rids)
        self._rlists.append(np.unique(np.concatenate([matched, new_rids])))
        return self.vgraph.add_version(parents, commit_t=t,
                                       edge_w=_single_parent_edge_w(
                                           parents, matched))


class CombinedTable(_VlistStore):
    """Fig 1(b): single table with a per-row vlist array."""

    name = "combined-table"

    def checkout(self, vid):
        # full scan with containment check (ARRAY[v] <@ vlist), realized as
        # a vectorized membership mask from the CSR index
        mask = np.zeros(self._n_rows, bool)
        mask[self._rlists[vid]] = True
        return self.data_table[mask]

    def storage_cells(self) -> int:
        return self._n_rows * self.n_attrs + self._n_edges


class SplitByVlist(_VlistStore):
    """Fig 1(c.i): data table + (rid -> vlist) versioning table."""

    name = "split-by-vlist"

    def checkout(self, vid):
        # scan versioning table for membership, then join rids with data table
        rids = self.rlist(vid)
        return self.data_table[rids]

    def storage_cells(self) -> int:
        return (self._n_rows * self.n_attrs          # data table
                + self._n_edges + self._n_rows)      # rid + vlist cells


class SplitByRlist(_RidStore):
    """Fig 1(c.ii): data table + (vid -> rlist) versioning table.  The model
    ORPHEUSDB adopts."""

    name = "split-by-rlist"

    def __init__(self, n_attrs: int):
        super().__init__(n_attrs)
        self.rlists: list[np.ndarray] = []

    def rlist(self, vid: int) -> np.ndarray:
        return self.rlists[vid]

    def commit(self, table, parents=(), t=0.0):
        p_rows, p_rids = self._parent_view(parents)
        matched, new = self._diff_against_parents(table, p_rows, p_rids)
        new_rids = self._append_rows(new)
        # the cheap path: ONE versioning tuple
        self.rlists.append(np.sort(np.concatenate([matched, new_rids])))
        return self.vgraph.add_version(parents, commit_t=t,
                                       edge_w=_single_parent_edge_w(
                                           parents, matched))

    def checkout(self, vid):
        # unnest(rlist) then join with the data table == positional gather
        return self.data_table[self.rlists[vid]]

    def storage_cells(self) -> int:
        return (self._n_rows * self.n_attrs
                + sum(len(r) + 1 for r in self.rlists))


@dataclasses.dataclass
class _Delta:
    base: int                     # parent vid the delta is against (-1 = root)
    added_rows: np.ndarray        # rows inserted at this version
    tombstones: np.ndarray        # row keys (void) deleted from the base


class DeltaBased(StorageModel):
    """§3.1 Approach 4: per-version delta tables + precedent metadata table."""

    name = "delta-based"

    def __init__(self, n_attrs: int):
        super().__init__(n_attrs)
        self.deltas: list[_Delta] = []

    def commit(self, table, parents=(), t=0.0):
        if parents:
            # base = parent sharing the most records (paper: largest overlap)
            overlaps = []
            for p in parents:
                prow = self.checkout(p)
                overlaps.append(len(np.intersect1d(_row_keys(prow), _row_keys(table))))
            base = parents[int(np.argmax(overlaps))]
            brows = self.checkout(base)
            bkeys, tkeys = _row_keys(brows), _row_keys(table)
            added = table[~np.isin(tkeys, bkeys)]
            tomb = bkeys[~np.isin(bkeys, tkeys)]
        else:
            base, added, tomb = -1, table, np.zeros(0, _row_keys(table).dtype) \
                if len(table) else np.zeros(0, np.void(b"").dtype)
        self.deltas.append(_Delta(base=base, added_rows=np.asarray(added, np.int32),
                                  tombstones=tomb))
        return self.vgraph.add_version(parents, commit_t=t)

    def checkout(self, vid):
        # trace lineage to the root; later (nearer) versions take precedence
        chain: list[_Delta] = []
        v = vid
        while v != -1:
            d = self.deltas[v]
            chain.append(d)
            v = d.base
        rows: list[np.ndarray] = []
        seen: set[bytes] = set()
        dead: set[bytes] = set()
        for d in chain:  # nearest first
            for ts in d.tombstones:
                dead.add(ts.tobytes())
            for row in d.added_rows:
                k = np.ascontiguousarray(row).tobytes()
                if k not in seen and k not in dead:
                    seen.add(k)
                    rows.append(row)
        return np.stack(rows) if rows else np.zeros((0, self.n_attrs), np.int32)

    def storage_cells(self) -> int:
        return sum(d.added_rows.size + len(d.tombstones) * self.n_attrs + 2
                   for d in self.deltas)


class TablePerVersion(StorageModel):
    """§3.1 Approach 5: a full table per version (storage strawman)."""

    name = "a-table-per-version"

    def __init__(self, n_attrs: int):
        super().__init__(n_attrs)
        self.tables: list[np.ndarray] = []

    def commit(self, table, parents=(), t=0.0):
        self.tables.append(np.asarray(table, np.int32).copy())
        return self.vgraph.add_version(parents, commit_t=t)

    def checkout(self, vid):
        return self.tables[vid]

    def storage_cells(self) -> int:
        return sum(t.size for t in self.tables)


ALL_MODELS = [CombinedTable, SplitByVlist, SplitByRlist, DeltaBased, TablePerVersion]
