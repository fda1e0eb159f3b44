"""Row-delta extraction for commits (paper §3's *no cross-version diff*
rule): an incoming table is compared against its parent version's rows
only, and any row not present there (by full-row value) gets a fresh rid.

The extraction serves ``PartitionedCVD.commit_many``'s table form and the
split-by-rlist storage model (paper §3, Fig 1(c.ii)): a data table plus one
(vid -> rlist) versioning tuple per commit, the model ORPHEUSDB adopts and
the one ``train.checkpoint.CheckpointStore`` keeps its checkpoints in.  The
other four models of paper §3 are not ported.
"""
from __future__ import annotations

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
