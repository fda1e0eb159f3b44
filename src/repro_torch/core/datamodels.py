"""Row-delta extraction for commits (paper §3's *no cross-version diff*
rule): an incoming table is compared against its parent version's rows
only, and any row not present there (by full-row value) gets a fresh rid.

Only the extraction that ``PartitionedCVD.commit_many``'s table form needs
is here; the five storage models of paper §3 are not ported yet.
"""
from __future__ import annotations

import numpy as np


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
