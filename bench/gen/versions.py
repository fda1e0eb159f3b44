"""The versioning benchmark's SCI and CUR generators (Maddox et al.),
frozen: a copy of the port's ``core/bench_gen.py`` as it stood when the
benchmark was defined, drawing the same numbers from the same seed, so
that a later change to the program cannot move the data.

SCI: a mainline with branches forked from it or from other branches (the
version graph is a tree).  CUR: branches also merge back into the mainline
every ``merge_every`` versions (a DAG).  Each version derives from its
parent(s) by ``inserts`` inserts, ``update_frac · inserts`` updates (a new
record replacing an old one) and a few deletes.  Records are rows of
``n_attrs`` int32 attributes, the first two the composite primary key.

Returns plain arrays: the benchmark hands them to the program's store.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Versions:
    rlists: list            # per version: its record ids, sorted (int64)
    parents: list           # per version: a tuple of parent versions
    data: np.ndarray        # (n_records, n_attrs) int32, the record pool

    @property
    def n_versions(self) -> int:
        return len(self.rlists)

    @property
    def n_records(self) -> int:
        return len(self.data)

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, indices): the version -> record CSR."""
        indptr = np.zeros(self.n_versions + 1, dtype=np.int64)
        indptr[1:] = np.cumsum([len(r) for r in self.rlists])
        return indptr, np.concatenate(self.rlists).astype(np.int64)


def _new_rows(rng, count: int, n_attrs: int, start_pk: int) -> np.ndarray:
    rows = rng.integers(0, 1000, size=(count, n_attrs), dtype=np.int32)
    rows[:, 0] = np.arange(start_pk, start_pk + count, dtype=np.int32)
    rows[:, 1] = rng.integers(0, 1 << 20, size=count, dtype=np.int32)
    return rows


def generate(kind: str, n_versions: int, inserts: int, n_branches: int,
             n_attrs: int, seed: int, update_frac: float = 0.5,
             delete_frac: float = 0.02, merge_every: int = 8) -> Versions:
    if kind not in ("SCI", "CUR"):
        raise ValueError(f"generator kind {kind!r}: SCI or CUR")
    rng = np.random.default_rng(seed)
    chunks: list[np.ndarray] = []
    rlists: list[np.ndarray] = []
    parents: list[tuple] = []
    next_rid = 0

    def alloc(count: int) -> np.ndarray:
        nonlocal next_rid
        chunks.append(_new_rows(rng, count, n_attrs, next_rid))
        rids = np.arange(next_rid, next_rid + count, dtype=np.int64)
        next_rid += count
        return rids

    rlists.append(alloc(max(inserts, 1)))
    parents.append(())
    mainline = 0
    tips: list[int] = []
    for step in range(1, n_versions):
        u = rng.random()
        want_branch = (len(tips) < n_branches
                       and u < (n_branches / max(n_versions, 1)) * 2.0)
        if kind == "CUR" and tips and step % merge_every == 0:
            tip = tips.pop(int(rng.integers(0, len(tips))))
            merged = np.union1d(rlists[mainline], rlists[tip])
            rlists.append(np.union1d(merged, alloc(max(1, inserts // 4))))
            parents.append((mainline, tip))
            mainline = len(rlists) - 1
            continue
        bi = -1
        if want_branch:
            src = (mainline if (not tips or rng.random() < 0.7)
                   else tips[int(rng.integers(0, len(tips)))])
        elif tips and rng.random() < 0.5:
            bi = int(rng.integers(0, len(tips)))
            src = tips[bi]
        else:
            src = mainline
        base = rlists[src]
        n_upd = int(inserts * update_frac)
        n_del = max(0, int(len(base) * delete_frac))
        keep = base
        if n_del and len(base) > n_del:
            keep = np.delete(base, rng.choice(len(base), size=n_del,
                                              replace=False))
        if n_upd and len(keep) > n_upd:
            keep = np.delete(keep, rng.choice(len(keep), size=n_upd,
                                              replace=False))
            upd = alloc(n_upd)
        else:
            upd = np.zeros(0, dtype=np.int64)
        ins = alloc(inserts)
        rlists.append(np.union1d(np.union1d(keep, upd), ins))
        parents.append((src,))
        vid = len(rlists) - 1
        if want_branch:
            tips.append(vid)
        elif src == mainline:
            mainline = vid
        else:
            tips[bi] = vid
    data = (np.concatenate(chunks, axis=0) if chunks
            else np.zeros((0, n_attrs), np.int32))
    return Versions(rlists=rlists, parents=parents, data=data)
