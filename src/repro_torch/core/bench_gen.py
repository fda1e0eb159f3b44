"""Versioning-benchmark generator (SCI / CUR workloads of Maddox et al. [37]).

SCI: a mainline (linear chain) with branches forked from mainline or from
other branches — the version graph is a tree.
CUR: branches additionally merge back into their parent branch periodically —
the version graph is a DAG.

Each version derives from its parent(s) by I inserts, ~I/2 updates (new rid
replacing an old one) and a few deletes, matching the paper's description
("only a few deleted tuples, opting instead for updates or inserts").
Records are rows of ``n_attrs`` int32 attributes, the first two acting as the
composite primary key.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import BipartiteGraph
from .version_graph import VersionGraph


@dataclasses.dataclass
class Workload:
    name: str
    graph: BipartiteGraph          # version -> rid CSR
    vgraph: VersionGraph           # derivation DAG
    data: np.ndarray               # (n_records, n_attrs) int32 — the record pool
    seed: int

    @property
    def n_versions(self) -> int:
        return self.graph.n_versions

    @property
    def n_records(self) -> int:
        return self.graph.n_records

    @property
    def n_edges(self) -> int:
        return self.graph.n_edges


def _new_rows(rng: np.random.Generator, count: int, n_attrs: int, start_pk: int) -> np.ndarray:
    rows = rng.integers(0, 1000, size=(count, n_attrs), dtype=np.int32)
    rows[:, 0] = np.arange(start_pk, start_pk + count, dtype=np.int32)  # PK part 1
    rows[:, 1] = rng.integers(0, 1 << 20, size=count, dtype=np.int32)   # PK part 2
    return rows


def generate(kind: str = "SCI", n_versions: int = 100, inserts: int = 100,
             n_branches: int = 10, n_attrs: int = 20, seed: int = 0,
             update_frac: float = 0.5, delete_frac: float = 0.02,
             merge_every: int = 8) -> Workload:
    """Generate a workload.  kind='SCI' gives a tree, 'CUR' adds merges.

    |R| scales as ~ n_versions * inserts * (1 + update_frac).
    """
    assert kind in ("SCI", "CUR")
    rng = np.random.default_rng(seed)
    vg = VersionGraph()
    rows_chunks: list[np.ndarray] = []
    rlists: list[np.ndarray] = []
    next_rid = 0
    next_pk = 0

    def alloc(count: int) -> np.ndarray:
        nonlocal next_rid, next_pk
        rows_chunks.append(_new_rows(rng, count, n_attrs, next_pk))
        rids = np.arange(next_rid, next_rid + count, dtype=np.int64)
        next_rid += count
        next_pk += count
        return rids

    # root version
    root_rids = alloc(max(inserts, 1))
    rlists.append(root_rids)
    vg.add_version(parents=(), commit_t=0.0)

    # branch heads: list of vids that represent active branch tips.
    mainline = 0
    branch_tips: list[int] = []
    branch_parent: dict[int, int] = {}  # branch tip vid -> the tip it forked from

    for step in range(1, n_versions):
        t = float(step)
        u = rng.random()
        want_branch = len(branch_tips) < n_branches and u < (n_branches / max(n_versions, 1)) * 2.0
        do_merge = (kind == "CUR" and branch_tips and step % merge_every == 0)

        if do_merge:
            # merge a random branch tip back into mainline (two parents)
            bi = int(rng.integers(0, len(branch_tips)))
            tip = branch_tips.pop(bi)
            pa, pb = mainline, tip
            ra, rb = rlists[pa], rlists[pb]
            merged = np.union1d(ra, rb)
            new = alloc(max(1, inserts // 4))
            cur = np.union1d(merged, new)
            rlists.append(cur)
            vid = vg.add_version(parents=(pa, pb), commit_t=t, checkout_t=t - 0.5)
            mainline = vid
            continue

        if want_branch:
            # fork from mainline or an existing branch
            src = mainline if (not branch_tips or rng.random() < 0.7) \
                else branch_tips[int(rng.integers(0, len(branch_tips)))]
        else:
            # extend mainline or a random branch
            if branch_tips and rng.random() < 0.5:
                bi = int(rng.integers(0, len(branch_tips)))
                src = branch_tips[bi]
            else:
                src = mainline
                bi = -1

        base = rlists[src]
        n_upd = int(inserts * update_frac)
        n_del = max(0, int(len(base) * delete_frac))
        keep = base
        if n_del and len(base) > n_del:
            drop = rng.choice(len(base), size=n_del, replace=False)
            keep = np.delete(base, drop)
        if n_upd and len(keep) > n_upd:
            # updates: replace n_upd existing records with fresh rids
            drop = rng.choice(len(keep), size=n_upd, replace=False)
            keep = np.delete(keep, drop)
            upd = alloc(n_upd)
        else:
            upd = np.zeros(0, dtype=np.int64)
        ins = alloc(inserts)
        cur = np.union1d(np.union1d(keep, upd), ins)
        rlists.append(cur)
        vid = vg.add_version(parents=(src,), commit_t=t, checkout_t=t - 0.5)
        if want_branch:
            branch_tips.append(vid)
        elif src == mainline:
            mainline = vid
        else:
            branch_tips[bi] = vid

    data = np.concatenate(rows_chunks, axis=0) if rows_chunks else np.zeros((0, n_attrs), np.int32)
    graph = BipartiteGraph.from_rlists(rlists, n_records=next_rid)
    return Workload(name=f"{kind}_{n_versions}v_{inserts}i", graph=graph, vgraph=vg,
                    data=data, seed=seed)
