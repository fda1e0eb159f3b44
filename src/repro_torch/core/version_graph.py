"""Version graph (DAG) + metadata/attribute tables (paper §3.3, Fig 4-5).

The version graph ``G = (V, E)`` has an edge (vi -> vj) iff vi is a parent of
vj; the edge weight w(vi, vj) is the number of records the two versions share.
When no merges exist the graph is a tree, which is LYRESPLIT's native input;
``to_tree`` implements the Appendix C.1 DAG->tree reduction (keep the
max-weight incoming edge per merge node, count the conceptually-duplicated
records R-hat).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .graph import BipartiteGraph, intersect_size


@dataclasses.dataclass
class VersionMeta:
    vid: int
    parents: tuple[int, ...]
    checkout_t: Optional[float]
    commit_t: float
    msg: str = ""
    attributes: tuple[int, ...] = ()   # attribute ids (schema-change support)


@dataclasses.dataclass
class AttributeEntry:
    attr_id: int
    name: str
    dtype: str


class VersionGraph:
    """Metadata table + derivation DAG."""

    def __init__(self) -> None:
        self.meta: list[VersionMeta] = []
        self.children: list[list[int]] = []
        self.attr_table: list[AttributeEntry] = []
        self._attr_index: dict[tuple[str, str], int] = {}
        # (parent, child) -> w(parent, child): maintained incrementally at
        # commit time (``add_version(edge_w=...)``) and lazily back-filled
        # by ``edge_weights``/``to_tree`` — trigger evaluations stop paying
        # an O(edges) intersect_size recompute per invocation
        self._edge_w: dict[tuple[int, int], int] = {}

    # -- attribute table (Fig 5) -------------------------------------------
    def intern_attribute(self, name: str, dtype: str) -> int:
        key = (name, dtype)
        if key not in self._attr_index:
            aid = len(self.attr_table)
            self.attr_table.append(AttributeEntry(aid, name, dtype))
            self._attr_index[key] = aid
        return self._attr_index[key]

    # -- versions -----------------------------------------------------------
    def add_version(self, parents: Sequence[int], commit_t: float = 0.0,
                    checkout_t: Optional[float] = None, msg: str = "",
                    attributes: Sequence[int] = (),
                    edge_w: Optional[Sequence[int]] = None) -> int:
        """Register a version.  ``edge_w`` (aligned with ``parents``) seeds
        the parent-edge weight memo at commit time — the committer already
        knows how many records it shares with each parent, so recording it
        here spares every later ``to_tree`` the intersect recompute."""
        vid = len(self.meta)
        self.meta.append(VersionMeta(vid, tuple(parents), checkout_t, commit_t, msg,
                                     tuple(attributes)))
        self.children.append([])
        for p in parents:
            self.children[p].append(vid)
        if edge_w is not None:
            if len(edge_w) != len(parents):
                raise ValueError(
                    f"edge_w has {len(edge_w)} entries for "
                    f"{len(parents)} parents")
            for p, w in zip(parents, edge_w):
                self._edge_w[(int(p), vid)] = int(w)
        return vid

    @property
    def n_versions(self) -> int:
        return len(self.meta)

    def parents(self, vid: int) -> tuple[int, ...]:
        return self.meta[vid].parents

    def is_tree(self) -> bool:
        return all(len(m.parents) <= 1 for m in self.meta)

    def ancestors(self, vid: int) -> list[int]:
        seen: set[int] = set()
        stack = list(self.meta[vid].parents)
        while stack:
            v = stack.pop()
            if v not in seen:
                seen.add(v)
                stack.extend(self.meta[v].parents)
        return sorted(seen)

    def descendants(self, vid: int) -> list[int]:
        seen: set[int] = set()
        stack = list(self.children[vid])
        while stack:
            v = stack.pop()
            if v not in seen:
                seen.add(v)
                stack.extend(self.children[v])
        return sorted(seen)

    def depth(self, vid: int) -> int:
        """l(v): topological depth, root = 1 (longest path to a root)."""
        memo: dict[int, int] = {}

        def rec(v: int) -> int:
            if v in memo:
                return memo[v]
            ps = self.meta[v].parents
            memo[v] = 1 if not ps else 1 + max(rec(p) for p in ps)
            return memo[v]

        return rec(vid)


@dataclasses.dataclass
class WeightedTree:
    """LYRESPLIT input: a version tree with per-node record counts and
    parent-edge weights.  parent[root] == -1, edge_w[root] == 0."""

    parent: np.ndarray       # (n,) int64
    n_records: np.ndarray    # (n,) int64  |R(v)|
    edge_w: np.ndarray       # (n,) int64  w(parent(v), v)
    n_attrs: np.ndarray | None = None       # (n,) per-version attr counts (C.3)
    edge_attrs: np.ndarray | None = None    # (n,) common attrs with parent (C.3)

    @property
    def n(self) -> int:
        return len(self.parent)

    def children_lists(self) -> list[list[int]]:
        ch: list[list[int]] = [[] for _ in range(self.n)]
        for v, p in enumerate(self.parent):
            if p >= 0:
                ch[int(p)].append(v)
        return ch


def _edge_weight(graph: BipartiteGraph, vg: VersionGraph, p: int, v: int
                 ) -> int:
    """w(p, v), memoized on the version graph: commit-time seeded weights
    (``add_version(edge_w=...)``) are free; misses compute ONE intersect and
    back-fill the memo, so repeated trigger evaluations pay only for edges
    added since the last call."""
    memo = getattr(vg, "_edge_w", None)
    if memo is None:
        memo = vg._edge_w = {}
    w = memo.get((p, v))
    if w is None:
        w = intersect_size(graph.rlist(p), graph.rlist(v))
        memo[(p, v)] = w
    return w


def edge_weights(graph: BipartiteGraph, vg: VersionGraph) -> dict[tuple[int, int], int]:
    return {(p, v): _edge_weight(graph, vg, p, v)
            for v in range(vg.n_versions) for p in vg.parents(v)}


def to_tree(graph: BipartiteGraph, vg: VersionGraph) -> tuple[WeightedTree, int]:
    """Appendix C.1: reduce a DAG to a tree by keeping, for each merge node,
    the max-weight incoming edge.  Returns (tree, |R-hat|) where R-hat counts
    the conceptually duplicated records (records of a merge node not shared
    with its kept parent that *were* shared with a dropped parent)."""
    n = vg.n_versions
    parent = np.full(n, -1, dtype=np.int64)
    edge_w = np.zeros(n, dtype=np.int64)
    sizes = graph.version_sizes().astype(np.int64)
    r_hat = 0
    for v in range(n):
        ps = vg.parents(v)
        if not ps:
            continue
        ws = [_edge_weight(graph, vg, p, v) for p in ps]
        best = int(np.argmax(ws))
        parent[v] = ps[best]
        edge_w[v] = ws[best]
        if len(ps) > 1:
            kept = graph.rlist(ps[best])
            mine = graph.rlist(v)
            inherited = np.intersect1d(kept, mine, assume_unique=True)
            others = np.unique(np.concatenate([
                np.intersect1d(graph.rlist(p), mine, assume_unique=True)
                for i, p in enumerate(ps) if i != best] or [np.zeros(0, np.int64)]))
            r_hat += int(len(np.setdiff1d(others, inherited, assume_unique=True)))
    return WeightedTree(parent=parent, n_records=sizes, edge_w=edge_w), r_hat
