"""LYRESPLIT (paper §4.2, Algorithm 1) + Appendix B binary search and the
Appendix C extensions.

LYRESPLIT operates ONLY on the version tree — never the version-record
bipartite graph — which is what makes it ~10^3x faster than AGGLO/KMEANS.
All the quantities it needs per candidate component C (a connected subtree):

    |V_C|  = node count
    |E_C|  = Σ_{v∈C} |R(v)|                      (bipartite edges)
    |R_C|  = |R(root_C)| + Σ_{v∈C, v≠root} (|R(v)| − w(p(v), v))

The |R_C| identity is exact under the paper's *no cross-version diff* rule:
every record's membership region is a connected subtree, so a record present
on both sides of a cut edge (p, c) is counted by w(p, c), giving
|R_parent| = |R_C| − |R_child| + w(p, c) after a split (Lemma 2's argument).

Guarantee (Thm 2): for parameter δ ≤ 1, storage ≤ (1+δ)^ℓ |R| and
C_avg ≤ (1/δ)·|E|/|V|, with ℓ the recursion depth.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .version_graph import WeightedTree


@dataclasses.dataclass
class Component:
    nodes: np.ndarray      # version ids (component root first)
    root: int
    n_R: int               # estimated |R_C|
    n_V: float             # |V_C| (possibly frequency-weighted)
    n_E: float             # |E_C| (possibly frequency/attr-weighted)


@dataclasses.dataclass
class SplitResult:
    assignment: np.ndarray            # (n,) int64 version -> partition id
    components: list[Component]
    delta: float
    levels: int                       # ℓ — recursion depth reached
    est_storage: int                  # Σ_k |R_k| (tree estimate)
    est_checkout: float               # Σ_k |V_k||R_k| / n
    wall_s: float

    @property
    def n_partitions(self) -> int:
        return len(self.components)


def _component_stats(tree: WeightedTree, nodes: np.ndarray, root: int,
                     freq: Optional[np.ndarray], attr_mode: bool) -> Component:
    nr = tree.n_records
    ew = tree.edge_w
    in_c = nodes[nodes != root]
    n_R = int(nr[root] + (nr[in_c] - ew[in_c]).sum())
    if freq is not None:
        n_V = float(freq[nodes].sum())
        n_E = float((freq[nodes] * nr[nodes]).sum())
    else:
        n_V = float(len(nodes))
        n_E = float(nr[nodes].sum())
    if attr_mode and tree.n_attrs is not None:
        n_E = float((nr[nodes] * tree.n_attrs[nodes]).sum())
    return Component(nodes=nodes, root=root, n_R=n_R, n_V=n_V, n_E=n_E)


def _subtree_nodes(children: list[list[int]], root: int, members: set[int]) -> np.ndarray:
    out = []
    stack = [root]
    while stack:
        v = stack.pop()
        out.append(v)
        stack.extend(c for c in children[v] if c in members)
    return np.asarray(out, dtype=np.int64)


def lyresplit(tree: WeightedTree, delta: float,
              freq: Optional[np.ndarray] = None,
              attr_mode: bool = False,
              total_attrs: Optional[int] = None) -> SplitResult:
    """Algorithm 1.  ``freq`` enables the weighted variant (App. C.2);
    ``attr_mode`` the schema-change variant (App. C.3)."""
    t0 = time.perf_counter()
    n = tree.n
    children = tree.children_lists()
    roots = [v for v in range(n) if tree.parent[v] < 0]
    assert len(roots) == 1, "tree must have one root"
    all_nodes = np.arange(n, dtype=np.int64)

    final: list[Component] = []
    work: list[tuple[Component, int]] = [
        (_component_stats(tree, all_nodes, roots[0], freq, attr_mode), 0)]
    max_level = 0

    while work:
        comp, level = work.pop()
        max_level = max(max_level, level)
        # termination test (line 1): |R||V| < |E|/δ
        if comp.n_R * comp.n_V < comp.n_E / delta or len(comp.nodes) <= 1:
            final.append(comp)
            continue
        members = set(int(v) for v in comp.nodes)
        # Ω: candidate cut edges (line 5)
        cand = []
        for v in comp.nodes:
            v = int(v)
            p = int(tree.parent[v])
            if p < 0 or p not in members:
                continue
            if attr_mode and tree.edge_attrs is not None and total_attrs is not None:
                ok = tree.edge_attrs[v] * tree.edge_w[v] <= delta * total_attrs * comp.n_R
            else:
                ok = tree.edge_w[v] <= delta * comp.n_R
            if ok:
                cand.append(v)
        if not cand:
            final.append(comp)
            continue
        # PickOneEdgeCut: minimize version-count imbalance, tie-break records.
        # One post-order pass gives every candidate's subtree stats -> O(|C|),
        # the paper's stated per-level complexity.
        sub_v: dict[int, float] = {}      # weighted version count of subtree(v)
        sub_g: dict[int, int] = {}        # Σ_{u∈subtree(v)} (|R(u)| − w(p(u),u))
        order = []
        stack = [int(comp.root)]
        while stack:
            v = stack.pop()
            order.append(v)
            stack.extend(c for c in children[v] if c in members)
        for v in reversed(order):
            fv = float(freq[v]) if freq is not None else 1.0
            sub_v[v] = fv + sum(sub_v[c] for c in children[v] if c in members)
            sub_g[v] = int(tree.n_records[v] - tree.edge_w[v]) + \
                sum(sub_g[c] for c in children[v] if c in members)
        best_v, best_key = -1, None
        for v in cand:
            r_child = sub_g[v] + int(tree.edge_w[v])   # = |R_subtree(v)|
            key = (abs(comp.n_V - 2 * sub_v[v]), abs(comp.n_R - 2 * r_child))
            if best_key is None or key < best_key:
                best_key, best_v = key, v
        sub = _subtree_nodes(children, best_v, members)
        child_c = _component_stats(tree, sub, best_v, freq, attr_mode)
        rest = np.asarray(sorted(members - set(int(x) for x in sub)), dtype=np.int64)
        parent_c = _component_stats(tree, rest, comp.root, freq, attr_mode)
        # exact split identity: R_parent = R_C - R_child + w(p, c)
        assert parent_c.n_R == comp.n_R - child_c.n_R + int(tree.edge_w[best_v]), \
            "split bookkeeping mismatch"
        work.append((parent_c, level + 1))
        work.append((child_c, level + 1))

    assignment = np.full(n, -1, dtype=np.int64)
    for k, comp in enumerate(final):
        assignment[comp.nodes] = k
    n_total = float(freq.sum()) if freq is not None else float(n)
    est_storage = int(sum(c.n_R for c in final))
    est_checkout = sum(c.n_V * c.n_R for c in final) / n_total
    return SplitResult(assignment=assignment, components=final, delta=delta,
                       levels=max_level, est_storage=est_storage,
                       est_checkout=est_checkout,
                       wall_s=time.perf_counter() - t0)


@dataclasses.dataclass
class SearchResult:
    best: SplitResult
    iters: int
    wall_s: float
    per_iter_s: list[float]


def lyresplit_for_budget(tree: WeightedTree, gamma: float,
                         freq: Optional[np.ndarray] = None,
                         max_iters: int = 40,
                         tol: float = 0.99) -> SearchResult:
    """Appendix B: binary-search δ so the (estimated) storage S meets
    tol·γ ≤ S ≤ γ; returns the best feasible partitioning found."""
    t0 = time.perf_counter()
    root = int(np.flatnonzero(tree.parent < 0)[0])
    n_R_total = _component_stats(tree, np.arange(tree.n, dtype=np.int64), root,
                                 None, False).n_R
    n_E = float(tree.n_records.sum())
    lo = n_E / max(n_R_total * tree.n, 1)
    hi = 1.0
    best: Optional[SplitResult] = None
    per_iter: list[float] = []
    it = 0
    for it in range(1, max_iters + 1):
        mid = 0.5 * (lo + hi)
        res = lyresplit(tree, mid, freq=freq)
        per_iter.append(res.wall_s)
        s = res.est_storage
        if s <= gamma and (best is None or res.est_checkout < best.est_checkout):
            best = res
        if s > gamma:
            hi = mid            # too much storage -> fewer splits -> smaller δ
        else:
            lo = mid            # budget spare -> more splits -> larger δ
        if tol * gamma <= s <= gamma:
            break
        if hi - lo < 1e-4:   # δ interval exhausted (splits are discrete)
            break
    if best is None:
        # γ at/below |R|: the single partition is the only (or least-bad)
        # feasible choice — build it explicitly (a tiny δ can still split on
        # zero-weight edges, overshooting the budget).
        all_nodes = np.arange(tree.n, dtype=np.int64)
        comp = _component_stats(tree, all_nodes, root, freq, False)
        n_tot = float(freq.sum()) if freq is not None else float(tree.n)
        best = SplitResult(assignment=np.zeros(tree.n, dtype=np.int64),
                           components=[comp], delta=lo, levels=0,
                           est_storage=comp.n_R,
                           est_checkout=comp.n_V * comp.n_R / n_tot,
                           wall_s=0.0)
    return SearchResult(best=best, iters=it, wall_s=time.perf_counter() - t0,
                        per_iter_s=per_iter)
