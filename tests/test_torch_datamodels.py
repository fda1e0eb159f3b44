"""The port's five storage models (paper §3, Fig 1) held against the JAX
package's on the same commit streams: rids, ``rlist``, ``checkout``,
``checkout_multi`` (and its per-row oracle ``checkout_multi_loop``),
``storage_cells``, the delta chain and the version graph's parents and edge
weights.  Both sides are numpy on the host and move integers only, so every
comparison is exact (byte for byte, in the same row order)."""
import numpy as np
import pytest

import repro.core.datamodels as rdm
import repro_torch.core as tcore
import repro_torch.core.datamodels as tdm
from repro.core import generate

PAIRS = list(zip(rdm.ALL_MODELS, tdm.ALL_MODELS))
IDS = [c.name for c in tdm.ALL_MODELS]


def _lineage_tables(rng, n_attrs=6):
    """``tests/test_datamodels.py``'s stream: inserts, deletes and a
    two-parent merge."""
    def mk(n, tag):
        t = rng.integers(0, 100, size=(n, n_attrs)).astype(np.int32)
        t[:, 0] = np.arange(n) + tag
        t[:, 1] = rng.integers(0, 1 << 20, size=n)
        return t
    t0 = mk(60, 0)
    t1 = np.concatenate([t0[:50], mk(25, 1000)])
    t2 = np.concatenate([t1[5:], mk(10, 5000)])
    t3 = np.concatenate([mk(20, 9000), t2[:40]])
    return [(t0, ()), (t1, (0,)), (t2, (1,)), (t3, (1, 2))]


def _pk_stream(rng):
    """``tests/test_batched_checkout.py``'s PK-precedence stream: 25 rows
    changed under the same primary key."""
    t0 = rng.integers(0, 100, (50, 6)).astype(np.int32)
    t0[:, 0] = np.arange(50)
    t0[:, 1] = 7
    t1 = t0.copy()
    t1[:25, 2:] += 1
    return [(t0, ()), (t1, (0,))]


def _sci_stream(seed):
    """A generated SCI workload replayed as commits (the randomized
    ``checkout_multi`` stream of ``tests/test_batched_checkout.py``)."""
    w = generate("SCI", n_versions=8, inserts=40, n_branches=2, n_attrs=6,
                 seed=seed)
    return [(w.data[w.graph.rlist(v)], tuple(w.vgraph.parents(v)))
            for v in range(w.n_versions)]


def _readd_stream(rng):
    """Deleted-then-re-added rows (the *no cross-version diff* rule)."""
    t0, _ = _lineage_tables(rng)[0]
    return [(t0, ()), (t0[10:], (0,)), (t0, (1,))]


STREAMS = {
    "lineage": lambda: _lineage_tables(np.random.default_rng(0)),
    "pk": lambda: _pk_stream(np.random.default_rng(0)),
    "readd": lambda: _readd_stream(np.random.default_rng(0)),
    **{f"sci{s}": (lambda s=s: _sci_stream(s)) for s in range(3)},
}


def _replay(cls, stream):
    m = cls(n_attrs=stream[0][0].shape[1])
    vids = [m.commit(t, parents=p, t=float(i)) for i, (t, p) in enumerate(stream)]
    return m, vids


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_exports_match_reference():
    assert [c.name for c in tcore.ALL_MODELS] == [c.name for c in rdm.ALL_MODELS]
    for name in ("CombinedTable", "SplitByVlist", "SplitByRlist",
                 "DeltaBased", "TablePerVersion"):
        assert getattr(tcore, name) is getattr(tdm, name)
        assert getattr(tcore, name).__module__ == "repro_torch.core.datamodels"


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("ref_cls,cls", PAIRS, ids=IDS)
def test_model_matches_reference(ref_cls, cls, stream):
    commits = STREAMS[stream]()
    ref, rvids = _replay(ref_cls, commits)
    port, pvids = _replay(cls, commits)
    assert pvids == rvids
    for v in pvids:
        _same(port.checkout(v), ref.checkout(v))
        if hasattr(ref, "rlist"):
            _same(port.rlist(v), ref.rlist(v))
        assert port.vgraph.parents(v) == ref.vgraph.parents(v)
        assert port.vgraph.meta[v].commit_t == ref.vgraph.meta[v].commit_t
    assert port.vgraph._edge_w == ref.vgraph._edge_w
    assert port.storage_cells() == ref.storage_cells()
    if hasattr(ref, "data_table"):
        _same(port.data_table, ref.data_table)


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("ref_cls,cls", PAIRS, ids=IDS)
def test_checkout_multi_matches_reference_and_loop(ref_cls, cls, stream):
    commits = STREAMS[stream]()
    ref, _ = _replay(ref_cls, commits)
    port, vids = _replay(cls, commits)
    rng = np.random.default_rng(len(commits))
    for sel in ([vids[-1], vids[0]], list(reversed(vids)),
                list(rng.integers(0, len(vids), 4)), []):
        got = port.checkout_multi(sel)
        _same(got, ref.checkout_multi(sel))
        _same(got, port.checkout_multi_loop(sel))
        _same(port.checkout_multi_loop(sel), ref.checkout_multi_loop(sel))


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_delta_chain_matches_reference(stream):
    commits = STREAMS[stream]()
    ref, _ = _replay(rdm.DeltaBased, commits)
    port, _ = _replay(tdm.DeltaBased, commits)
    assert len(port.deltas) == len(ref.deltas)
    for d, e in zip(port.deltas, ref.deltas):
        assert d.base == e.base
        _same(d.added_rows, e.added_rows)
        assert d.tombstones.tobytes() == e.tombstones.tobytes()
        assert len(d.tombstones) == len(e.tombstones)


@pytest.mark.parametrize("cls", [tdm.CombinedTable, tdm.SplitByVlist],
                         ids=lambda c: c.name)
def test_vlists_match_reference_and_rlists(cls):
    commits = STREAMS["lineage"]()
    port, vids = _replay(cls, commits)
    ref, _ = _replay(getattr(rdm, cls.__name__), commits)
    vl = port.vlists
    assert len(vl) == len(ref.vlists)
    for got, want in zip(vl, ref.vlists):
        _same(got, want)
    for v in vids:
        member = np.array([v in vl[r] for r in range(port._n_rows)])
        np.testing.assert_array_equal(np.flatnonzero(member), port.rlist(v))


def test_diff_against_parents_matches_loop_and_reference(rng):
    """The sorted join against the per-row oracle, both packages, on
    random tables with repeated parent rows."""
    m, r = tdm.SplitByRlist(n_attrs=5), rdm.SplitByRlist(n_attrs=5)
    for _ in range(40):
        n_parent = int(rng.integers(0, 30))
        parent_rows = rng.integers(-5, 5, (n_parent, 5)).astype(np.int32)
        parent_rids = rng.permutation(1000)[:n_parent].astype(np.int64)
        take = rng.integers(0, max(n_parent, 1), int(rng.integers(0, 40)))
        fresh = rng.integers(-50, 50, (int(rng.integers(0, 40)), 5)).astype(np.int32)
        table = np.concatenate([parent_rows[take] if n_parent else fresh[:0],
                                fresh])
        table = table[rng.permutation(len(table))]
        got = m._diff_against_parents(table, parent_rows, parent_rids)
        loop = m._diff_against_parents_loop(table, parent_rows, parent_rids)
        want = r._diff_against_parents_loop(table, parent_rows, parent_rids)
        for g in (got, loop):
            np.testing.assert_array_equal(g[0], want[0])
            _same(g[1], want[1])


def test_storage_ordering_as_paper():
    """Fig 3's ordering holds in the port as in the reference: a table per
    version stores the most, split-by-rlist the fewest versioning cells."""
    commits = [(t, (i - 1,) if i else ())
               for i, (t, _) in enumerate(STREAMS["lineage"]())]
    cells = {}
    for cls in tdm.ALL_MODELS:
        m, _ = _replay(cls, commits)
        cells[cls.name] = m.storage_cells()
    assert cells["a-table-per-version"] == max(cells.values())
    assert cells["split-by-rlist"] <= cells["split-by-vlist"]
