"""The port's AGGLO / KMEANS baselines (paper §5.1) held against the JAX
package's on ``tests/test_baselines.py``'s graphs and seeds: the same numpy
RNG calls in the same order give the same assignments, and the budget
searches the same storage, checkout cost and parameter.  Integer
assignments and costs: every comparison is exact."""
import numpy as np
import pytest

import repro.core.baselines as rb
import repro_torch.core.baselines as tb
from repro_torch.core import generate


def _w(seed=43, n_versions=60, inserts=25, n_branches=8):
    return generate("SCI", n_versions=n_versions, inserts=inserts,
                    n_branches=n_branches, n_attrs=4, seed=seed)


@pytest.fixture(scope="module")
def graphs():
    return {"w43": _w(), "w7": _w(seed=7, n_versions=40, n_branches=5),
            "w120": _w(n_versions=120, inserts=50, n_branches=12)}


@pytest.mark.parametrize("name", ["w43", "w7"])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("bc_frac", [0.05, 0.3, 1.0])
def test_agglo_matches_reference(graphs, name, seed, bc_frac):
    w = graphs[name]
    bc = max(int(bc_frac * w.n_records), int(w.graph.version_sizes().max()))
    got = tb.agglo(w.graph, bc, seed=seed)
    want = rb.agglo(w.graph, bc, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert tb._partition_cost(w.graph, got) == rb._partition_cost(w.graph, want)


@pytest.mark.parametrize("name", ["w43", "w7"])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("k,bc", [(1, None), (6, None), (12, None), (6, 400)])
def test_kmeans_matches_reference(graphs, name, seed, k, bc):
    w = graphs[name]
    got = tb.kmeans(w.graph, k, bc=bc, seed=seed)
    want = rb.kmeans(w.graph, k, bc=bc, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert tb._partition_cost(w.graph, got) == rb._partition_cost(w.graph, want)


def test_shingles_match_reference(graphs):
    w = graphs["w43"]
    rng = np.random.default_rng(1)
    mults = rng.integers(1, 1 << 30, size=16, dtype=np.int64)
    mods = rng.integers(0, 1 << 30, size=16, dtype=np.int64)
    for v in range(w.n_versions):
        rl = w.graph.rlist(v)
        np.testing.assert_array_equal(tb._shingles(rl, 16, mods, mults),
                                      rb._shingles(rl, 16, mods, mults))
    np.testing.assert_array_equal(tb._shingles(np.zeros(0, np.int64), 4, mods[:4], mults[:4]),
                                  np.zeros(4, np.int64))


@pytest.mark.parametrize("fn", ["agglo_for_budget", "kmeans_for_budget"])
@pytest.mark.parametrize("name,gamma_x", [("w43", 2.0), ("w7", 1.3),
                                           ("w120", 2.0)])
def test_budget_search_matches_reference(graphs, fn, name, gamma_x):
    w = graphs[name]
    gamma = int(gamma_x * w.n_records)
    got = getattr(tb, fn)(w.graph, gamma, max_iters=6)
    want = getattr(rb, fn)(w.graph, gamma, max_iters=6)
    assert isinstance(got, tb.BaselineResult)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert (got.storage, got.checkout, got.param) == \
        (want.storage, want.checkout, want.param)
    assert got.storage <= gamma


@pytest.mark.parametrize("fn", ["agglo_for_budget", "kmeans_for_budget"])
def test_budget_search_unreachable_gamma_matches_reference(graphs, fn):
    """A budget under the smallest partitioning's storage: both fall back
    to one partition (the same fallback parameter)."""
    w = graphs["w7"]
    got = getattr(tb, fn)(w.graph, 1, max_iters=3)
    want = getattr(rb, fn)(w.graph, 1, max_iters=3)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert (got.storage, got.checkout, got.param) == \
        (want.storage, want.checkout, want.param)
