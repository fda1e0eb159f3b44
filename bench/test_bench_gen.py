"""The generators and the seeded inputs are deterministic in the seed,
and the frozen generator draws what the program's generator draws."""
import numpy as np
import pytest
import torch

from bench import harness, weights
from bench.cells import prefill
from bench.gen import versions

TRAFFIC = {"lengths": [[32, 0.3], [64, 0.3], [128, 0.4]],
           "rate_per_s": 20.0, "store": {"n_versions": 8}}


@pytest.mark.parametrize("kind", ["SCI", "CUR"])
def test_same_seed_same_versions(kind):
    a = versions.generate(kind, 12, 30, 2, 9, seed=2**31 + 3)
    b = versions.generate(kind, 12, 30, 2, 9, seed=2**31 + 3)
    c = versions.generate(kind, 12, 30, 2, 9, seed=2**31 + 4)
    assert np.array_equal(a.data, b.data)
    assert all(np.array_equal(x, y) for x, y in zip(a.rlists, b.rlists))
    assert not np.array_equal(a.data, c.data)


@pytest.mark.parametrize("kind,seed", [("SCI", 0), ("CUR", 7)])
def test_frozen_generator_equals_the_programs(kind, seed):
    from repro_torch.core import generate
    w = generate(kind, n_versions=12, inserts=30, n_branches=2, n_attrs=9,
                 seed=seed)
    v = versions.generate(kind, 12, 30, 2, 9, seed=seed)
    assert np.array_equal(w.data, v.data)
    indptr, indices = v.csr()
    assert np.array_equal(w.graph.indptr, indptr)
    assert np.array_equal(w.graph.indices, indices)
    assert [m.parents for m in w.vgraph.meta] == v.parents


def test_schedule_is_the_same_work_in_another_order():
    a = prefill.schedule(TRAFFIC, 5, 2.0)
    b = prefill.schedule(TRAFFIC, 5, 2.0)
    c = prefill.schedule(TRAFFIC, 6, 2.0)
    assert a == b and a != c and len(a) == len(c) == 40
    for s in (a, c):        # the same lengths and gaps every seed
        assert sorted(r["len"] for r in s) == [32] * 12 + [64] * 12 + \
            [128] * 16
        assert s[0]["a"] == 0.0 and all(
            x["a"] < y["a"] for x, y in zip(s, s[1:]))

    def gaps(s):
        return sorted(y["a"] - x["a"] for x, y in zip(s, s[1:]))
    assert gaps(a) != gaps(c)          # one gap of each is the last
    assert abs(sum(gaps(a)) - sum(gaps(c))) < 0.2
    assert a[-1]["a"] < 2.0


def test_weights_are_seeded_leaf_by_leaf():
    c = {"family": "dense", "n_layers": 2, "d_model": 32, "n_heads": 2,
         "n_kv": 1, "head_dim": 16, "d_ff": 64, "vocab": 100,
         "tie_embeddings": False, "reference": "model"}
    a, b = weights.make(c, 9, "cpu"), weights.make(c, 9, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert torch.equal(weights.make_leaf(c, 9, "layers/mlp/wo/w", "cpu"),
                       a["layers/mlp/wo/w"])
    assert not torch.equal(weights.make(c, 10, "cpu")["embed"], a["embed"])
    assert harness.subseed(2**40 + 1, 2) == harness.subseed(2**40 + 1, 2)
