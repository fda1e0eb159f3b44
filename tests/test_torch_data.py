"""The port's versioned datasets held against the JAX package:
``repro_torch.data.VersionedDataset`` (checkout tiled and untiled,
``checkout_many``, batches, provenance) and the two single-version gather
kernels (``gather_rows``, ``gather_row_tiles``) with their ``ops``
wrappers, on the same numpy inputs.  The port runs with ``device="cpu"``,
so every kernel call goes to its plain torch version; the reference runs
its Pallas kernels in interpret mode.  Everything is integer data moved,
never summed: equality is exact."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as rops
import repro_torch.kernels.checkout_gather as cg
import repro_torch.kernels.ops as ops
from repro.core import generate, lyresplit, to_tree
from repro.data import VersionedDataset as RefDataset
from repro.kernels import ref as rref
from repro_torch.data import VersionedDataset
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import PlanError

# the reference package re-exports wrappers under its kernel modules' names,
# so the module itself comes from the import system
rcg = importlib.import_module("repro.kernels.checkout_gather")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference kernels' Pallas traces are cached process-wide; drop
    them when this module ends, so that a later test file in the same
    process that counts fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def datasets():
    """One SCI workload (40 versions, 12 attributes) under one LyreSplit
    assignment, as the reference's dataset and the port's on the CPU."""
    w = generate("SCI", n_versions=40, inserts=60, n_branches=5, n_attrs=12,
                 seed=0)
    tree, _ = to_tree(w.graph, w.vgraph)
    assignment = lyresplit(tree, 0.4).assignment
    ref = RefDataset.from_graph(w.graph, w.data, assignment, seq_len=16)
    port = VersionedDataset.from_graph(w.graph, w.data, assignment,
                                       seq_len=16, device="cpu")
    return ref, port, w


# ------------------------------------------------------------- dataset --
@pytest.mark.parametrize("use_tiled", [True, False])
def test_checkout_matches_reference_for_every_version(datasets, use_tiled):
    ref, port, w = datasets
    for v in range(w.n_versions):
        want = ref.checkout(v, use_tiled=use_tiled)
        got = port.checkout(v, use_tiled=use_tiled)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"version {v}")
        np.testing.assert_array_equal(got, w.data[w.graph.rlist(v)])


@pytest.mark.parametrize("case", [
    dict(vid=10, global_batch=4, seed=7, n_steps=6),
    dict(vid=10, global_batch=4, seed=7, start_step=3, n_steps=3),
    dict(vid=33, global_batch=3, seed=1, n_steps=40),   # crosses epochs
    dict(vid=10, global_batch=8, seed=3, n_steps=4,
         drop_hosts=np.array([1]), n_hosts=2),
    dict(vid=22, global_batch=8, seed=3, start_step=2, n_steps=5,
         drop_hosts=np.array([0, 3]), n_hosts=4),
], ids=["plain", "start_step", "epochs", "drop_hosts", "drop_hosts_4"])
def test_batches_match_reference(datasets, case):
    ref, port, _ = datasets
    want = list(ref.batches(**case))
    got = list(port.batches(**case))
    assert len(got) == len(want) == case["n_steps"]
    for g, r in zip(got, want):
        assert (g["step"], g["vid"]) == (r["step"], r["vid"])
        for k in ("tokens", "labels"):
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def test_provenance_matches_reference(datasets):
    ref, port, w = datasets
    for v in range(w.n_versions):
        assert port.provenance(v) == ref.provenance(v)


@pytest.mark.parametrize("engine", ["wave", "perpart"])
def test_checkout_many_matches_reference(datasets, engine):
    ref, port, w = datasets
    vids = [3, 17, 17, 0, 39, 22]
    want = ref.checkout_many(vids, engine=engine)
    got = port.checkout_many(vids, engine=engine)
    for g, r, v in zip(got, want, vids):
        np.testing.assert_array_equal(g, r, err_msg=f"version {v}")


def test_dataset_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = generate("SCI", n_versions=6, inserts=10, n_attrs=4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        VersionedDataset.from_graph(w.graph, w.data,
                                    np.zeros(w.n_versions, np.int64), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.checkout_gather(w.data, [0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.checkout_gather_tiled(w.data, [0, 1])


# ------------------------------------------------------------- kernels --
GATHER_SHAPES = [
    # (R, D, N, dtype): D not a multiple of 128; R not a multiple of BN
    (64, 8, 16, np.int32),
    (257, 100, 31, np.int32),
    (1000, 3, 137, np.int32),
    (512, 128, 512, np.float32),
    (2048, 256, 1, np.float32),
]


@pytest.mark.parametrize("r,d,n,dtype", GATHER_SHAPES)
def test_gather_rows_plain_matches_pallas(r, d, n, dtype):
    """Kernel level: the plain version against the Pallas kernel in
    interpret mode on the lane-padded block, rids unsorted with repeats."""
    rng = np.random.default_rng(r + d)
    bd = min(512, max(128, d))
    data = np.zeros((r, -(-d // bd) * bd), dtype)
    data[:, :d] = (rng.standard_normal((r, d)) * 100).astype(dtype)
    rids = rng.integers(0, r, n).astype(np.int32)
    want = np.asarray(rcg.gather_rows(jnp.asarray(data), jnp.asarray(rids),
                                      block_d=bd, interpret=True))
    got = cg.gather_rows(torch.from_numpy(data), rids)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.gather_rows_ref(torch.from_numpy(data),
                             torch.from_numpy(rids)).numpy(),
        np.asarray(rref.gather_rows_ref(jnp.asarray(data),
                                        jnp.asarray(rids))))


@pytest.mark.parametrize("r,d,block_n", [(128, 16, 8), (1024, 64, 8),
                                         (1024, 64, 16), (336, 100, 8)])
def test_gather_row_tiles_plain_matches_pallas(r, d, block_n):
    rng = np.random.default_rng(r + d + block_n)
    bd = min(512, max(128, d))
    data = rng.integers(-1000, 1000, (r, bd)).astype(np.int32)
    tiles = rng.permutation(r // block_n)[:max(1, r // (3 * block_n))]
    tiles = np.concatenate([tiles, [r // block_n - 1, 0]]).astype(np.int32)
    want = np.asarray(rcg.gather_row_tiles(
        jnp.asarray(data), jnp.asarray(tiles), block_n=block_n, block_d=bd,
        interpret=True))
    got = cg.gather_row_tiles(torch.from_numpy(data), tiles, block_n=block_n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.gather_row_tiles_ref(torch.from_numpy(data),
                                  torch.from_numpy(tiles), block_n).numpy(),
        np.asarray(rref.gather_row_tiles_ref(jnp.asarray(data),
                                             jnp.asarray(tiles), block_n)))


@pytest.mark.parametrize("r,d,n,dtype", GATHER_SHAPES)
def test_checkout_gather_matches_reference_ops(r, d, n, dtype):
    rng = np.random.default_rng(r * d)
    data = (rng.standard_normal((r, d)) * 100).astype(dtype)
    rids = np.sort(rng.choice(r, n, replace=False)).astype(np.int32)
    want = np.asarray(rops.checkout_gather(data, rids))
    got = ops.checkout_gather(data, rids, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r,d,n,block_n,unsorted", [
    (128, 16, 50, 8, False), (1024, 64, 600, 8, True),
    (1024, 64, 600, 16, False), (333, 24, 100, 8, True),
    (257, 100, 257, 8, True), (1000, 3, 1, 8, False)])
def test_checkout_gather_tiled_matches_reference_ops(r, d, n, block_n,
                                                     unsorted):
    rng = np.random.default_rng(r + n)
    data = rng.integers(0, 1000, size=(r, d)).astype(np.int32)
    rids = np.sort(rng.choice(r, size=n, replace=False)).astype(np.int64)
    if unsorted:
        rids = rng.permutation(rids)
    packed_r, perm_r, waste_r = rops.checkout_gather_tiled(data, rids,
                                                           block_n=block_n)
    packed, perm, waste = ops.checkout_gather_tiled(
        data, rids, block_n=block_n, device="cpu")
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_r))
    np.testing.assert_array_equal(perm, perm_r)
    assert waste == waste_r
    np.testing.assert_array_equal(packed.numpy()[perm], data[rids])


def test_empty_rlist_gathers_nothing_where_the_reference_raises():
    """A version with no records: the reference's gathers raise (a Pallas
    grid of 0 steps, TypeError), the port's return an empty block and
    launch nothing (ROADMAP §C)."""
    data = np.arange(40 * 12, dtype=np.int32).reshape(40, 12)
    empty = np.zeros(0, np.int64)
    for fn in (rops.checkout_gather, rops.checkout_gather_tiled):
        with pytest.raises(TypeError):
            fn(data, empty)
    assert ops.checkout_gather(data, empty, device="cpu").shape == (0, 12)
    packed, perm, waste = ops.checkout_gather_tiled(data, empty,
                                                    device="cpu")
    assert packed.shape == (0, 12) and perm.shape == (0,)
    assert waste == rcg.plan_tiles(empty)[2]


def test_out_of_range_indices_raise_plan_error():
    data = torch.zeros((40, 128), dtype=torch.int32)
    for bad in ([0, 40], [-1], [39, 41, 2]):
        with pytest.raises(PlanError, match="outside"):
            cg.gather_rows(data, np.array(bad))
        with pytest.raises(PlanError, match="outside"):
            ops.checkout_gather(data, np.array(bad))
    for bad in ([0, 5], [-1]):
        with pytest.raises(PlanError, match="outside"):
            cg.gather_row_tiles(data, np.array(bad))
    with pytest.raises(PlanError, match="outside"):
        ops.checkout_gather_tiled(data, np.array([3, 40]))
    with pytest.raises(PlanError, match="multiple of BN"):
        cg.gather_row_tiles(data[:37], np.array([0]))
    with pytest.raises(ValueError, match="duplicate"):
        ops.checkout_gather_tiled(data, np.array([3, 3]))


def test_gather_tile_constants_match_reference():
    assert (cg.DEFAULT_BN, cg.DEFAULT_BD) == (rcg.DEFAULT_BN, rcg.DEFAULT_BD)


def test_kernel_package_exports_the_reference_names():
    """``repro_torch.kernels`` exports the JAX package's names, except that
    ``checkout_batched`` and ``checkout_gather`` stay the kernel modules
    (the wrappers are ``ops.checkout_batched``/``ops.checkout_gather``;
    ROADMAP §C)."""
    import types

    import repro.kernels as rk
    import repro_torch.kernels as tk
    for name in rk.__all__:
        assert hasattr(tk, name), name
        if name in ("checkout_batched", "checkout_gather"):
            assert isinstance(getattr(tk, name), types.ModuleType)
        elif name not in ("ops", "ref"):
            assert getattr(tk, name) is getattr(tk.ops, name), name
