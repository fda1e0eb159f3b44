"""The port's checkout kernel layer held against the JAX package: the numpy
planners (``plan_batched``, ``plan_batched_loop``, ``plan_tiles``,
``plan_wave``) equal the reference's, and the plain torch ``checkout_wave``
equals the Pallas kernel in interpret mode over the whole packed output.
Everything is integer data moved, never summed: equality is exact."""
import importlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.kernels.ops as rops
import repro_torch.kernels.checkout_batched as cb
import repro_torch.kernels.checkout_gather as cg
import repro_torch.kernels.ops as ops
from repro.core import generate
from repro.core.checkout import get_superblock as r_get_superblock
from repro.core.checkout import plan_wave as r_plan_wave
from repro.core.partition import PartitionedCVD as RefStore
from repro_torch.core.checkout import get_superblock, plan_wave
from repro_torch.core.partition import store_from_arrays
from repro_torch.kernels.ref import gather_batched_ref, gather_rows_ref

# the reference package re-exports wrappers under its kernel modules' names,
# so the modules themselves come from the import system
rcb = importlib.import_module("repro.kernels.checkout_batched")
rcg = importlib.import_module("repro.kernels.checkout_gather")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference kernel tier's Pallas traces are cached process-wide;
    drop them when this module ends, so that a later test file in the same
    process that counts fresh traces of the same kernel starts cold."""
    yield
    jax.clear_caches()

R = 512   # rid universe for generated rlists


def _plans_equal(a, b):
    for f in ("starts", "mode", "tile_offsets", "n_rows", "density"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _seeded_rlists(seed, k=6):
    rng = np.random.default_rng(seed)
    rls = []
    for i in range(k):
        kind = i % 4
        if kind == 0:
            s = int(rng.integers(0, R - 70))
            rls.append(np.arange(s, s + int(rng.integers(1, 70))))
        elif kind == 1:
            rls.append(np.sort(rng.choice(R, int(rng.integers(1, 50)),
                                          replace=False)))
        elif kind == 2:
            rls.append(np.zeros(0, np.int64))
        else:
            rls.append(rng.integers(0, R, int(rng.integers(1, 30))))
    return [np.asarray(r, np.int64) for r in rls]


@st.composite
def rlist_waves(draw):
    """K rlists mixing dense runs, scattered picks, duplicates and empties."""
    k = draw(st.integers(min_value=1, max_value=6))
    rls = []
    for _ in range(k):
        kind = draw(st.sampled_from(["empty", "run", "scatter", "dups"]))
        if kind == "empty":
            rls.append(np.zeros(0, np.int64))
        elif kind == "run":
            n = draw(st.integers(min_value=1, max_value=64))
            s = draw(st.integers(min_value=0, max_value=R - n))
            rls.append(np.arange(s, s + n, dtype=np.int64))
        elif kind == "scatter":
            n = draw(st.integers(min_value=1, max_value=48))
            rls.append(np.sort(np.asarray(
                draw(st.lists(st.integers(0, R - 1), min_size=n, max_size=n,
                              unique=True)), np.int64)))
        else:
            n = draw(st.integers(min_value=1, max_value=32))
            rls.append(np.asarray(
                draw(st.lists(st.integers(0, R - 1), min_size=n, max_size=n)),
                np.int64))
    return rls


# ------------------------------------------------------------- planners --
def test_tile_constants_match_reference():
    assert (cg.DEFAULT_BN, cg.DEFAULT_BD) == (rcg.DEFAULT_BN, rcg.DEFAULT_BD)


@pytest.mark.parametrize("block_n", [1, 4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_plan_batched_matches_reference_seeded(seed, block_n):
    rls = _seeded_rlists(seed)
    for thr in (0.0, 0.05, 0.5):
        _plans_equal(cb.plan_batched(rls, block_n, thr),
                     rcb.plan_batched(rls, block_n, thr))
        _plans_equal(cb.plan_batched_loop(rls, block_n, thr),
                     rcb.plan_batched_loop(rls, block_n, thr))


@settings(max_examples=40, deadline=None)
@given(rls=rlist_waves(), block_n=st.sampled_from([1, 2, 8]),
       thr=st.sampled_from([0.0, 0.05, 0.5, 1.0]))
def test_plan_batched_matches_reference_hypothesis(rls, block_n, thr):
    _plans_equal(cb.plan_batched(rls, block_n, thr),
                 rcb.plan_batched(rls, block_n, thr))
    _plans_equal(cb.plan_batched_loop(rls, block_n, thr),
                 rcb.plan_batched(rls, block_n, thr))


@settings(max_examples=40, deadline=None)
@given(rids=st.lists(st.integers(0, 4 * R), max_size=80, unique=True),
       block_n=st.sampled_from([1, 4, 8]))
def test_plan_tiles_matches_reference(rids, block_n):
    rids = np.sort(np.asarray(rids, np.int64))
    for x, y in zip(cg.plan_tiles(rids, block_n),
                    rcg.plan_tiles(rids, block_n)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        cg.plan_tiles(np.array([3, 3]), block_n)


def _store_pair(seed=0, n_partitions=4, n_versions=40):
    w = generate("SCI", n_versions=n_versions, inserts=60, n_attrs=20,
                 seed=seed)
    rng = np.random.default_rng(seed)
    assign = rng.permutation(np.arange(w.n_versions) % n_partitions)
    port = store_from_arrays(w.graph.indptr, w.graph.indices,
                             w.graph.n_records, w.data, assign, device="cpu")
    ref = RefStore(w.graph, w.data, assign)
    return port, ref, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_wave_matches_reference(seed):
    port, ref, w = _store_pair(seed)
    sb, _ = get_superblock(port)
    rsb, _ = r_get_superblock(ref)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        vids = rng.choice(w.n_versions, int(rng.integers(1, 9)),
                          replace=False).tolist()
        got, want = plan_wave(port, vids, sb), r_plan_wave(ref, vids, rsb)
        _plans_equal(got.plan, want.plan)
        np.testing.assert_array_equal(got.hi, want.hi)
        assert got.hi.dtype == np.int32 == got.plan.starts.dtype
        for a, b in zip(got.rebased, want.rebased):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the kernel itself --
def _hand_plans(r):
    """(starts, mode, hi) plans over r rows: a run tile, a row tile, a
    tail-promoted tile, a run ending at r, and a run whose stale hi forces
    row gathers."""
    starts = np.concatenate([
        np.arange(0, 8), [3, 17, 5, r - 1, 2, 2, 30, 1],
        [20, 21, 22, 23, 23, 23, 23, 23], np.arange(r - 8, r),
        [10, 11, 12, 13, 13, 13, 13, 13]]).astype(np.int32)
    mode = np.array([1, 0, 1, 1, 1], np.int32)
    hi = np.array([16, r, 32, r, 15], np.int32)
    return starts, mode, hi


def _ref_wave(data, starts, mode, hi, block_n, block_d):
    return np.asarray(rcb.checkout_wave(
        data, starts, mode, hi, block_n=block_n, block_d=block_d,
        interpret=True))


@pytest.mark.parametrize("dtype,d,block_d", [
    (np.int32, 128, 128), (np.float32, 256, 128), (np.int32, 512, 512)])
def test_plain_checkout_wave_matches_pallas_interpret(dtype, d, block_d):
    rng = np.random.default_rng(d)
    r = 40
    data = rng.integers(-1000, 1000, (r, d)).astype(dtype)
    starts, mode, hi = _hand_plans(r)
    got = cb.checkout_wave(torch.from_numpy(data), torch.from_numpy(starts),
                           torch.from_numpy(mode), torch.from_numpy(hi),
                           block_n=8).numpy()
    want = _ref_wave(data, starts, mode, hi, 8, block_d)
    assert got.shape == want.shape == (len(starts), d)
    np.testing.assert_array_equal(got, want)
    # the stale-hi tile degraded to row gathers: rows 10..13 then 13s
    np.testing.assert_array_equal(got[32:40], data[starts[32:40]])
    # the promoted tail ran: padding rows read past the version's last rid
    np.testing.assert_array_equal(got[16:24], data[20:28])


def test_plain_checkout_wave_matches_pallas_on_a_wave_plan():
    """A real plan_wave plan (tail promotion included) off a small store."""
    port, ref, w = _store_pair(3)
    sb, _ = get_superblock(port)
    wp = plan_wave(port, [1, 8, 17, 30, 39], sb)
    got = cb.checkout_wave(torch.from_numpy(sb.host),
                           torch.from_numpy(wp.plan.starts),
                           torch.from_numpy(wp.plan.mode),
                           torch.from_numpy(wp.hi),
                           block_n=sb.block_n).numpy()
    want = _ref_wave(sb.host, wp.plan.starts, wp.plan.mode, wp.hi,
                     sb.block_n, sb.bd)
    np.testing.assert_array_equal(got, want)
    assert int(wp.plan.mode.sum()) > 0


@pytest.mark.parametrize("n_attrs", [20, 130])
def test_ops_checkout_batched_matches_reference(n_attrs):
    rng = np.random.default_rng(n_attrs)
    data = rng.integers(0, 1 << 20, (300, n_attrs)).astype(np.int32)
    rls = _seeded_rlists(n_attrs, k=5)
    rls = [np.clip(r, 0, 299) for r in rls]
    got, plan = ops.checkout_batched(data, rls, device="cpu")
    want, rplan = rops.checkout_batched(data, rls, interpret=True)
    _plans_equal(plan, rplan)
    oracle = gather_batched_ref(torch.from_numpy(data), rls)
    for g, w_, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g, np.asarray(w_))
        np.testing.assert_array_equal(g, o)


def test_ops_checkout_batched_tiny_block_and_empty():
    data = np.arange(12, dtype=np.int32).reshape(3, 4)
    got, _ = ops.checkout_batched(data, [[0, 1, 2], [2]], device="cpu")
    np.testing.assert_array_equal(got[0], data)
    np.testing.assert_array_equal(got[1], data[[2]])
    empty, plan = ops.checkout_batched(data, [[], []], device="cpu")
    assert plan.n_tiles == 0 and [e.shape for e in empty] == [(0, 4)] * 2


def test_gather_rows_ref_matches_numpy():
    data = np.arange(40, dtype=np.int32).reshape(10, 4)
    rids = np.array([9, 0, 3, 3])
    np.testing.assert_array_equal(
        gather_rows_ref(torch.from_numpy(data), torch.from_numpy(rids)),
        data[rids])


def test_ops_helpers_match_reference():
    x = torch.arange(30, dtype=torch.int32).reshape(5, 6)
    np.testing.assert_array_equal(
        ops._pad_axis(x, 4, 1).numpy(),
        np.asarray(rops._pad_axis(x.numpy(), 4, 1)))
    np.testing.assert_array_equal(
        ops._pad_axis(x, 8, 0).numpy(),
        np.asarray(rops._pad_axis(x.numpy(), 8, 0)))
    for rids in ([3, 1, 2], [1, 2, 3], []):
        a, b = ops._validate_rlist(rids), rops._validate_rlist(rids)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
    with pytest.raises(ValueError):
        ops._validate_rlist([1, 1])


def test_wave_on_other_device_raises_and_plain_never_counts():
    """A tensor that is neither on the CPU nor on CUDA never silently runs
    the plain version; the plain version never counts as a launch."""
    before = cb.LAUNCHES
    meta = torch.empty((16, 128), dtype=torch.int32, device="meta")
    plan = [torch.zeros(n, dtype=torch.int32, device="meta")
            for n in (8, 1, 1)]
    with pytest.raises(ValueError):
        cb.checkout_wave(meta, *plan)
    data = torch.zeros((16, 128), dtype=torch.int32)
    cb.checkout_wave(data, torch.zeros(8, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32),
                     torch.full((1,), 16, dtype=torch.int32))
    assert cb.LAUNCHES == before
    with pytest.raises(ValueError):      # plan arrays must be int32
        cb.checkout_wave(data, torch.zeros(8, dtype=torch.int64),
                         torch.ones(1, dtype=torch.int32),
                         torch.full((1,), 16, dtype=torch.int32))



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; tests/test_torch_cuda.py holds "
                    "the card suite that runs without jax")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_checkout_batched_matches_pallas_interpret(cuda_device):
    """On a host with both a card and jax: the CUDA kernel's gathers equal
    the Pallas kernel's in interpret mode."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 20, (300, 20)).astype(np.int32)
    rls = [np.clip(r, 0, 299) for r in _seeded_rlists(5, k=5)]
    before = cb.LAUNCHES
    got, _ = ops.checkout_batched(data, rls, device=cuda_device)
    assert cb.LAUNCHES == before + 1
    want, _ = rops.checkout_batched(data, rls, interpret=True)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w_))
