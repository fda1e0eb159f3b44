"""The port on the card: the CUDA ``checkout_wave``, ``segment_append`` and
``segment_move`` against their plain torch versions, and the wave engine,
the server and the online write path (commit waves, a migration) on a CUDA
store against the numpy gather.  This file imports neither jax nor the JAX package, so it runs on
a machine with a GPU and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs the card and skips without one."""
import numpy as np
import pytest
import torch

import repro_torch.core.checkout as ck
import repro_torch.core.partition as part
import repro_torch.kernels.build as build
import repro_torch.kernels.checkout_batched as cb
import repro_torch.kernels.segment_append as sa
import repro_torch.kernels.segment_move as sm
from repro_torch.core import generate, store_from_arrays
from repro_torch.core.checkout import (checkout_wave,
                                       estimate_superblock_bytes,
                                       get_superblock_groups, peek_superblock)
from repro_torch.core.lyresplit import lyresplit_for_budget
from repro_torch.core.partition import plan_migration
from repro_torch.core.version_graph import to_tree
from repro_torch.serve import BatchedCheckoutServer, RetryPolicy

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _hand_plans(r):
    """A run tile, a row tile, a tail-promoted tile, a run ending at r and
    a run whose stale hi forces row gathers."""
    starts = np.concatenate([
        np.arange(0, 8), [3, 17, 5, r - 1, 2, 2, 30, 1],
        [20, 21, 22, 23, 23, 23, 23, 23], np.arange(r - 8, r),
        [10, 11, 12, 13, 13, 13, 13, 13]]).astype(np.int32)
    return (starts, np.array([1, 0, 1, 1, 1], np.int32),
            np.array([16, r, 32, r, 15], np.int32))


@pytest.mark.parametrize("dtype,d", [(torch.int32, 128),
                                     (torch.float16, 256),
                                     (torch.float32, 512)])
def test_cuda_checkout_wave_matches_plain(cuda_device, dtype, d):
    data = torch.arange(40 * d).reshape(40, d).to(dtype).to(cuda_device)
    s, m, h = (torch.from_numpy(a).to(cuda_device) for a in _hand_plans(40))
    before = cb.LAUNCHES
    got = cb.checkout_wave(data, s, m, h)
    assert cb.LAUNCHES == before + 1
    want = cb.checkout_wave_plain(data, s, m, h)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[32:40], data[s[32:40].long()])   # stale hi


def test_cuda_checkout_wave_rejects_misaligned_rows(cuda_device):
    data = torch.zeros((16, 6), dtype=torch.int16, device=cuda_device)
    s, m, h = (torch.zeros(n, dtype=torch.int32, device=cuda_device)
               for n in (8, 1, 1))
    with pytest.raises(ValueError):          # 12-byte rows
        cb.checkout_wave(data, s, m, h)


def _store(device, seed=0):
    w = generate("SCI", n_versions=60, inserts=80, n_branches=6,
                 n_attrs=20, seed=seed)
    rng = np.random.default_rng(seed)
    assignment = rng.permutation(np.arange(w.n_versions) % 5)
    return store_from_arrays(w.graph.indptr, w.graph.indices,
                             w.graph.n_records, w.data, assignment,
                             device=device), w


def test_cuda_wave_engine_matches_numpy(cuda_device):
    store, w = _store(cuda_device)
    vids = [0, 7, 7, 31, 59, 12]
    res = checkout_wave(store, vids, device_out=True)
    part = res.parts[0]
    assert part.packed.is_cuda and part.event is not None
    mats = res.materialize()
    assert res.ready()
    for m, v in zip(mats, vids):
        np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    for engine_mats in (store.checkout_many(vids, engine="perpart"),
                        store.checkout_many(vids, use_kernel=False)):
        for m, v in zip(engine_mats, vids):
            np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])


def test_cuda_server_stream_matches_numpy(cuda_device):
    store, w = _store(cuda_device, seed=1)
    srv = BatchedCheckoutServer(store)
    srv.warmup()
    rng = np.random.default_rng(1)
    before = cb.LAUNCHES
    for _ in range(4):
        vids = rng.choice(w.n_versions, 12).tolist()
        for m, v in zip(srv.serve(vids), vids):
            np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    srv.close()
    assert cb.LAUNCHES - before == 4
    assert peek_superblock(store).uploads == 1
    assert srv.stats.degraded_waves == 0
    assert int(store._inflight_waves) == 0


def test_cuda_ladder_raises_instead_of_serving_on_the_cpu(cuda_device,
                                                          monkeypatch):
    """With a RetryPolicy, a kernel that fails to launch on every attempt
    makes the wave fail and re-queue: the ladder has no host rung on the
    card, so nothing is served by the CPU's numpy gather."""
    store, w = _store(cuda_device, seed=2)
    srv = BatchedCheckoutServer(
        store, retry=RetryPolicy(attempts=2, sleep=lambda s: None))
    srv.warmup()
    vids = [0, 7, 31, 59]
    tickets = srv.submit_many(vids)
    with monkeypatch.context() as m:
        m.setattr(build, "kernel_fn", lambda name: (lambda *args: 700))
        with pytest.raises(RuntimeError, match="cudaError 700"):
            srv.flush()
    st = srv.stats
    assert (st.retries, st.requeues, st.degraded_waves, st.waves) == \
        (4, 1, 0, 0)
    assert int(store._inflight_waves) == 0
    srv.flush()                               # the re-queued wave, on the card
    for t, v in zip(tickets, vids):
        np.testing.assert_array_equal(srv.result(t), w.data[w.graph.rlist(v)])
    srv.close()
    assert srv.stats.degraded_waves == 0


SEGMENT_PLANS = {
    "segment_append": (sa, sa.segment_append, sa.segment_append_plain,
                       [0, 1, 2, 0, 1, 2, 0, 1], [0, 8, 0, 32, 16, 5, 3, 1]),
    "segment_move": (sm, sm.segment_move, sm.segment_move_plain,
                     [0, 1, 0, 1, 0, 1, 1, 0], [32, 16, 0, 3, 5, 0, 9, 17]),
}


@pytest.mark.parametrize("kernel", sorted(SEGMENT_PLANS))
@pytest.mark.parametrize("dtype,d", [(torch.int32, 128),
                                     (torch.float16, 256),
                                     (torch.float32, 512)])
def test_cuda_segment_kernel_matches_plain(cuda_device, kernel, dtype, d):
    mod, wrapper, plain, sel, starts = SEGMENT_PLANS[kernel]
    src = torch.arange(40 * d).reshape(40, d).to(dtype).to(cuda_device)
    delta = (-torch.arange(24 * d)).reshape(24, d).to(dtype).to(cuda_device)
    before = mod.LAUNCHES
    got = wrapper(src, delta, np.array(sel), np.array(starts))
    assert mod.LAUNCHES == before + 1
    want = plain(src, delta, torch.tensor(sel, device=cuda_device),
                 torch.tensor(starts, device=cuda_device))
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        wrapper(src, delta, np.array([1]), np.array([17]))
    assert mod.LAUNCHES == before + 1


def test_cuda_segment_launch_refusal_raises(cuda_device):
    """A configuration the kernel refuses (here BN = 0) returns a CUDA
    error from the launch, and the wrapper raises instead of returning."""
    src = torch.zeros((16, 128), dtype=torch.int32, device=cuda_device)
    sel, starts = sa.upload(cuda_device, np.zeros(2, np.int32),
                            np.zeros(2, np.int32))
    for mod in (sa, sm):
        with pytest.raises(RuntimeError, match="cudaError"):
            mod._launch(src, src, sel, starts, 0)
    with pytest.raises(ValueError, match="16-byte"):
        sa.segment_append(src[:, :3].contiguous(), src[:, :3].contiguous(),
                          [0], [0])


def test_cuda_budget_store_commits_and_migrates(cuda_device, monkeypatch):
    """A store whose superblock budget is a third of its need serves from
    group superblocks on the card, takes two commit waves (in-place
    extension through segment_append) and a migration (segment_move), and
    every version still equals the numpy gather.  Each commit wave extends
    every touched pinned group on the card and evicts nothing, so no group
    was rebuilt lazily from the host."""
    w = generate("SCI", n_versions=60, inserts=80, n_branches=6,
                 n_attrs=20, seed=3)
    tree, _ = to_tree(w.graph, w.vgraph)
    n0 = 44
    ip = w.graph.indptr[:n0 + 1]
    pool = int(w.graph.indices[:ip[-1]].max()) + 1
    assignment = np.random.default_rng(3).permutation(np.arange(n0) % 8)
    store = store_from_arrays(ip, w.graph.indices[:ip[-1]], pool,
                              w.data[:pool], assignment, device=cuda_device)
    store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    srv = BatchedCheckoutServer(store)
    srv.warmup()
    mgr = get_superblock_groups(store)
    assert mgr.groups and all(sb._device.is_cuda
                              for sb in mgr.groups.values())
    reports = []
    refresh = ck.refresh_superblocks_after_commit

    def recorded(store, old_grids, **kwargs):
        touched = sum(1 for key in mgr.groups
                      if set(key) & set(int(q) for q in old_grids))
        reports.append((touched, refresh(store, old_grids, **kwargs)))
        return reports[-1][1]

    monkeypatch.setattr(part, "refresh_superblocks_after_commit", recorded)
    cur = pool
    for lo, hi in ((n0, 52), (52, 60)):       # both extend pinned groups
        commits = []
        for v in range(lo, hi):
            rl = w.graph.rlist(v)
            commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                            "new_rows": w.data[rl[rl >= cur]]})
            cur += int((rl >= cur).sum())
        appends = sa.LAUNCHES
        evictions = (mgr.evictions,
                     getattr(store, "_superblock_evictions", 0))
        tickets = srv.submit_commit(commits)
        srv.flush()
        assert [srv.result(t) for t in tickets] == list(range(lo, hi))
        touched, report = reports[-1]
        assert touched > 0 and report["extended"] == touched
        assert report["evicted"] == 0
        assert sa.LAUNCHES - appends == touched
        assert (mgr.evictions,
                getattr(store, "_superblock_evictions", 0)) == evictions
        assert all(sb._device.is_cuda and sb.epoch == store.epoch
                   for sb in mgr.groups.values())
    moves = sm.LAUNCHES
    assignment = lyresplit_for_budget(tree, 2 * w.n_records).best.assignment
    store.apply_migration(plan_migration(store, assignment))
    assert sm.LAUNCHES > moves
    vids = list(range(w.n_versions))
    for m, v in zip(srv.serve(vids), vids):
        np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    srv.close()
    assert mgr.pins - mgr.evictions == len(mgr.groups)
    assert all(sb._device is None or sb._device.is_cuda
               for sb in mgr.groups.values())
    assert int(store._inflight_waves) == 0


def test_cuda_kernel_fault_in_a_commit_wave_propagates(cuda_device,
                                                       monkeypatch):
    """A segment_append launch that fails on the card is not absorbed into
    eviction and a lazy rebuild from the host: commit_many raises the
    KernelError with the landed vids, the failed superblock is released,
    and reads stay right."""
    w = generate("SCI", n_versions=60, inserts=80, n_branches=6,
                 n_attrs=20, seed=4)
    tree, _ = to_tree(w.graph, w.vgraph)
    n0 = 50
    ip = w.graph.indptr[:n0 + 1]
    pool = int(w.graph.indices[:ip[-1]].max()) + 1
    store = store_from_arrays(ip, w.graph.indices[:ip[-1]], pool,
                              w.data[:pool], np.arange(n0) % 4,
                              device=cuda_device)
    ck.get_superblock(store)[0].device()
    commits, cur = [], pool
    for v in range(n0, 60):
        rl = w.graph.rlist(v)
        commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                        "new_rows": w.data[rl[rl >= cur]]})
        cur += int((rl >= cur).sum())
    kernel_fn = build.kernel_fn
    before = sa.LAUNCHES
    with monkeypatch.context() as m:
        m.setattr(build, "kernel_fn", lambda name: (
            (lambda *args: 700) if name == "segment_append"
            else kernel_fn(name)))
        with pytest.raises(build.KernelError, match="cudaError 700") as err:
            store.commit_many(commits)
    assert err.value.committed_vids == list(range(n0, 60))
    assert sa.LAUNCHES == before
    assert store.graph.n_versions == 60 and peek_superblock(store) is None
    vids = list(range(60))
    for got, v in zip(store.checkout_many(vids), vids):
        np.testing.assert_array_equal(got, w.data[w.graph.rlist(v)])
