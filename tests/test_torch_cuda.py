"""The port on the card: the CUDA ``checkout_wave``, ``segment_append``,
``segment_move``, ``gather_rows``, ``gather_row_tiles``, ``membership_scan``,
``version_aggregate``, ``flash_attention`` and ``ssd_scan`` against their
plain torch versions, and the wave engine, the server, the online write
path (commit waves, a migration), the durable path (a journaled commit
wave, a kill and ``restore(device="cuda")``), four threaded tenants, a
``VersionedDataset``, the bitmap analytics on a CUDA store against numpy,
a ``SMOKE``-size model forward through both model kernels, the
differentiable flash and SSD Functions' gradients against autograd through
their plain versions, a ``SMOKE``-size train step on the card against
the CPU's, a compressed step on a one-rank NCCL mesh against the same
step on a one-rank gloo mesh on the CPU, and a tensor- and
expert-parallel step on a one-rank NCCL (data, model) mesh against the
same step on CPU gloo.  This file imports neither jax nor the JAX package, so it runs
on a machine with a GPU and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs the card and skips without one."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.checkout as ck
import repro_torch.core.partition as part
import repro_torch.kernels.build as build
import repro_torch.kernels.checkout_batched as cb
import repro_torch.kernels.checkout_gather as cg
import repro_torch.kernels.flash_attention as fa
import repro_torch.kernels.ops as ops
import repro_torch.kernels.ssd_scan as ss
import repro_torch.kernels.version_agg as va
import repro_torch.kernels.vlist_membership as vm
import repro_torch.kernels.segment_append as sa
import repro_torch.kernels.segment_move as sm
from repro_torch import configs
from repro_torch.core import generate, store_from_arrays
from repro_torch.core.checkout import (checkout_wave,
                                       estimate_superblock_bytes,
                                       get_superblock_groups, peek_superblock)
from repro_torch.core.durability import StoreDurability
from repro_torch.core.lyresplit import lyresplit_for_budget
from repro_torch.core.partition import plan_migration
from repro_torch.core.version_graph import to_tree
from repro_torch.data import VersionedDataset
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import forward, init_params
from repro_torch.models.ssd import chunk_scan
from repro_torch.train import AdamW, make_train_step
from repro_torch.serve import (BatchedCheckoutServer, MultiTenantServer,
                               RetryPolicy, TenantQuota)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (aggregate_cases, membership_cases,  # noqa: E402
                        plain_flash)

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


def test_cuda_superblock_of_257_token_rows_commits_and_migrates(
        cuda_device):
    """Rows of 257 int32 (1,028 bytes, no whole number of 16-byte words):
    the superblock pads them to 260 (1,040 bytes), and the read waves
    (checkout_wave), a commit wave (segment_append) and a migration
    (segment_move) run on the card, every version equal to numpy."""
    w = generate("SCI", n_versions=40, inserts=60, n_branches=4,
                 n_attrs=257, seed=5)
    tree, _ = to_tree(w.graph, w.vgraph)
    n0 = 32
    ip = w.graph.indptr[:n0 + 1]
    pool = int(w.graph.indices[:ip[-1]].max()) + 1
    store = store_from_arrays(ip, w.graph.indices[:ip[-1]], pool,
                              w.data[:pool], np.arange(n0) % 4,
                              device=cuda_device)
    srv = BatchedCheckoutServer(store)
    srv.warmup()
    sb = peek_superblock(store)
    assert sb.d == 257 and sb._device.shape[1] == 260
    launches = (cb.LAUNCHES, sa.LAUNCHES, sm.LAUNCHES)
    vids = list(range(n0))
    for m, v in zip(srv.serve(vids), vids):
        np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    commits, cur = [], pool
    for v in range(n0, w.n_versions):
        rl = w.graph.rlist(v)
        commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                        "new_rows": w.data[rl[rl >= cur]]})
        cur += int((rl >= cur).sum())
    tickets = srv.submit_commit(commits)
    srv.flush()
    assert [srv.result(t) for t in tickets] == list(range(n0, w.n_versions))
    assignment = lyresplit_for_budget(tree, 2 * w.n_records).best.assignment
    plan = plan_migration(store, assignment)
    old = ck.take_superblock(store)      # migrated on the card, not rebuilt
    store.apply_migration(plan)
    new, stats = ck.migrate_superblock(store, old, plan)
    assert stats.used_device and new._device.shape[1] == 260
    vids = list(range(w.n_versions))
    for m, v in zip(srv.serve(vids), vids):
        np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    srv.close()
    assert cb.LAUNCHES > launches[0] and sa.LAUNCHES > launches[1] \
        and sm.LAUNCHES == launches[2] + 1
    assert peek_superblock(store) is new


def test_cuda_prompt_store_of_257_token_rows(cuda_device):
    """The serve driver's prompt store at a prompt length of 257: one
    checkout_wave on the card, the same prompts as on the CPU."""
    from repro_torch.launch.serve import prompt_store
    before = cb.LAUNCHES
    got = prompt_store(1000, requests=4, prompt_len=257, device=cuda_device,
                       log=lambda *_: None)
    assert cb.LAUNCHES == before + 1
    want = prompt_store(1000, requests=4, prompt_len=257, device="cpu",
                        log=lambda *_: None)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 257)


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


@pytest.mark.parametrize("dtype,d", [(torch.int32, 128),
                                     (torch.float16, 256),
                                     (torch.float32, 512)])
def test_cuda_gather_kernels_match_plain(cuda_device, dtype, d):
    """Both gathers against their plain versions: unsorted rids with
    duplicates and the last row, N not a multiple of BN; tiles out of
    order, the last tile included.  Out-of-range indices raise PlanError
    on the host and launch nothing."""
    data = torch.arange(48 * d).reshape(48, d).to(dtype).to(cuda_device)
    rids = np.array([47, 3, 3, 20, 0, 9, 31, 8, 47, 12, 5], np.int32)
    tiles = np.array([5, 0, 2, 2, 3], np.int32)
    before = dict(cg.LAUNCHES)
    got = cg.gather_rows(data, rids)
    got_t = cg.gather_row_tiles(data, tiles)
    assert cg.LAUNCHES == {k: v + 1 for k, v in before.items()}
    want = cg.gather_rows_plain(data, torch.from_numpy(rids).cuda())
    want_t = cg.gather_row_tiles_plain(data, torch.from_numpy(tiles).cuda())
    torch.cuda.synchronize()
    assert got.shape == (11, d) and torch.equal(got, want)
    assert got_t.shape == (40, d) and torch.equal(got_t, want_t)
    with pytest.raises(build.PlanError, match="outside"):
        cg.gather_rows(data, np.array([0, 48]))
    with pytest.raises(build.PlanError, match="outside"):
        cg.gather_row_tiles(data, np.array([-1]))
    with pytest.raises(build.PlanError, match="outside"):
        ops.checkout_gather_tiled(data, np.array([2, 48]))
    assert cg.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert ops.checkout_gather(data, np.zeros(0, np.int64)).shape == (0, d)


def _bitmap(r, n_versions, seed):
    """A random bitset with every 7th row of version 31 (bit 31) set, an
    empty version 5 and a full last version."""
    rng = np.random.default_rng(seed)
    rlists = [np.flatnonzero(rng.random(r) < 0.3) for _ in range(n_versions)]
    if n_versions > 31:
        rlists[31] = np.arange(0, r, 7)
    rlists[5] = np.zeros(0, np.int64)
    rlists[-1] = np.arange(r)
    return ops.build_bitmap(rlists, r), rlists


@pytest.mark.parametrize("n_versions", [20, 1000, 1270])   # W = 1, 32, 40
def test_cuda_membership_scan_layouts_match_plain(cuda_device, n_versions):
    """membership_scan against its plain version at W = 1, 32 and 40 words
    in both layouts and a word-major view off 16 bytes, R = 2500, 2501,
    2503 and 7, block_r 1024, 96, 100 and 98, bit 31 and the last version
    (``chip_smoke.membership_cases``): one launch a case, masks and counts
    exact, the vec4 instance exactly on aligned word-major runs."""
    vids = {0, 5, min(31, n_versions - 1), n_versions - 1}
    before = vm.LAUNCHES
    cases = membership_cases(torch, np, np.random.default_rng(n_versions),
                             n_versions)
    assert cases == 4 * 3 * 4 * len(vids) == vm.LAUNCHES - before


@pytest.mark.parametrize("n_versions", [20, 1000, 1270])   # W = 1, 32, 40
def test_cuda_bitmap_kernels_match_plain(cuda_device, n_versions):
    """membership_scan and version_aggregate against their plain versions
    at W = 1, 32 and 40 words, R = 2500 (a multiple neither of 16 nor of
    the aggregate's chunk), block_r 1024, 96 and 100.  Masks and counts
    are exact.  ``chip_smoke.aggregate_cases`` holds the aggregate's sums:
    integer sums exact, other float sums (signed, near 2^120, near 2^-100)
    within ``chip_smoke.sum_rtol`` of the sum of the terms' absolute
    values, NaN and inf where the plain version has them, and the same
    bits on every run, whatever block_r.  The aggregate refuses the
    word-major view."""
    r = 2500
    bm, rlists = _bitmap(r, n_versions, n_versions)
    words = ops.as_bitmap(bm, cuda_device)
    vids = sorted({0, 5, min(31, n_versions - 1), n_versions - 1})
    for br in (1024, 96, 100):
        for vid in vids:
            before = vm.LAUNCHES
            mask, cnt = vm.membership_scan(words, vid, block_r=br)
            assert vm.LAUNCHES == before + 1
            want_m, want_c = vm.membership_scan_plain(words, vid, block_r=br)
            torch.cuda.synchronize()
            assert torch.equal(mask, want_m) and torch.equal(cnt, want_c)
            assert cnt.shape == (-(-r // br),)
            assert int(cnt.sum()) == len(rlists[vid])
    before = va.LAUNCHES
    assert aggregate_cases(torch, np, np.random.default_rng(n_versions), bm,
                           words) == 7
    assert va.LAUNCHES == before + 4 * 3 + 3 * 2
    sizes = ops.version_aggregate(words, np.ones(r, np.float32)).cpu()
    assert sizes.shape == (32 * bm.shape[1],)
    assert sizes[:n_versions].tolist() == [len(x) for x in rlists]
    assert not sizes[n_versions:].any()
    if bm.shape[1] > 1:          # at W = 1 the two layouts are one
        with pytest.raises(build.PlanError, match="word_major view"):
            ops.version_aggregate(ops.word_major(words),
                                  np.ones(r, np.float32))


def test_cuda_bitmap_kernels_small_and_empty(cuda_device):
    """R smaller than BR, and R = 0: the launcher guards the empty grid."""
    bm, rlists = _bitmap(5, 40, 0)
    mask, cnt = ops.membership_scan(bm, 39, device=cuda_device)
    assert mask.tolist() == [1] * 5 and cnt.tolist() == [5]
    out = ops.version_aggregate(bm, np.ones(5), device=cuda_device)
    assert out[:40].tolist() == [len(x) for x in rlists]
    empty = np.zeros((0, 2), np.uint32)
    mask, cnt = ops.membership_scan(empty, 63, device=cuda_device)
    assert mask.shape == (0,) and cnt.shape == (0,)
    out = ops.version_aggregate(empty, np.zeros(0), device=cuda_device)
    assert out.shape == (64,) and not out.any()


def test_cuda_new_kernels_refuse_launches(cuda_device):
    """A configuration a kernel refuses returns a CUDA error from its C
    entry point, and each wrapper raises KernelError instead of returning;
    an out-of-range vid is refused on the host."""
    data = torch.zeros((16, 128), dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(build.KernelError, match="cudaError"):
        cg._launch("gather_rows", data, idx[:0], 1, 0)       # BN = 0
    with pytest.raises(build.KernelError, match="cudaError"):
        cg._launch("gather_row_tiles", data, idx, 2, 0)
    words = ops.as_bitmap(np.zeros((40, 2), np.uint32), cuda_device)
    with pytest.raises(build.KernelError, match="cudaError"):
        vm._launch(words, 64, 1024)                          # vid past W
    wide = torch.zeros((1, 32 * 65536), dtype=torch.int32, device=cuda_device)
    with pytest.raises(build.KernelError, match="cudaError"):
        va._launch(wide, torch.zeros(1, device=cuda_device), 1024)  # W groups
    with pytest.raises(build.PlanError, match="block_r"):
        va._launch(words, torch.zeros(40, device=cuda_device), 0)
    with pytest.raises(build.PlanError, match="outside"):
        ops.membership_scan(words, 64)
    with pytest.raises(build.PlanError, match="16-byte"):
        cg.gather_rows(data[:, :3].contiguous(), [0])


def test_cuda_versioned_dataset_matches_numpy(cuda_device):
    """Every version of a small card store checked out tiled and untiled
    equals the numpy gather bit for bit, through one launch each; batches
    equal a CPU dataset's; the analytics over its bitset vlists equal the
    CSR's sizes."""
    store, w = _store(cuda_device, seed=5)
    ds = VersionedDataset(store=store, seq_len=15)
    cpu = VersionedDataset.from_graph(w.graph, w.data, store.assignment,
                                      seq_len=15, device="cpu")
    before = dict(cg.LAUNCHES)
    for v in range(w.n_versions):
        p = store.partitions[store.vid_to_pid[v]]
        want = p.block[np.sort(p.local_rlist(v))]
        np.testing.assert_array_equal(ds.checkout(v), want)
        np.testing.assert_array_equal(ds.checkout(v, use_tiled=False), want)
        np.testing.assert_array_equal(want, w.data[w.graph.rlist(v)])
    for v in (3, 31):
        for a, b in zip(ds.batches(v, global_batch=4, seed=2, n_steps=5),
                        cpu.batches(v, global_batch=4, seed=2, n_steps=5)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
    nonempty = sum(len(w.graph.rlist(v)) > 0 for v in range(w.n_versions))
    assert cg.LAUNCHES["gather_row_tiles"] - before["gather_row_tiles"] == \
        nonempty + 2 - sum(len(w.graph.rlist(v)) == 0 for v in (3, 31))
    assert cg.LAUNCHES["gather_rows"] - before["gather_rows"] == nonempty
    bm = ops.build_bitmap(w.graph.rlists(), w.n_records)
    sizes = ops.version_aggregate(bm, np.ones(w.n_records), device=cuda_device)
    assert sizes.cpu()[:w.n_versions].tolist() == \
        w.graph.version_sizes().tolist()


# flash cases: (B, Sq, Sk, H, Hkv, Dh, causal), or (..., causal, Dv) with v
# narrower than q — GQA groups 1, 2, 4 and MQA; Dh 16, 32, 48, 64, 80, 112,
# 128 and 256; latent attention's (192, 128) (bf16: the wgmma instance;
# DeepSeek-V2-Lite's prefill shape among them) and (192, 64) (v padded to
# 192); S from 16 to 4096 + 77, and lengths off the wgmma instance's
# 128-row and 64-key tiles, the mma.sync instance's 64 and the TPU kernel's
# 128 (200, 77, 4173, Sk 192, 328, 136, 333); Sq != Sk without the mask
FLASH_CASES = [(2, 256, 256, 4, 4, 64, True), (1, 512, 512, 4, 2, 128, True),
               (2, 128, 128, 8, 2, 80, False),
               (1, 1024, 1024, 4, 1, 80, True),
               (1, 384, 384, 2, 2, 256, True), (2, 16, 16, 4, 4, 16, True),
               (1, 256, 256, 6, 3, 80, False), (1, 200, 200, 4, 2, 64, True),
               (2, 77, 77, 2, 1, 80, True), (1, 128, 192, 4, 4, 32, False),
               (1, 200, 328, 2, 2, 128, False),
               (1, 4173, 4173, 2, 1, 80, True), (1, 200, 200, 8, 2, 80, True),
               (2, 300, 136, 4, 2, 64, False), (1, 333, 333, 4, 4, 48, True),
               (1, 256, 256, 2, 2, 112, True), (1, 130, 130, 4, 4, 72, True),
               (4, 512, 512, 16, 16, 192, True, 128),
               (1, 333, 333, 4, 2, 192, True, 128),
               (2, 200, 328, 4, 1, 192, False, 128),
               (1, 96, 96, 2, 2, 192, True, 64)]
# the shapes of the serve phases of the encoder-decoder and the vlm:
# Seamless-M4T-medium's encoder self-attention (non-causal, 544 frames),
# its decoder's causal self-attention and its cross-attention (512 queries
# against 544 frames), and LLaVA-NeXT-34B's causal GQA, 7 query heads a kv
# head, at Dh 128
FAMILY_FLASH_CASES = [(4, 544, 544, 16, 16, 64, False),
                      (4, 512, 512, 16, 16, 64, True),
                      (4, 512, 544, 16, 16, 64, False),
                      (4, 1024, 1024, 56, 8, 128, True)]
# the reference's tolerances (tests/test_flash_attention.py,
# tests/test_ssd_kernel.py): the kernel and the plain version sum in
# different orders; bf16 outputs are one rounding apart at most
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


def _randn(shape, seed, dtype, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES + FAMILY_FLASH_CASES, ids=str)
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    b, sq, sk, h, hkv, dh, causal, *rest = case
    dv = rest[0] if rest else dh
    q = _randn((b, sq, h, dh), 1, dtype, cuda_device)
    k = _randn((b, sk, hkv, dh), 2, dtype, cuda_device)
    # v as latent attention makes it: kv[..., dn:] of rows dn + dv wide,
    # dn = dh - 64 (DeepSeek-V2's qk_nope beside its qk_rope)
    dn = dh - 64 if dv != dh else dh
    kv = _randn((b, sk, hkv, dn + dv), 3, dtype, cuda_device)
    v = kv[..., dn:] if dv != dh else kv[..., :dh].contiguous()
    if (dh, dv) == (192, 128) and dtype == torch.bfloat16:
        assert fa.instance(q, k, v) == "wgmma"
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, sq, h, dv)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


# ssd cases: (B, L, H, P, N, chunk) — chunk 16, 64, 256; N 16, 64, 128;
# P 16, 64; 1 to 16 chunks (chunk 256: 1 and 16)
SSD_CASES = [(2, 256, 4, 64, 128, 128), (1, 512, 2, 64, 64, 256),
             (2, 128, 8, 16, 16, 16), (1, 512, 3, 64, 128, 64),
             (1, 256, 2, 16, 64, 256), (2, 4096, 2, 64, 64, 256),
             (1, 4096, 2, 64, 128, 256), (1, 96, 3, 20, 36, 96)]


def _ssd_inputs(b, l, h, p, n, dtype, device, seed=0):
    xs = _randn((b, l, h, p), seed, dtype, device)
    bm = _randn((b, l, n), seed + 1, dtype, device, 0.3)
    cm = _randn((b, l, n), seed + 2, dtype, device, 0.3)
    dt = torch.nn.functional.softplus(
        _randn((b, l, h), seed + 3, torch.float32, device)).to(dtype)
    a = -torch.exp(_randn((h,), seed + 4, torch.float32, device, 0.2))
    return xs, bm, cm, dt, a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_cuda_ssd_scan_matches_plain(cuda_device, case, dtype):
    b, l, h, p, n, chunk = case
    args = _ssd_inputs(b, l, h, p, n, dtype, cuda_device)
    before = ss.LAUNCHES
    y, state = ops.ssd_scan(*args, chunk=chunk)
    assert ss.LAUNCHES == before + 1
    y_want, state_want = ss.ssd_scan_plain(*args, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and state.dtype == torch.float32
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_ssd_scan_carries_the_state(cuda_device, dtype):
    """Decay about 1 and x zero past the first chunk: the last chunks see
    only the carried state (tests/test_ssd_kernel.py's case), through the
    float32 instance and through the bf16 instance's state-passing pass."""
    b, l, h, p, n = 1, 256, 2, 32, 64
    xs = torch.zeros((b, l, h, p), device=cuda_device, dtype=dtype)
    xs[:, :64] = _randn((b, 64, h, p), 0, dtype, cuda_device)
    bm = _randn((b, l, n), 1, dtype, cuda_device, 0.3)
    cm = _randn((b, l, n), 2, dtype, cuda_device, 0.3)
    dt = torch.full((b, l, h), 0.05, device=cuda_device, dtype=dtype)
    a = torch.full((h,), -0.01, device=cuda_device)
    y, state = ops.ssd_scan(xs, bm, cm, dt, a, chunk=64)
    want, state_want = ss.ssd_scan_plain(xs, bm, cm, dt, a, 64)
    torch.cuda.synchronize()
    assert float(y[:, 200:].float().abs().max()) > 1e-4
    tol = {torch.float32: 2e-4, torch.bfloat16: SSD_TOL[torch.bfloat16]}[dtype]
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dh", [16, 48, 64, 80, 112, 128])
def test_cuda_flash_attention_runs_the_wgmma_instance(cuda_device, dh):
    """bf16 with Dh a multiple of 16 up to 128 runs the wgmma + TMA
    instance, wherever its operands start: the wrapper copies one that
    starts off a 16-byte boundary, and the counted launch refuses it.
    Other bf16 head dims run mma.sync, and float32 the FMA instance."""
    q = _randn((1, 128, 2, dh), 1, torch.bfloat16, cuda_device)
    assert fa.instance(q, q, q) == "wgmma"
    assert fa.instance(q.float(), q.float(), q.float()) == "fma"
    odd = _randn((1, 128, 2, dh + 8), 1, torch.bfloat16, cuda_device)
    assert fa.instance(odd, odd, odd) == "mma_sync"
    flat = torch.zeros(2 * 128 * dh + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(1, 128, 2, dh)           # 2 bytes off 16
    shifted.copy_(q)
    assert fa.instance(shifted, q, q) == "wgmma"
    with pytest.raises(build.PlanError, match="16-byte"):
        fa._launch(shifted, q, q, True)
    before = fa.LAUNCHES
    got = ops.flash_attention(shifted, q, q)
    assert fa.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), fa.flash_attention_plain(
        shifted, q, q).float(), atol=2e-2, rtol=2e-2)


def test_cuda_flash_attention_instances_by_both_widths(cuda_device):
    """The instance is fixed by dtype, Dqk and Dv: latent attention's
    (192, 128) in bf16 runs the wgmma instance; (192, 192) stays on
    mma.sync and float32 on the FMA instance; a v narrower than q at any
    other pair runs the instance of (Dqk, Dqk) on v zero-padded, and
    agrees with the plain version on the unpadded v."""
    def make(dqk, dv, dtype):
        q = _randn((1, 128, 2, dqk), 1, dtype, cuda_device)
        return q, q, _randn((1, 128, 2, dv), 2, dtype, cuda_device)

    bf, f32 = torch.bfloat16, torch.float32
    for dqk, dv, dtype, want in ((192, 128, bf, "wgmma"),
                                 (192, 192, bf, "mma_sync"),
                                 (192, 128, f32, "fma"),
                                 (192, 64, bf, "mma_sync"),
                                 (128, 64, bf, "wgmma"),
                                 (80, 48, f32, "fma")):
        q, k, v = make(dqk, dv, dtype)
        assert fa.instance(q, k, v) == want, (dqk, dv, dtype)
        before = fa.LAUNCHES
        got = ops.flash_attention(q, k, v)
        assert fa.LAUNCHES == before + 1
        torch.testing.assert_close(
            got.float(), fa.flash_attention_plain(q, k, v).float(),
            atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


def test_cuda_model_kernels_refuse(cuda_device):
    """The contract is checked before any launch (PlanError), and the C
    entry points refuse on their own (KernelError)."""
    q = torch.zeros((1, 128, 2, 64), device=cuda_device)
    with pytest.raises(build.PlanError, match="multiple of Hkv"):
        ops.flash_attention(q, q[:, :, :1].repeat(1, 1, 3, 1),
                            q[:, :, :1].repeat(1, 1, 3, 1))   # H 2, Hkv 3
    wide = torch.zeros((1, 128, 2, 512), device=cuda_device)
    with pytest.raises(build.PlanError, match="head_dim"):
        ops.flash_attention(wide, wide, wide)
    args = _ssd_inputs(1, 96, 2, 16, 16, torch.float32, cuda_device)
    with pytest.raises(build.PlanError, match="multiple"):
        ops.ssd_scan(*args, chunk=64)                # 96 % 64
    big = _ssd_inputs(1, 64, 2, 16, 256, torch.float32, cuda_device)
    with pytest.raises(build.PlanError, match="d_state"):
        ops.ssd_scan(*big, chunk=64)
    with pytest.raises(build.PlanError, match="wider than q"):
        ops.flash_attention(q, q, wide[..., :96])    # Dv 96 > Dqk 64
    fn = build.flash_fn()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = q.data_ptr()
    assert fn(ptr, ptr, ptr, ptr, None, 1, 128, 128, 3, 2, 64, 64, 64, 1, 0,
              stream) != 0
    # bf16 at Dh 64 runs the wgmma instance, whose tensor map refuses a q
    # that starts off a 16-byte boundary
    assert fn(ptr + 2, ptr, ptr, ptr, None, 1, 128, 128, 2, 2, 64, 64, 64, 1,
              1, stream) != 0
    # an lse is written by the wgmma instance alone: the FMA one refuses it
    assert fn(ptr, ptr, ptr, ptr, ptr, 1, 128, 128, 2, 2, 64, 64, 64, 1, 0,
              stream) != 0
    # v wider than q, Dv <= 0, a pitch below Dv, and a pair that no
    # instance takes as it is (the wrapper pads it)
    for dqk, dv, ld in ((64, 96, 96), (64, 0, 64), (192, 128, 120),
                        (128, 64, 64)):
        assert fn(ptr, ptr, ptr, ptr, None, 1, 128, 128, 2, 2, dqk, dv, ld, 1,
                  1, stream) != 0
    sfn = build.ssd_fn()          # the bf16 instance without its scratch
    assert sfn(ptr, ptr, ptr, ptr, ptr, ptr, ptr, None, None, 1, 64, 2, 16,
               16, 64, 1, stream) != 0


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "internlm2_1_8b",
                                  "mamba2_780m"])
def test_cuda_smoke_forward_runs_both_kernels(cuda_device, arch):
    """A SMOKE-size forward on the card launches flash_attention once per
    self-attention and ssd_scan once per SSD layer, and agrees with the
    same weights' forward on the CPU within bf16's rounding (the bound the
    serve driver holds its prefill to)."""
    cfg = configs.smoke(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), cuda_device)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    before = (fa.LAUNCHES, ss.LAUNCHES)
    with torch.inference_mode():
        got = forward(model, {"tokens": tokens.to(cuda_device)}, cfg)
        want = forward(cpu, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    n_attn = {"dense": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.shared_every, 1)}[cfg.family]
    n_ssd = 0 if cfg.family == "dense" else cfg.n_layers
    assert (fa.LAUNCHES - before[0], ss.LAUNCHES - before[1]) == (n_attn,
                                                                   n_ssd)
    assert torch.isfinite(got).all()
    rel = (got.float().cpu() - want.float()).norm() / want.float().norm()
    assert rel <= prefill_bound(cfg), rel


def test_cuda_dataset_checks_out_rows_off_16_bytes(cuda_device):
    """The train launcher's corpus: records of 257 int32 tokens (1,028
    bytes, no whole number of 16-byte words), checked out tiled and
    untiled on the card."""
    w = generate("SCI", n_versions=6, inserts=40, n_branches=2, n_attrs=257,
                 seed=1)
    tree, _ = to_tree(w.graph, w.vgraph)
    sr = lyresplit_for_budget(tree, gamma=2.0 * w.n_records)
    ds = VersionedDataset.from_graph(w.graph, w.data, sr.best.assignment,
                                     seq_len=256, device=cuda_device)
    before = dict(cg.LAUNCHES)
    for v in range(w.n_versions):
        p = ds.store.partitions[ds.store.vid_to_pid[v]]
        want = p.block[np.sort(p.local_rlist(v))]
        for tiled in (True, False):
            np.testing.assert_array_equal(ds.checkout(v, use_tiled=tiled),
                                          want)
    nonempty = sum(len(w.graph.rlist(v)) > 0 for v in range(w.n_versions))
    assert cg.LAUNCHES["gather_row_tiles"] == \
        before["gather_row_tiles"] + nonempty
    assert cg.LAUNCHES["gather_rows"] == before["gather_rows"] + nonempty


# gradient cases (B, S, H, Hkv, Dh, causal[, Dv[, Sk]]): InternLM2-1.8B's
# training shape at S 256 and at the train-4k cell's S 4096 (one batch
# row of its 8), a ragged one (S 700, off the kernels' tiles and the plain
# backward's 512-key blocks), ragged S 1000, cross attention (Sq 300
# against Sk 520 and Sq 333 against Sk 170, non-causal), Dh 64 and 80,
# groups of 1 and 4, and latent attention's (192, 128)
GRAD_FLASH_CASES = [(8, 256, 16, 8, 128, True), (1, 700, 6, 2, 64, True),
                    (2, 300, 4, 4, 64, False),
                    (2, 512, 16, 16, 192, True, 128),   # latent attention
                    (1, 4096, 16, 8, 128, True), (1, 1000, 4, 2, 128, True),
                    (2, 300, 4, 2, 64, False, 64, 520),
                    (1, 333, 4, 1, 80, False, 80, 170),
                    (2, 256, 8, 8, 80, True), (1, 300, 8, 2, 64, True)]
# the bf16 gradients differ from autograd through the plain version by the
# kernel output's rounding (delta = do · o) and their own, 2^-9 each; the
# backward kernel's P and dS enter its products as bf16, inside the same
# bound (the plain float32 backward where the kernel does not take them)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 * 2.0 ** -8}


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GRAD_FLASH_CASES, ids=str)
def test_cuda_flash_gradients_match_autograd_through_plain(cuda_device, case,
                                                           dtype):
    """The backward kernel runs (one counted launch) at bf16 (Dh, Dh), Dh a
    multiple of 16 up to 128; every other case keeps the plain backward."""
    b, s, h, hkv, dh, causal, *rest = case
    dv = rest[0] if rest else dh
    sk = rest[1] if len(rest) > 1 else s
    q, k, v = (_randn(shape, seed, dtype, cuda_device).requires_grad_(True)
               for seed, shape in ((1, (b, s, h, dh)), (2, (b, sk, hkv, dh)),
                                   (3, (b, sk, hkv, dv))))
    do = _randn((b, s, h, dv), 4, dtype, cuda_device)
    kernel = dtype == torch.bfloat16 and dv == dh and dh % 16 == 0 \
        and dh <= 128
    assert fa.takes_backward(q, k, v) == kernel
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal),
                              (q, k, v), do)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 1,
                                              before[1] + kernel)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, causal),
                               (q, k, v), do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _rel(g, w) <= GRAD_TOL[dtype], (_rel(g, w), GRAD_TOL[dtype])


@pytest.mark.parametrize("case", [(2, 300, 300, 4, 2, 128, True),
                                  (1, 333, 170, 4, 1, 80, False),
                                  (1, 4096, 4096, 16, 8, 128, True)], ids=str)
def test_cuda_flash_forward_lse_matches_the_streamed_lse(cuda_device, case):
    """The lse the wgmma instance writes beside its output is ``_row_lse``
    (float32 products of the same operands) within float32 rounding, and
    the output is the one a launch without it gives."""
    b, sq, sk, h, hkv, dh, causal = case
    q = _randn((b, sq, h, dh), 1, torch.bfloat16, cuda_device)
    k = _randn((b, sk, hkv, dh), 2, torch.bfloat16, cuda_device)
    v = _randn((b, sk, hkv, dh), 3, torch.bfloat16, cuda_device)
    before = fa.LAUNCHES
    out, lse = fa.flash_attention(q, k, v, causal, lse=True)
    assert fa.LAUNCHES == before + 1
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert lse.stride() == (h * fa.lse_pitch(sq), fa.lse_pitch(sq), 1)
    want = ops._row_lse(q, k, causal).transpose(1, 2)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(out, ops.flash_attention(q, k, v, causal),
                               atol=0, rtol=0)


def test_cuda_flash_no_grad_forward_writes_no_lse(cuda_device, monkeypatch):
    """Serving (no grad) and inputs that need none make the forward's one
    launch without an lse; the backward kernel is not launched."""
    q = _randn((2, 256, 4, 128), 1, torch.bfloat16, cuda_device)
    kv = _randn((2, 256, 2, 128), 2, torch.bfloat16, cuda_device)
    seen = []
    real = fa._launch

    def launch(q, k, v, causal, lse=None):
        seen.append(lse)
        return real(q, k, v, causal, lse)
    monkeypatch.setattr(fa, "_launch", launch)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(True), kv, kv)
    ops.flash_attention(q.detach(), kv, kv)
    assert seen == [None, None]
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 2, before[1])
    ops.flash_attention(q, kv, kv)
    assert len(seen) == 3 and seen[2] is not None


def test_cuda_flash_backward_kernel_path_is_its_kernels_alone(cuda_device):
    """Inside the kernel path's ``attn.backward`` span the card runs the
    backward's own kernels (names holding ``flash_bwd``) and nothing else;
    the span carries the path and the call's shape."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import trace
    q = _randn((2, 512, 8, 128), 1, torch.bfloat16,
               cuda_device).requires_grad_(True)
    k, v = (_randn((2, 512, 4, 128), seed, torch.bfloat16,
                   cuda_device).requires_grad_(True) for seed in (2, 3))
    do = _randn((2, 512, 8, 128), 4, torch.bfloat16, cuda_device)
    out = ops.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
        spans = trace.spans()
    finally:
        trace.clear()
    from torch.autograd import DeviceType
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum("flash_bwd" in n for n in names) == 3, names
    assert all("flash_bwd" in n and "flash_fwd" not in n for n in names), \
        names
    span, = [s for s in spans if s.name == "attn.backward"]
    assert span.attrs == {"path": "kernel", "b": 2, "sq": 512, "sk": 512,
                          "h": 8, "hkv": 4, "dqk": 128, "dv": 128,
                          "causal": True}


def test_cuda_plain_flash_swap_covers_the_training_path(cuda_device):
    """``fa.flash_attention`` is the one name of every forward launch, the
    lse-writing one included: under ``chip_smoke.plain_flash``, which
    swaps that name alone, a SMOKE remat train step of InternLM2's shape
    launches neither the forward kernel nor the backward kernel, while
    the same step without it launches both (the forward twice a layer,
    the backward once)."""
    import contextlib
    import dataclasses
    cfg = dataclasses.replace(configs.smoke("internlm2_1_8b"), remat=True)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    counts = []
    for ctx in (contextlib.nullcontext(), plain_flash(torch)):
        model = init_params(cfg, torch.Generator().manual_seed(0),
                            cuda_device, trainable=True)
        opt = AdamW(lr=1e-3)
        before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
        with ctx:
            make_train_step(cfg, opt)(model, opt.init(model), batch)
        torch.cuda.synchronize()
        counts.append((fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1]))
    assert counts == [(2 * cfg.n_layers, cfg.n_layers), (0, 0)]


# Mamba2-780M's training shape per microbatch (B 4, L 256, 48 heads of 64,
# N 128, one chunk of 256) and a four-chunk case
GRAD_SSD_CASES = [(4, 256, 48, 64, 128, 256), (2, 512, 4, 64, 64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GRAD_SSD_CASES, ids=str)
def test_cuda_ssd_gradients_match_autograd_through_chunk_step(cuda_device,
                                                              case, dtype):
    b, l, h, p, n, chunk = case
    args = [t.requires_grad_(True)
            for t in _ssd_inputs(b, l, h, p, n, dtype, cuda_device)]
    dy = _randn((b, l, h, p), 9, dtype, cuda_device)
    before = ss.LAUNCHES
    y, _ = ops.ssd_scan(*args, chunk=chunk)
    got = torch.autograd.grad(y, args, dy)
    assert ss.LAUNCHES == before + 1
    y_want, _ = chunk_scan(*args, chunk)
    want = torch.autograd.grad(y_want, args, dy)
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_780m",
                                  "zamba2_2_7b", "deepseek_v2_lite_16b",
                                  "seamless_m4t_medium", "llava_next_34b"])
def test_cuda_smoke_train_step_matches_cpu(cuda_device, arch):
    """One ``make_train_step`` step of a SMOKE config with remat on, on the
    card and on the CPU from the same weights and batch: the kernels launch
    (twice a layer: the forward and remat's recompute), and the loss and
    every updated parameter agree within the bf16 bounds the CPU tests
    hold the reference to (``prefill_bound``, sqrt(2) times it per leaf)."""
    import dataclasses
    cfg = dataclasses.replace(configs.smoke(arch), remat=True)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    frames = {"encdec": ("enc_embeds", 80), "vlm": ("patch_embeds",
                                                   cfg.n_patches)}
    if cfg.family in frames:             # the stub frontend's input
        name, n = frames[cfg.family]
        batch[name] = torch.randn((2, n, cfg.d_model), generator=gen
                                  ).to(torch.bfloat16)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        model = init_params(cfg, torch.Generator().manual_seed(0), dev,
                            trainable=True)
        opt = AdamW(lr=1e-3)
        before = (fa.LAUNCHES, ss.LAUNCHES)
        model, _, m = make_train_step(cfg, opt)(model, opt.init(model), batch)
        out.append((float(m["loss"]), dict(model.named_parameters()),
                    (fa.LAUNCHES - before[0], ss.LAUNCHES - before[1])))
    n_attn = {"dense": cfg.n_layers, "ssm": 0, "moe": cfg.n_layers,
              "vlm": cfg.n_layers,
              "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
              "hybrid": cfg.n_layers // max(cfg.shared_every, 1)}[cfg.family]
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert out[0][2] == (2 * n_attn, 2 * n_ssd) and out[1][2] == (0, 0)
    bound = prefill_bound(cfg)
    assert abs(out[0][0] - out[1][0]) <= bound * abs(out[1][0])
    for name, p in out[1][1].items():
        assert _rel(out[0][1][name].cpu(), p) <= 2 ** 0.5 * bound, name


def test_cuda_trace_device_spans(cuda_device):
    """A SMOKE-size remat train step of InternLM2's shape with tracing on
    (``repro_torch.trace``): the device spans resolve to positive
    milliseconds, the attention backward's sum is at most the step's, and
    the spans opened on the autograd engine's device thread (the flash
    backward, remat's recompute) nest under ``train.backward``."""
    import dataclasses
    from repro_torch import trace
    cfg = dataclasses.replace(configs.smoke("internlm2_1_8b"), remat=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), cuda_device,
                        trainable=True)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW(lr=1e-3)
    trace.clear()
    trace.enable()
    try:
        make_train_step(cfg, opt)(model, opt.init(model), batch)
        spans = trace.spans()
    finally:
        trace.disable()
        trace.clear()
    step, = [s for s in spans if s.name == "train.step"]
    bwd, = [s for s in spans if s.name == "train.backward"]
    attn = [s for s in spans if s.name == "attn.backward"]
    assert len(attn) == cfg.n_layers
    assert step.device_ms > 0 and all(a.device_ms > 0 for a in attn)
    assert sum(a.device_ms for a in attn) <= step.device_ms
    assert all(a.parent == bwd.id and a.thread != bwd.thread for a in attn)
    assert all({"path", "b", "sq", "sk", "h", "hkv", "dqk", "dv",
                "causal"} <= a.attrs.keys() for a in attn)
    assert sum(s.name == "model.block" and s.parent == bwd.id
               for s in spans) == cfg.n_layers


def test_cuda_nccl_compressed_step_matches_cpu_gloo(cuda_device, tmp_path):
    """One compressed train step (``grad_compress=True``) of InternLM2's
    SMOKE config on a one-rank NCCL mesh (pod, data, model) = (1, 1, 1),
    FSDP-laid-out parameters and ``ef_init`` residuals, against the same
    step on a one-rank gloo mesh on the CPU (a spawned process: a process
    holds one group) from the same weights and batch: the flash kernel
    launches, and the loss and every parameter agree within the bf16
    bounds of ``test_cuda_smoke_train_step_matches_cpu``, and every
    residual is finite."""
    import torch.distributed as dist
    import torch_ranks as R
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_reference, to_reference
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, local, make_ctx
    from repro_torch.train import ef_init
    cfg = R.port_cfg("internlm2_1_8b")
    tree = to_reference(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(3)).numpy()
    np.savez(tmp_path / "in.npz", tokens0=toks[:, :-1], labels0=toks[:, 1:],
             **{"w/" + k: v for k, v in R.flat(tree).items()})
    spec = dict(arch="internlm2_1_8b", inputs=str(tmp_path / "in.npz"),
                shape=(1, 1, 1), lr=1e-3, f32=False)
    R.spawn(R.run_cases, 1, tmp_path, [("compressed", spec,
                                        str(tmp_path / "cpu"))])
    want = dict(np.load(tmp_path / "cpu.npz"))
    weights, batches = R.load_inputs(spec["inputs"])
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    try:
        assert dist.get_backend() == "nccl"
        ctx = make_ctx(mesh)
        model = from_reference(cfg, weights, device="cuda"
                               ).requires_grad_(True)
        distribute(model, param_specs(cfg), mesh)
        opt = AdamW(lr=1e-3)
        ef = ef_init(model, 1, ctx)
        before = fa.LAUNCHES
        model, _, ef, m = make_train_step(cfg, opt, grad_compress=True,
                                          ctx=ctx)(model, opt.init(model),
                                                   ef, batches[0])
        launched = fa.LAUNCHES - before
        got = R.flat(to_reference(model, {n: local(p).detach().cpu()
                                          for n, p in
                                          model.named_parameters()}))
        e_max = {n: float(local(e).abs().max()) for n, e in ef.items()}
        loss = float(m["loss"])
    finally:
        dist.destroy_process_group()
    assert launched == cfg.n_layers * (2 if cfg.remat else 1)
    bound = prefill_bound(cfg)
    assert abs(loss - want["loss"][0]) <= bound * abs(want["loss"][0])
    for k, v in got.items():
        assert _rel(torch.from_numpy(v), torch.from_numpy(want["p/" + k])) \
            <= 2 ** 0.5 * bound, k
    assert all(np.isfinite(list(e_max.values())))


def test_cuda_nccl_tensor_expert_parallel_step_matches_cpu_gloo(
        cuda_device, tmp_path):
    """One plain train step of DeepSeek-V2-Lite's SMOKE config (latent
    attention, a dense layer, MoE layers with a shared expert) on a
    one-rank NCCL (data, model) = (1, 1) mesh, through the tensor- and
    expert-parallel layers (their collectives on a one-rank group),
    against the same step on a one-rank gloo mesh on the CPU (a spawned
    process) from the same weights and batch: the flash kernel launches,
    the model group's collectives run, and the loss and every parameter
    agree within the bf16 bounds of
    ``test_cuda_smoke_train_step_matches_cpu``."""
    import torch.distributed as dist
    import torch_ranks as R
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_reference, to_reference
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import (TP_CALLS, distribute, local, make_ctx,
                                      zero_tp_calls)
    arch = "deepseek_v2_lite_16b"
    cfg = R.port_cfg(arch)
    tree = to_reference(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(4)).numpy()
    np.savez(tmp_path / "in.npz", tokens0=toks[:, :-1], labels0=toks[:, 1:],
             **{"w/" + k: v for k, v in R.flat(tree).items()})
    spec = dict(arch=arch, inputs=str(tmp_path / "in.npz"), mesh=(1, 1),
                lr=1e-3, f32=False, steps=1)
    R.spawn(R.run_cases, 1, tmp_path, [("plain", spec,
                                        str(tmp_path / "cpu"))])
    want = dict(np.load(tmp_path / "cpu.npz"))
    weights, batches = R.load_inputs(spec["inputs"])
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    try:
        assert dist.get_backend() == "nccl"
        ctx = make_ctx(mesh)
        model = from_reference(cfg, weights, device="cuda"
                               ).requires_grad_(True)
        distribute(model, param_specs(cfg), mesh)
        opt = AdamW(lr=1e-3)
        zero_tp_calls()
        before = fa.LAUNCHES
        model, _, m = make_train_step(cfg, opt, ctx=ctx)(
            model, opt.init(model), batches[0])
        launched = fa.LAUNCHES - before
        calls = dict(TP_CALLS)
        got = R.flat(to_reference(model, {n: local(p).detach().cpu()
                                          for n, p in
                                          model.named_parameters()}))
        loss = float(m["loss"])
    finally:
        dist.destroy_process_group()
    assert launched == cfg.n_layers * (2 if cfg.remat else 1)
    n_moe = cfg.n_layers - cfg.first_dense
    assert calls["all_to_all"] == 4 * n_moe
    assert calls["copy_to_tp"] > 0 and calls["reduce_from_tp"] > 0
    bound = prefill_bound(cfg)
    assert abs(loss - want["loss"][0]) <= bound * abs(want["loss"][0])
    for k, v in got.items():
        assert _rel(torch.from_numpy(v), torch.from_numpy(want["p/" + k])) \
            <= 2 ** 0.5 * bound, k


def test_cuda_nccl_mesh_serve_matches_cpu_gloo(cuda_device, tmp_path):
    """Zamba2's SMOKE config (SSD layers and the shared attention block)
    served on a one-rank NCCL (data, model) = (1, 1) mesh in float32:
    ``make_prefill_step`` on 4 × 64 prompts, then 4 ``make_serve_step``
    decodes from a seeded cache laid out by ``cache_specs``, against the
    same serve on a one-rank gloo mesh on the CPU (a spawned process,
    ``tests/torch_ranks.py``'s ``serve`` case) from the same weights,
    prompts and cache: the logits within 1e-3 relative L2 (the float32
    kernels against their plain versions, ``FLASH_TOL``/``SSD_TOL``), the
    greedy tokens equal, the flash and SSD kernels launched and the
    model group's collectives run."""
    import torch.distributed as dist
    import torch_ranks as R
    from repro_torch.models import to_reference
    from repro_torch.models.transformer import init_cache_abstract
    arch = "zamba2_2_7b"
    cfg = R.port_cfg(arch)
    tree = to_reference(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
    rng = np.random.default_rng(5)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    arrays["prompt"] = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    for name, leaf in init_cache_abstract(cfg, 4, 16).items():
        arrays["cache/" + name] = (np.asarray(5, np.int32) if name == "len"
                                   else (0.5 * rng.standard_normal(
                                       tuple(leaf.shape))).astype(np.float32))
    np.savez(tmp_path / "in.npz", **arrays)
    spec = dict(arch=arch, inputs=str(tmp_path / "in.npz"), mesh=(1, 1),
                steps=4, max_len=16)
    R.spawn(R.run_cases, 1, tmp_path, [("serve", spec,
                                        str(tmp_path / "cpu"))])
    want = dict(np.load(tmp_path / "cpu.rank0.npz"))
    assert not dist.is_initialized()
    launched = {"flash": fa.LAUNCHES, "ssd": ss.LAUNCHES}
    try:        # the case's make_mesh starts a one-rank NCCL group
        R.run_cases(0, 1, [("serve", dict(spec, device="cuda"),
                            str(tmp_path / "gpu"))])
        assert dist.get_backend() == "nccl"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    launched = {"flash": fa.LAUNCHES - launched["flash"],
                "ssd": ss.LAUNCHES - launched["ssd"]}
    got = dict(np.load(tmp_path / "gpu.rank0.npz"))
    seen = json.loads((tmp_path / "gpu.rank0.json").read_text())
    for k in ["prefill"] + [f"logits{i}" for i in range(4)]:
        assert _rel(torch.from_numpy(got[k]), torch.from_numpy(want[k])) \
            <= 1e-3, k
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["greedy"], want["tokens"])
    assert launched["flash"] > 0 and launched["ssd"] > 0
    assert seen["calls"]["decode"]["decode_max"] > 0
    assert seen["calls"]["prefill"]["norm_sum"] == cfg.n_layers


def _durable_workload(seed):
    w = generate("SCI", n_versions=60, inserts=80, n_branches=6,
                 n_attrs=20, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    return w, tree


def _commits(w, tree, lo, hi, cur):
    out = []
    for v in range(lo, hi):
        rl = w.graph.rlist(v)
        out.append({"parent": int(tree.parent[v]), "rlist": rl,
                    "new_rows": w.data[rl[rl >= cur]]})
        cur += int((rl >= cur).sum())
    return out, cur


def _base_store(w, n0, device):
    ip = w.graph.indptr[:n0 + 1]
    pool = int(w.graph.indices[:ip[-1]].max()) + 1
    store = store_from_arrays(ip, w.graph.indices[:ip[-1]], pool,
                              w.data[:pool], np.arange(n0) % 4,
                              device=device)
    return store, pool


def test_cuda_journaled_commit_kill_restore(cuda_device, tmp_path):
    """A journaled commit wave on a card store (one commit.batch record,
    one fsync, one segment_append launch), a kill, and
    ``restore(device="cuda")``: the wave replays, the restored store
    equals the live one, and its first ``checkout_wave`` re-pins the
    superblock on the card and is bit-identical to numpy."""
    w, tree = _durable_workload(5)
    n0 = 50
    store, pool = _base_store(w, n0, cuda_device)
    dur = StoreDurability(str(tmp_path / "d"))
    dur.snapshot(store)
    ck.get_superblock(store)[0].device()
    commits, _ = _commits(w, tree, n0, 60, pool)
    synced, appends = dur.journal.synced, sa.LAUNCHES
    assert store.commit_many(commits) == list(range(n0, 60))
    assert dur.journal.synced == synced + 1
    assert sa.LAUNCHES == appends + 1
    live = (store.epoch, store.graph.indptr, store.graph.indices,
            store.assignment, store.data)
    del store, dur                               # the kill
    rs = StoreDurability(str(tmp_path / "d")).restore(device="cuda")
    assert rs.replayed == 1 and rs.store.device.type == "cuda"
    assert (rs.store.epoch, *(a.tobytes() for a in live[1:])) == \
        (live[0], *(np.asarray(a).tobytes() for a in (
            rs.store.graph.indptr, rs.store.graph.indices,
            rs.store.assignment, rs.store.data)))
    assert peek_superblock(rs.store) is None     # nothing pinned yet
    vids = [0, 17, 49, 50, 59, 59]
    before = cb.LAUNCHES
    res = checkout_wave(rs.store, vids, device_out=True)
    assert res.parts[0].packed.is_cuda
    for m, v in zip(res.materialize(), vids):
        np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    assert cb.LAUNCHES == before + 1
    assert peek_superblock(rs.store)._device.is_cuda


def test_cuda_threaded_tenants_match_inline(cuda_device):
    """Four tenants on worker threads launch concurrently over one card
    store; every ticket equals the ``threads=False`` run's, bit for bit,
    and numpy's."""
    w, tree = _durable_workload(6)
    ids = ("a", "b", "c", "d")
    rng = np.random.default_rng(6)
    vids = {t: rng.choice(w.n_versions, 48).tolist() for t in ids}
    runs = {}
    for threads in (False, True):
        store, _ = _store(cuda_device, seed=6)
        mts = MultiTenantServer(
            store, threads=threads,
            quotas={t: TenantQuota(max_wave=8) for t in ids})
        before = cb.LAUNCHES
        tks = {t: mts.submit_many(t, vids[t]) for t in ids}
        runs[threads] = {t: [np.array(m) for m in
                             mts.results(t, tks[t], timeout=120)]
                         for t in ids}
        mts.close()
        assert cb.LAUNCHES - before >= 24
        for t in ids:
            assert mts.stats(t).delivered == 48
            assert mts.stats(t).failed == 0
        assert int(store._inflight_waves) == 0
    for t in ids:
        for a, b, v in zip(runs[True][t], runs[False][t], vids[t]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, w.data[w.graph.rlist(v)])


def test_cuda_kernel_error_after_restore_reaches_caller(cuda_device,
                                                        tmp_path,
                                                        monkeypatch):
    """A ``checkout_wave`` that fails to launch on a restored card store
    raises ``KernelError`` to the caller — through a restored server with
    a ``RetryPolicy`` and through a tenant's ticket — and is never served
    by the CPU's host gather instead."""
    store, w = _store(cuda_device, seed=7)
    StoreDurability(str(tmp_path / "d")).snapshot(store)
    rs = StoreDurability(str(tmp_path / "d")).restore(device="cuda")
    srv = rs.make_server(retry=RetryPolicy(attempts=2, sleep=lambda s: None))
    mts = MultiTenantServer(rs.store, threads=False,
                            retry=RetryPolicy(sleep=lambda s: None),
                            quotas={"t": TenantQuota(max_wave=4)})
    vids = [0, 7, 31, 59]
    kernel_fn = build.kernel_fn
    with monkeypatch.context() as m:
        m.setattr(build, "kernel_fn", lambda name: (
            (lambda *args: 700) if name == "checkout_wave"
            else kernel_fn(name)))
        srv.submit_many(vids)
        with pytest.raises(build.KernelError, match="cudaError 700"):
            srv.flush()
        tks = mts.submit_many("t", vids)
        for tk in tks:
            with pytest.raises(build.KernelError, match="cudaError 700"):
                mts.result("t", tk)
    assert srv.stats.degraded_waves == 0 and srv.stats.waves == 0
    assert mts.stats("t").failed == 4 and mts.stats("t").delivered == 0
    srv.close(deliver=False)
    mts.close()
    assert int(rs.store._inflight_waves) == 0


def test_cuda_paged_kv_cache_equals_the_cpu_run(cuda_device):
    """The paged cache on the card: appends (copy-on-write of forked tails
    included), forks, releases and page reuse give the CPU run's state
    leaf for leaf, and every gather the CPU's."""
    from repro_torch.serve import kvcache as kv
    cfg = kv.PagedConfig(n_layers=2, n_kv=2, head_dim=64, page=16,
                         n_pages=24, max_pages_per_seq=8)
    gen = torch.Generator().manual_seed(8)
    toks = torch.randn((200, 2, 2, 2, 64), generator=gen)
    states = {}
    for dev in (cuda_device, torch.device("cpu")):
        st = kv.init_pool(cfg, 6, device=dev)
        n = 0

        def put(req):
            nonlocal n
            kv.append(cfg, st, (toks[n, 0].to(dev), toks[n, 1].to(dev)), req)
            n += 1
        for req, count in ((0, 37), (1, 16), (2, 5)):
            for _ in range(count):
                put(req)
        for dst in (3, 4):
            kv.fork(cfg, st, 0, dst)
        for req in (3, 4, 0, 3):
            put(req)
        kv.release(cfg, st, 1)
        kv.release(cfg, st, 2)
        for _ in range(20):
            put(5)
        states[dev.type] = st
    card, cpu = states["cuda"], states["cpu"]
    for name in card:
        assert torch.equal(card[name].cpu(), cpu[name]), name
    assert kv.pool_stats(card) == kv.pool_stats(cpu)
    for req in range(6):
        for layer in range(cfg.n_layers):
            for a, b in zip(kv.gather_kv(cfg, card, req, layer),
                            kv.gather_kv(cfg, cpu, req, layer)):
                assert torch.equal(a.cpu(), b)
