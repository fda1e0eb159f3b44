"""The port on the card: the CUDA ``checkout_wave``, ``segment_append``,
``segment_move``, ``gather_rows``, ``gather_row_tiles``, ``membership_scan``,
``version_aggregate``, ``flash_attention`` and ``ssd_scan`` against their
plain torch versions, and the wave engine, the server, the online write
path (commit waves, a migration), the durable path (a journaled commit
wave, a kill and ``restore(device="cuda")``), four threaded tenants, a
``VersionedDataset``, the bitmap analytics on a CUDA store against numpy,
and a ``SMOKE``-size model forward through both model kernels.  This file imports neither jax nor the JAX package, so it runs on
a machine with a GPU and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs the card and skips without one."""
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
from repro_torch.serve import (BatchedCheckoutServer, MultiTenantServer,
                               RetryPolicy, TenantQuota)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import aggregate_cases, membership_cases  # noqa: E402

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


# flash cases: (B, Sq, Sk, H, Hkv, Dh, causal) — GQA groups 1, 2, 4 and
# MQA; Dh 16, 32, 48, 64, 80, 112, 128 and 256; S from 16 to 4096 + 77, and
# lengths off the wgmma instance's 128-row tiles, the mma.sync instance's 64
# and the TPU kernel's 128 (200, 77, 4173, Sk 192, 328, 136); Sq != Sk
# without the mask
FLASH_CASES = [(2, 256, 256, 4, 4, 64, True), (1, 512, 512, 4, 2, 128, True),
               (2, 128, 128, 8, 2, 80, False),
               (1, 1024, 1024, 4, 1, 80, True),
               (1, 384, 384, 2, 2, 256, True), (2, 16, 16, 4, 4, 16, True),
               (1, 256, 256, 6, 3, 80, False), (1, 200, 200, 4, 2, 64, True),
               (2, 77, 77, 2, 1, 80, True), (1, 128, 192, 4, 4, 32, False),
               (1, 200, 328, 2, 2, 128, False),
               (1, 4173, 4173, 2, 1, 80, True), (1, 200, 200, 8, 2, 80, True),
               (2, 300, 136, 4, 2, 64, False), (1, 333, 333, 4, 4, 48, True),
               (1, 256, 256, 2, 2, 112, True), (1, 130, 130, 4, 4, 72, True)]
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
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    b, sq, sk, h, hkv, dh, causal = case
    q = _randn((b, sq, h, dh), 1, dtype, cuda_device)
    k = _randn((b, sk, hkv, dh), 2, dtype, cuda_device)
    v = _randn((b, sk, hkv, dh), 3, dtype, cuda_device)
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
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
    fn = build.flash_fn()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = q.data_ptr()
    assert fn(ptr, ptr, ptr, ptr, 1, 128, 128, 3, 2, 64, 1, 0, stream) != 0
    # bf16 at Dh 64 runs the wgmma instance, whose tensor map refuses a q
    # that starts off a 16-byte boundary
    assert fn(ptr + 2, ptr, ptr, ptr, 1, 128, 128, 2, 2, 64, 1, 1, stream) != 0
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
