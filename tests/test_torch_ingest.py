"""The port's write path held against the JAX package's: the plain segment
kernels against the Pallas kernels in interpret mode, and ``commit_many`` /
``commit_version`` with in-place superblock extension bit for bit against
the reference store — rlist form, table form, same-wave parent chains, a
failing wave that stages nothing, budget-limited group superblocks, and a
single-fault sweep over the ingest sites.  Exact everywhere: every value is
an integer copy."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core.checkout as rck
import repro.core.faults as rfaults
import repro.kernels.ops as rops
from repro.core import generate
from repro.core.graph import BipartiteGraph as RefGraph
from repro.core.partition import PartitionedCVD as RefStore
from repro_torch.core import checkout as ck
from repro_torch.core import partition as part
from repro_torch.core.faults import FaultPlan, InjectedFault
from repro_torch.core.partition import store_from_arrays
from repro_torch.core.version_graph import to_tree
from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelError, PlanError
from repro_torch.kernels import segment_append as sa
from repro_torch.kernels import segment_move as sm


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """Drop the reference's Pallas traces when this module ends, so that a
    later test file in the same process that counts fresh traces of the
    same kernels starts cold."""
    yield
    jax.clear_caches()


# ------------------------------------------------ plain kernels vs Pallas --
SEGMENT_PLANS = {
    # sel mix with runs ending at the last BN rows of src (32) and delta
    # (16), unaligned starts, and zero tiles
    "segment_append": ([0, 1, 2, 0, 1, 2, 0, 1], [0, 8, 0, 32, 16, 5, 3, 1]),
    "segment_move": ([0, 1, 0, 1, 0, 1, 1, 0], [32, 16, 0, 3, 5, 0, 9, 17]),
}


@pytest.mark.parametrize("d", [128, 256, 512])
@pytest.mark.parametrize("dtype", ["int32", "float32", "int16"])
@pytest.mark.parametrize("kernel", ["segment_append", "segment_move"])
def test_plain_segment_kernel_matches_pallas_interpret(kernel, dtype, d):
    rng = np.random.default_rng(d)
    src = rng.integers(-1000, 1000, (40, d)).astype(dtype)
    delta = rng.integers(-1000, 1000, (24, d)).astype(dtype)
    sel, starts = (np.array(a, np.int32) for a in SEGMENT_PLANS[kernel])
    got = getattr(ops, kernel)(torch.from_numpy(src), delta, sel, starts)
    want = getattr(rops, kernel)(jnp.asarray(src), jnp.asarray(delta),
                                 sel, starts, interpret=True)
    assert got.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel,sel,starts", [
    ("segment_append", [0, 0], [0, 33]),       # src run past its 40 rows
    ("segment_append", [1, 0], [17, 0]),       # delta run past its 24 rows
    ("segment_append", [0, 3], [0, 0]),        # no such source
    ("segment_append", [0, 1], [-1, 0]),       # negative start
    ("segment_move", [1, 0], [17, 0]),
    ("segment_move", [0, 2], [33, 16]),        # nonzero sel reads delta
])
def test_out_of_bounds_plan_raises(kernel, sel, starts):
    src = torch.zeros((40, 128), dtype=torch.int32)
    delta = torch.zeros((24, 128), dtype=torch.int32)
    wrapper = {"segment_append": sa.segment_append,
               "segment_move": sm.segment_move}[kernel]
    with pytest.raises(ValueError, match="tile"):
        wrapper(src, delta, np.array(sel), np.array(starts))


def test_segment_wrappers_refuse_mismatched_sources():
    with pytest.raises(ValueError, match="one width"):
        sa.segment_append(torch.zeros((16, 128)), torch.zeros((8, 256)),
                          [0], [0])
    with pytest.raises(ValueError, match="differ"):
        sm.segment_move(torch.zeros((16, 128)),
                        torch.zeros((8, 128), dtype=torch.int32), [0], [0])
    with pytest.raises(ValueError, match="lane tile"):
        ops.segment_append(torch.zeros((16, 640)), None, [0], [0])


def test_no_delta_uses_a_device_zero_tile():
    src = torch.arange(16 * 128, dtype=torch.int32).reshape(16, 128)
    out = ops.segment_append(src, None, [2, 0, 1], [0, 8, 0])
    assert torch.equal(out[8:16], src[8:16])
    assert not out[:8].any() and not out[16:].any()


# ------------------------------------------------------- store helpers --
def _workload(seed=0, n_versions=40):
    w = generate("SCI", n_versions=n_versions, inserts=20, n_branches=5,
                 n_attrs=12, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    return w, tree


def _pool(w, v):
    """Records owned by versions [0, v) (rids are allocated densely in
    version order)."""
    ind = w.graph.indices[:w.graph.indptr[v]]
    return int(ind.max()) + 1 if len(ind) else 0


def _stores(w, n0, assignment, *, device_copy=True, budget=None):
    """The same first-n0-versions store on both sides, superblock cached
    (and on the device) on both."""
    ip = w.graph.indptr[:n0 + 1]
    ind = w.graph.indices[:ip[-1]]
    pool = _pool(w, n0)
    port = store_from_arrays(ip, ind, pool, w.data[:pool], assignment,
                             device="cpu")
    ref = RefStore(RefGraph(indptr=ip.copy(), indices=ind.copy(),
                            n_records=pool),
                   w.data[:pool].copy(), np.array(assignment))
    if budget is not None:
        port.superblock_max_bytes = ref.superblock_max_bytes = \
            ck.estimate_superblock_bytes(port) // budget
        ck.get_superblock_groups(port, budget=port.superblock_max_bytes,
                                 create=True).warm(device=device_copy)
        rck.get_superblock_groups(ref, budget=ref.superblock_max_bytes,
                                  create=True).warm(device=device_copy)
    else:
        sb, _ = ck.get_superblock(port)
        rsb, _ = rck.get_superblock(ref)
        if device_copy:
            sb.device()
            rsb.device()
    return port, ref


def _commits(w, tree, lo, hi):
    """Versions [lo, hi) of the workload as rlist-form commits."""
    cur = _pool(w, lo)
    out = []
    for v in range(lo, hi):
        rl = w.graph.rlist(v)
        fresh = rl[rl >= cur]
        out.append({"parent": int(tree.parent[v]), "rlist": rl,
                    "new_rows": w.data[fresh]})
        cur += len(fresh)
    return out


def _same_superblock(sb, rsb):
    np.testing.assert_array_equal(sb.host, np.asarray(rsb.host))
    for f in ("row_offsets", "bounds"):
        np.testing.assert_array_equal(getattr(sb, f), getattr(rsb, f))
    assert (sb.epoch, sb.d, sb.bd, sb.block_n) == \
        (rsb.epoch, rsb.d, rsb.bd, rsb.block_n)
    assert (sb._device is None) == (rsb._device is None)
    if sb._device is not None:
        np.testing.assert_array_equal(sb._device.numpy(),
                                      np.asarray(rsb._device))
    assert sb.uploads == rsb.uploads


def same_state(port, ref):
    """Every field of the two stores, superblocks included."""
    for f in ("indptr", "indices", "n_records"):
        np.testing.assert_array_equal(getattr(port.graph, f),
                                      getattr(ref.graph, f))
    np.testing.assert_array_equal(port.data, ref.data)
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    np.testing.assert_array_equal(port.vid_to_pid, ref.vid_to_pid)
    assert port.epoch == ref.epoch
    assert len(port.partitions) == len(ref.partitions)
    for p, q in zip(port.partitions, ref.partitions):
        assert p.pid == q.pid and p.vid_to_slot == q.vid_to_slot
        for f in ("vids", "grids", "block", "indptr", "indices"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    assert getattr(port, "_commit_log", None) == \
        getattr(ref, "_commit_log", None)
    cache = getattr(port, "_superblock_cache", None) or {}
    rcache = getattr(ref, "_superblock_cache", None) or {}
    assert list(cache) == list(rcache)
    for k in cache:
        _same_superblock(cache[k], rcache[k])
    mgr = ck.get_superblock_groups(port)
    rmgr = rck.get_superblock_groups(ref)
    assert (mgr is None) == (rmgr is None)
    if mgr is not None:
        assert list(mgr.groups) == list(rmgr.groups)
        assert (mgr.pinned_bytes, mgr.pins, mgr.evictions) == \
            (rmgr.pinned_bytes, rmgr.pins, rmgr.evictions)
        for k in mgr.groups:
            _same_superblock(mgr.groups[k], rmgr.groups[k])


def _assignment(n, k, seed=0):
    return np.random.default_rng(seed).permutation(np.arange(n) % k)


# ------------------------------------------------------------ commit_many --
@pytest.mark.parametrize("wave", [1, 4, 8])
def test_commit_many_rlist_form_matches_reference(wave):
    """Waves of ``wave`` commits; waves of 4 and 8 carry parents committed
    earlier in the same wave."""
    w, tree = _workload(1)
    n0 = 28
    port, ref = _stores(w, n0, _assignment(n0, 4))
    for lo in range(n0, w.n_versions, wave):
        commits = _commits(w, tree, lo, min(lo + wave, w.n_versions))
        assert port.commit_many(commits) == ref.commit_many(commits) \
            == list(range(lo, lo + len(commits)))
        same_state(port, ref)
    for v in range(w.n_versions):
        np.testing.assert_array_equal(port.checkout(v),
                                      w.data[w.graph.rlist(v)])
    assert port.epoch == -(-(w.n_versions - n0) // wave)    # one a wave


def test_commit_many_table_form_and_chains_match_reference():
    """Table-form commits diff against their parent's rows (a same-wave
    parent included), mixed with rlist-form ones and a parentless commit
    that opens a new partition."""
    w, tree = _workload(2)
    n0 = 30
    port, ref = _stores(w, n0, _assignment(n0, 3, 2))
    rng = np.random.default_rng(2)
    old_rids = w.graph.rlist(n0)[w.graph.rlist(n0) < _pool(w, n0)]
    base = w.data[w.graph.rlist(5)]
    edited = base.copy()
    edited[::7] += 1                       # changed rows become fresh rows
    commits = [
        {"parent": 5, "table": edited},
        {"parent": n0, "table": np.concatenate(
            [edited[3:], rng.integers(0, 9, (4, 12)).astype(np.int32)])},
        {"parent": 7, "rlist": old_rids},
        {"rlist": [0, 1, 2]},              # parentless: a new partition
        {"parent": n0 + 3, "rlist": [1, 2]},
    ]
    vids = port.commit_many(commits)
    assert vids == ref.commit_many(commits)
    same_state(port, ref)
    assert len(port.partitions) == 4
    for v, c in zip(vids[:2], commits[:2]):
        np.testing.assert_array_equal(
            np.unique(port.checkout(v), axis=0), np.unique(c["table"], axis=0))


def test_commit_version_matches_reference():
    w, tree = _workload(3)
    n0 = 32
    port, ref = _stores(w, n0, _assignment(n0, 4, 3))
    for c in _commits(w, tree, n0, n0 + 4):
        assert port.commit_version(c["rlist"], parent=c["parent"],
                                   new_rows=c["new_rows"]) == \
            ref.commit_version(c["rlist"], parent=c["parent"],
                               new_rows=c["new_rows"])
        same_state(port, ref)
    for kwargs in ({"rlist": [3, 4]}, {"rlist": [0, 9], "parent": 2,
                                       "pid": 99}):
        assert port.commit_version(**kwargs) == ref.commit_version(**kwargs)
        same_state(port, ref)


@pytest.mark.parametrize("bad", [
    {"parent": 999, "rlist": [0]},                  # parent out of range
    {"parent": 0, "rlist": [10 ** 6]},              # rid past the pool
    {"parent": 0, "rlist": [0], "new_rows": np.zeros((2, 5), np.int32)},
    {"table": np.zeros((2, 12), np.int32)},         # table without parent
])
def test_bad_commit_stages_nothing(bad):
    w, tree = _workload(4)
    n0 = 30
    port, ref = _stores(w, n0, _assignment(n0, 3, 4))
    wave = _commits(w, tree, n0, n0 + 2) + [bad]
    for store in (port, ref):
        with pytest.raises(ValueError):
            store.commit_many(wave)
    same_state(port, ref)
    assert port.epoch == 0 and port.graph.n_versions == n0
    assert port.commit_many(wave[:2]) == ref.commit_many(wave[:2])
    same_state(port, ref)


# ------------------------------------------- refresh on a budget store --
def _captured_refresh(monkeypatch):
    """Record every refresh report on both sides (commit_many discards
    it)."""
    reports = {"port": [], "ref": []}

    def wrap(fn, side):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            reports[side].append(out)
            return out
        return run

    monkeypatch.setattr(part, "refresh_superblocks_after_commit",
                        wrap(ck.refresh_superblocks_after_commit, "port"))
    monkeypatch.setattr(rck, "refresh_superblocks_after_commit",
                        wrap(rck.refresh_superblocks_after_commit, "ref"))
    return reports


def test_refresh_reports_match_reference_on_a_budget_store(monkeypatch):
    """Group superblocks under a third of the whole-store budget: a commit
    wave extends the touched pinned groups in place, cold pinned groups
    stay pinned (revalidated), and the reports agree."""
    reports = _captured_refresh(monkeypatch)
    w, tree = _workload(5, n_versions=44)
    n0 = 34
    port, ref = _stores(w, n0, _assignment(n0, 6, 5), budget=3)
    pinned0 = list(ck.get_superblock_groups(port).groups)
    assert len(pinned0) >= 2
    for lo in range(n0, w.n_versions, 5):
        commits = _commits(w, tree, lo, min(lo + 5, w.n_versions))
        port.commit_many(commits)
        ref.commit_many(commits)
        same_state(port, ref)
    assert reports["port"] == reports["ref"] and len(reports["port"]) == 2
    assert sum(r["revalidated"] for r in reports["port"]) > 0
    assert sum(r["extended"] for r in reports["port"]) > 0
    mgr = ck.get_superblock_groups(port)
    assert mgr.pins - mgr.evictions == len(mgr.groups)
    assert all(sb.epoch == port.epoch for sb in mgr.groups.values())
    for v in range(w.n_versions):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v])[0],
                                      w.data[w.graph.rlist(v)])


def test_refresh_without_extension_evicts_like_the_reference(monkeypatch):
    reports = _captured_refresh(monkeypatch)
    w, tree = _workload(6)
    n0 = 30
    port, ref = _stores(w, n0, _assignment(n0, 3, 6))
    commits = _commits(w, tree, n0, n0 + 3)
    port.commit_many(commits, extend_superblocks=False)
    ref.commit_many(commits, extend_superblocks=False)
    same_state(port, ref)
    assert reports["port"] == reports["ref"]
    assert reports["port"][0]["evicted"] == 1
    assert port._superblock_evictions == ref._superblock_evictions == 1


def test_host_tier_superblock_extends_on_the_host():
    """No device copy: the extension stays host-side on both sides."""
    w, tree = _workload(7)
    n0 = 30
    port, ref = _stores(w, n0, _assignment(n0, 3, 7), device_copy=False)
    commits = _commits(w, tree, n0, n0 + 4)
    port.commit_many(commits)
    ref.commit_many(commits)
    same_state(port, ref)
    assert ck.peek_superblock(port)._device is None


def test_extend_stats_match_reference():
    w, tree = _workload(8)
    n0 = 30
    port, ref = _stores(w, n0, _assignment(n0, 3, 8))
    old = ck.peek_superblock(port)
    rold = rck.peek_superblock(ref)
    grids = {s: p.grids for s, p in enumerate(port.partitions)}
    commits = _commits(w, tree, n0, n0 + 3)
    port.commit_many(commits, extend_superblocks=False)
    ref.commit_many(commits, extend_superblocks=False)
    _, st = ck.extend_superblock_after_commit(port, old, grids)
    _, rst = rck.extend_superblock_after_commit(ref, rold, grids)
    fields = ("n_tiles", "reused_tiles", "delta_tiles", "bytes_uploaded",
              "bytes_total", "used_device")
    assert [getattr(st, f) for f in fields] == \
        [getattr(rst, f) for f in fields]
    assert st.reused_tiles > 0 and st.delta_tiles > 0


# ------------------------------------------------- single-fault sweep --
@pytest.mark.parametrize("site", ["ingest.extract", "ingest.commit",
                                  "ingest.append"])
def test_single_ingest_fault_leaves_the_store_bit_identical(site):
    """extract/commit fire before any mutation: the wave raises, the store
    is untouched, a retry lands it.  append fires inside the superblock
    extension: the commit lands and the superblock alone is evicted (it
    rebuilds on the next wave).  The reference does the same under the same
    fault."""
    w, tree = _workload(9)
    n0 = 30
    port, ref = _stores(w, n0, _assignment(n0, 3, 9))
    commits = _commits(w, tree, n0, n0 + 4)
    for store, plan in ((port, FaultPlan.single(site)),
                        (ref, rfaults.FaultPlan.single(site))):
        with plan.armed():
            if site == "ingest.append":
                store.commit_many(commits)
            else:
                with pytest.raises((InjectedFault, rfaults.InjectedFault)):
                    store.commit_many(commits)
        assert [r.site for r in plan.fired] == [site]
    same_state(port, ref)
    if site == "ingest.append":
        assert ck.peek_superblock(port) is None
        assert port._superblock_evictions == 1
    else:
        assert port.epoch == 0 and ck.peek_superblock(port) is not None
        assert port.commit_many(commits) == ref.commit_many(commits)
        same_state(port, ref)
    for v in range(n0 + 4):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v, 0])[0],
                                      w.data[w.graph.rlist(v)])


# ------------------------------------- kernel faults are never absorbed --
def _kernel_fault(monkeypatch, fault):
    """Make the CPU wrapper fail as the card's would: a launch error from
    the kernel, or a plan the wrapper refuses."""
    def launch(*args, **kwargs):
        raise KernelError("segment_append launch failed: cudaError 700")

    def plan(*args, **kwargs):
        raise PlanError("tile 0: run [0, 8) lies outside src (0 rows)")

    if fault == "launch":
        monkeypatch.setattr(sa, "segment_append_plain", launch)
    else:
        monkeypatch.setattr(sa, "check_plan", plan)


@pytest.mark.parametrize("fault", ["launch", "plan"])
@pytest.mark.parametrize("budget", [None, 3])
def test_kernel_fault_in_a_commit_wave_propagates(monkeypatch, budget,
                                                  fault):
    """A failed ``segment_append`` is not absorbed into eviction and a lazy
    rebuild from the host (the reference's guard for its own faults): the
    commit lands, the superblock it failed on is released, and
    ``commit_many`` raises the KernelError with the landed vids.  Reads
    stay right once the kernel works again."""
    # the budget store's first wave extends pinned group (0,) (as in
    # test_refresh_reports_match_reference_on_a_budget_store)
    w, tree = _workload(5, n_versions=44)
    n0 = 34
    port, _ = _stores(w, n0, _assignment(n0, 6, 5), budget=budget)
    commits = _commits(w, tree, n0, n0 + 4)
    with monkeypatch.context() as m:
        _kernel_fault(m, fault)
        with pytest.raises(KernelError) as err:
            port.commit_many(commits)
    assert err.value.committed_vids == list(range(n0, n0 + 4))
    assert isinstance(err.value, ValueError) == (fault == "plan")
    assert port.graph.n_versions == n0 + 4 and port.epoch == 1
    if budget is None:
        assert ck.peek_superblock(port) is None
    else:
        mgr = ck.get_superblock_groups(port)
        assert list(mgr.groups) == [(1,)]       # (0,) failed and was freed
        assert mgr.pins - mgr.evictions == len(mgr.groups)
    c = _commits(w, tree, n0 + 4, n0 + 5)[0]
    with monkeypatch.context() as m:
        _kernel_fault(m, fault)
        ck.get_superblock(port)[0].device()  # rebuild, then fail again
        with pytest.raises(KernelError) as err:
            port.commit_version(c["rlist"], parent=c["parent"],
                                new_rows=c["new_rows"])
    assert err.value.committed_vids == [n0 + 4]
    for v in range(n0 + 5):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v, 0])[0],
                                      w.data[w.graph.rlist(v)])
