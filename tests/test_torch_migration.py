"""The port's online migration held against the JAX package's:
``plan_migration``, ``apply_migration``, ``migrate_superblock`` (through the
plain ``segment_move``) and ``migrate_groups`` bit for bit on the same
stores, the ``RepartitionTrigger`` firing at the same wave with the same
report, a single-fault sweep over the migration sites, and the pure-numpy
online partitioner (paper Fig 14) trace for trace.  Exact everywhere: every
value is an integer copy or a cost computed the same way in numpy."""
import dataclasses

import numpy as np
import pytest

import jax
import repro.core.checkout as rck
import repro.core.faults as rfaults
import repro.core.online as ronline
import repro.core.partition as rpart
from repro.core import generate
from repro.core.graph import BipartiteGraph as RefGraph
from repro.core.version_graph import to_tree as ref_to_tree
from repro_torch.core import checkout as ck
from repro_torch.core import online
from repro_torch.core.faults import FaultPlan, InjectedFault
from repro_torch.core.lyresplit import lyresplit_for_budget
from repro_torch.core.partition import plan_migration, store_from_arrays
from repro_torch.core.version_graph import WeightedTree, to_tree
from repro_torch.kernels import segment_move as sm
from repro_torch.kernels.build import KernelError


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """Drop the reference's Pallas traces when this module ends, so that a
    later test file in the same process that counts fresh traces of the
    same kernels starts cold."""
    yield
    jax.clear_caches()


def _workload(seed=0, n_versions=36):
    w = generate("SCI", n_versions=n_versions, inserts=20, n_branches=5,
                 n_attrs=12, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    return w, tree


def _stores(w, assignment, *, budget=None, device_copy=True):
    port = store_from_arrays(w.graph.indptr, w.graph.indices,
                             w.graph.n_records, w.data, assignment,
                             device="cpu")
    ref = rpart.PartitionedCVD(
        RefGraph(indptr=w.graph.indptr.copy(),
                 indices=w.graph.indices.copy(),
                 n_records=w.graph.n_records),
        w.data.copy(), np.array(assignment))
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


def _targets(w, tree, seed):
    """Two target partitionings: LyreSplit's at a 2|R| budget, and a
    random relabelling into 5 partitions."""
    lyre = lyresplit_for_budget(tree, 2 * w.n_records).best.assignment
    rnd = np.random.default_rng(seed).integers(0, 5, w.n_versions)
    return {"lyresplit": lyre, "random": rnd}


def _same_superblock(sb, rsb):
    np.testing.assert_array_equal(sb.host, np.asarray(rsb.host))
    for f in ("row_offsets", "bounds"):
        np.testing.assert_array_equal(getattr(sb, f), getattr(rsb, f))
    assert (sb.epoch, sb.uploads) == (rsb.epoch, rsb.uploads)
    assert (sb._device is None) == (rsb._device is None)
    if sb._device is not None:
        np.testing.assert_array_equal(sb._device.numpy(),
                                      np.asarray(rsb._device))


def _same_state(port, ref):
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    np.testing.assert_array_equal(port.vid_to_pid, ref.vid_to_pid)
    assert port.epoch == ref.epoch
    assert len(port.partitions) == len(ref.partitions)
    for p, q in zip(port.partitions, ref.partitions):
        assert p.pid == q.pid and p.vid_to_slot == q.vid_to_slot
        for f in ("vids", "grids", "block", "indptr", "indices"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    cache = getattr(port, "_superblock_cache", None) or {}
    rcache = getattr(ref, "_superblock_cache", None) or {}
    assert list(cache) == list(rcache)
    for k in cache:
        _same_superblock(cache[k], rcache[k])
    mgr, rmgr = ck.get_superblock_groups(port), rck.get_superblock_groups(ref)
    assert (mgr is None) == (rmgr is None)
    if mgr is not None:
        assert list(mgr.groups) == list(rmgr.groups)
        assert (mgr.pinned_bytes, mgr.pins, mgr.evictions) == \
            (rmgr.pinned_bytes, rmgr.pins, rmgr.evictions)
        for k in mgr.groups:
            _same_superblock(mgr.groups[k], rmgr.groups[k])


def _stats(st):
    return {k: v for k, v in dataclasses.asdict(st).items() if k != "wall_s"}


def _report(r):
    out = {k: v for k, v in dataclasses.asdict(r).items()
           if k not in ("wall_s", "superblock")}
    out["superblock"] = None if r.superblock is None else _stats(r.superblock)
    return out


# -------------------------------------------------------- plan + apply --
@pytest.mark.parametrize("target", ["lyresplit", "random"])
def test_plan_migration_matches_reference(target):
    w, tree = _workload(1)
    port, ref = _stores(w, np.arange(w.n_versions) % 4, device_copy=False)
    assignment = _targets(w, tree, 1)[target]
    plan = plan_migration(port, assignment)
    rplan = rpart.plan_migration(ref, assignment)
    for f in ("assignment", "new_labels", "matched_old"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(rplan, f))
    for f in ("new_vids", "new_grids", "src_pid_rows", "src_loc_rows"):
        for a, b in zip(getattr(plan, f), getattr(rplan, f), strict=True):
            np.testing.assert_array_equal(a, b)
    assert [[dataclasses.astuple(op) for op in ops] for ops in plan.ops] == \
        [[dataclasses.astuple(op) for op in ops] for ops in rplan.ops]
    for f in ("cost_intelligent", "cost_naive", "rows_moved", "rows_loaded",
              "n_partitions"):
        assert getattr(plan, f) == getattr(rplan, f)
    assert plan.rows_moved > 0
    with pytest.raises(ValueError):
        plan_migration(port, assignment[:-1])


@pytest.mark.parametrize("device_copy", [True, False])
@pytest.mark.parametrize("target", ["lyresplit", "random"])
def test_apply_and_migrate_superblock_match_reference(target, device_copy):
    """The incremental path end to end: take the superblock, morph the
    partitions, migrate the superblock through ``segment_move`` (plain on
    the CPU) — or on the host when no device copy exists."""
    w, tree = _workload(2)
    port, ref = _stores(w, np.arange(w.n_versions) % 3,
                        device_copy=device_copy)
    assignment = _targets(w, tree, 2)[target]
    plan = plan_migration(port, assignment)
    rplan = rpart.plan_migration(ref, assignment)
    old, rold = ck.take_superblock(port), rck.take_superblock(ref)
    port.apply_migration(plan)
    ref.apply_migration(rplan)
    new, st = ck.migrate_superblock(port, old, plan)
    rnew, rst = rck.migrate_superblock(ref, rold, rplan)
    assert _stats(st) == _stats(rst)
    assert st.used_device == device_copy and st.reused_tiles > 0
    _same_superblock(new, rnew)
    _same_state(port, ref)
    for v in range(w.n_versions):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v, 0])[0],
                                      w.data[w.graph.rlist(v)])


def test_migrate_superblock_refuses_a_tiling_change():
    w, tree = _workload(3)
    port, _ = _stores(w, np.arange(w.n_versions) % 3)
    old = ck.take_superblock(port)
    old = dataclasses.replace(old, d=old.d + 1)    # a wider old layout
    plan = plan_migration(port, _targets(w, tree, 3)["random"])
    port.apply_migration(plan)
    with pytest.raises(ValueError, match="tiling"):
        ck.migrate_superblock(port, old, plan)


def test_migrate_groups_matches_reference():
    """Pinned group superblocks under a third of the whole-store budget are
    detached before the morph and migrated (or evicted) per group."""
    w, tree = _workload(4, n_versions=40)
    port, ref = _stores(w, np.arange(w.n_versions) % 6, budget=3)
    assert len(ck.get_superblock_groups(port).groups) >= 2
    assignment = _targets(w, tree, 4)["lyresplit"]
    port.apply_migration(plan_migration(port, assignment))
    ref.apply_migration(rpart.plan_migration(ref, assignment))
    _same_state(port, ref)
    mgr = ck.get_superblock_groups(port)
    assert mgr.groups and mgr.pins - mgr.evictions == len(mgr.groups)
    for v in range(w.n_versions):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v])[0],
                                      w.data[w.graph.rlist(v)])


def test_migrate_groups_without_a_manager_releases_the_copies():
    w, tree = _workload(5)
    port, _ = _stores(w, np.arange(w.n_versions) % 3)
    sb = ck.take_superblock(port)
    plan = plan_migration(port, _targets(w, tree, 5)["random"])
    assert ck.migrate_groups(port, plan, [sb]) == 0
    assert sb._device is None


@pytest.mark.parametrize("path", ["trigger", "groups"])
def test_kernel_fault_in_a_migration_propagates(monkeypatch, path):
    """A failed ``segment_move`` is not absorbed into eviction and a lazy
    rebuild from the host: the migration lands, the old device copies are
    released, and the KernelError reaches the caller — through the
    trigger's guard (whole-store superblock) and through ``migrate_groups``
    (pinned groups).  Reads stay right once the kernel works again."""
    w, tree = _workload(4, n_versions=40)
    port, _ = _stores(w, np.arange(w.n_versions) % 6,
                      budget=3 if path == "groups" else None)
    assignment = _targets(w, tree, 4)["lyresplit"]
    t, _ = _trees(w, w.n_versions)
    trig = online.RepartitionTrigger(port, t, min_waves=1, low_density=1.0)
    old = (ck.peek_superblock(port) if path == "trigger"
           else next(iter(ck.get_superblock_groups(port).groups.values())))

    def launch(*args, **kwargs):
        raise KernelError("segment_move launch failed: cudaError 700")

    with monkeypatch.context() as m:
        m.setattr(sm, "segment_move_plain", launch)
        with pytest.raises(KernelError, match="cudaError 700"):
            if path == "trigger":
                ck.checkout_wave(port, _waves(4, w.n_versions, 1)[0])
                trig.observe()
            else:
                port.apply_migration(plan_migration(port, assignment))
    assert port.epoch == 1 and old._device is None
    assert ck.peek_superblock(port) is None
    if path == "groups":
        mgr = ck.get_superblock_groups(port)
        assert not mgr.groups and mgr.pins == mgr.evictions
    for v in range(w.n_versions):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v, 0])[0],
                                      w.data[w.graph.rlist(v)])


# ------------------------------------------------------------ trigger --
def _trees(w, n):
    """The first n versions' weighted tree, once for each side (a trigger
    extends its tree in place)."""
    tree, _ = to_tree(w.graph, w.vgraph)
    rtree, _ = ref_to_tree(w.graph, w.vgraph)
    cut = lambda t, cls: cls(parent=t.parent[:n].copy(),
                             n_records=t.n_records[:n].copy(),
                             edge_w=t.edge_w[:n].copy())
    return cut(tree, WeightedTree), cut(rtree, type(rtree))


def _waves(seed, n_versions, n_waves, k=6):
    rng = np.random.default_rng(seed)
    return [rng.choice(n_versions, k, replace=False).tolist()
            for _ in range(n_waves)]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_trigger_fires_at_the_same_wave_with_the_same_report(use_kernel):
    """Both stores serve the same waves (kernel tier: the port's plain
    kernels against the reference in interpret mode; host tier: numpy on
    both) and the trigger observes after each: it fires at the same wave,
    with the same report, the same migrated superblock and state."""
    w, tree = _workload(6, n_versions=30)
    port, ref = _stores(w, np.arange(w.n_versions) % 6,
                        device_copy=use_kernel)
    t, rt = _trees(w, w.n_versions)
    kw = {"min_waves": 2, "low_density": 1.0}
    trig = online.RepartitionTrigger(port, t, **kw)
    rtrig = ronline.RepartitionTrigger(ref, rt, **kw)
    fired = []
    for i, vids in enumerate(_waves(6, w.n_versions, 4)):
        for m, rm, v in zip(
                ck.checkout_wave(port, vids, use_kernel=use_kernel),
                rck.checkout_wave(ref, vids, use_kernel=use_kernel), vids):
            np.testing.assert_array_equal(m, np.asarray(rm))
            np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
        r, rr = trig.observe(), rtrig.observe()
        assert (r is None) == (rr is None)
        if r is not None:
            assert _report(r) == _report(rr)
            fired.append(i)
        _same_state(port, ref)
    assert fired == [1]
    assert trig.reports[0].superblock.used_device == use_kernel
    assert port._density_stats.low_streak == ref._density_stats.low_streak


def test_trigger_resyncs_commits_and_refuses_while_a_wave_is_in_flight():
    """Commits landed after the trigger was built are folded in from the
    commit log; an in-flight wave holds the migration off, and the streak
    survives until the wave is delivered."""
    w, tree = _workload(7, n_versions=36)
    n0 = 30
    ip = w.graph.indptr[:n0 + 1]
    pool = int(w.graph.indices[:ip[-1]].max()) + 1
    port = store_from_arrays(ip, w.graph.indices[:ip[-1]], pool,
                             w.data[:pool], np.arange(n0) % 5, device="cpu")
    ck.get_superblock(port)[0].device()
    t, _ = _trees(w, n0)
    trig = online.RepartitionTrigger(port, t, min_waves=1, low_density=1.0)
    cur = pool
    commits = []
    for v in range(n0, w.n_versions):
        rl = w.graph.rlist(v)
        commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                        "new_rows": w.data[rl[rl >= cur]]})
        cur += int((rl >= cur).sum())
    port.commit_many(commits)
    res = ck.checkout_wave(port, [0, 31, 35], device_out=True)
    port._inflight_waves = 1
    assert trig.observe() is None and trig.tree.n == w.n_versions
    np.testing.assert_array_equal(trig.tree.parent, tree.parent)
    np.testing.assert_array_equal(trig.tree.edge_w, tree.edge_w)
    np.testing.assert_array_equal(trig.tree.n_records, tree.n_records)
    res.materialize()
    port._inflight_waves = 0
    assert trig.observe() is not None
    assert trig.tree.n == w.n_versions


def test_trigger_refuses_a_tree_ahead_of_the_store():
    w, tree = _workload(8)
    port, _ = _stores(w, np.zeros(w.n_versions, np.int64), device_copy=False)
    ahead = WeightedTree(parent=np.append(tree.parent, 0),
                         n_records=np.append(tree.n_records, 1),
                         edge_w=np.append(tree.edge_w, 1))
    with pytest.raises(ValueError, match="ahead"):
        online.RepartitionTrigger(port, ahead)


# --------------------------------------------------- single-fault sweep --
@pytest.mark.parametrize("site", ["online.trigger", "migration.commit",
                                  "migrate.superblock"])
def test_single_migration_fault_matches_reference(site):
    """``online.trigger`` and ``migration.commit`` fire before the store
    changes: observe() raises, the store and the streak are untouched, and
    the next observe() migrates.  ``migrate.superblock`` fires after the
    morph: the migration lands, the device copy is dropped (report without
    superblock stats) and the next wave rebuilds it.  The reference does the
    same under the same fault."""
    w, tree = _workload(9, n_versions=30)
    port, ref = _stores(w, np.arange(w.n_versions) % 6)
    t, rt = _trees(w, w.n_versions)
    trig = online.RepartitionTrigger(port, t, min_waves=1, low_density=1.0)
    rtrig = ronline.RepartitionTrigger(ref, rt, min_waves=1, low_density=1.0)
    vids = [0, 5, 11, 29]
    ck.checkout_wave(port, vids)
    rck.checkout_wave(ref, vids)
    before = [p.block.copy() for p in port.partitions]
    for tr, plan in ((trig, FaultPlan.single(site)),
                     (rtrig, rfaults.FaultPlan.single(site))):
        with plan.armed():
            if site == "migrate.superblock":
                assert tr.observe().superblock is None
            else:
                with pytest.raises((InjectedFault, rfaults.InjectedFault)):
                    tr.observe()
        assert [r.site for r in plan.fired] == [site]
    _same_state(port, ref)
    if site == "migrate.superblock":
        assert ck.peek_superblock(port) is None
    else:
        assert port.epoch == 0 and port._density_stats.low_streak == 1
        for p, b in zip(port.partitions, before):
            np.testing.assert_array_equal(p.block, b)
        r, rr = trig.observe(), rtrig.observe()
        assert _report(r) == _report(rr) and r.superblock.used_device
        _same_state(port, ref)
    for v in range(w.n_versions):
        np.testing.assert_array_equal(ck.checkout_wave(port, [v])[0],
                                      w.data[w.graph.rlist(v)])


# ------------------------------------------------ online partitioner --
def test_same_partitioning_matches_reference():
    cases = [([0, 0, 1, 2], [5, 5, 3, 9]), ([0, 1, 0], [1, 0, 0]),
             ([0, 1], [0, 1, 1]), ([2, 2, 2], [0, 0, 0])]
    for a, b in cases:
        assert online._same_partitioning(np.array(a), np.array(b)) == \
            ronline._same_partitioning(np.array(a), np.array(b))


@pytest.mark.parametrize("every", [1, 4])
def test_replay_trace_matches_reference(every):
    """Paper Fig 14: the online partitioner streams a workload's versions
    and migrates when C_avg diverges from LyreSplit's by more than mu."""
    w = generate("SCI", n_versions=60, inserts=20, n_branches=6,
                 n_attrs=8, seed=10)
    tree, _ = to_tree(w.graph, w.vgraph)
    rtree, _ = ref_to_tree(w.graph, w.vgraph)
    got = online.replay(w.graph, tree, mu=1.2, every=every)
    want = ronline.replay(w.graph, rtree, mu=1.2, every=every)
    assert (got.c_avg, got.c_star, got.s_cost) == \
        (want.c_avg, want.c_star, want.s_cost)
    strip = lambda ev: {k: v for k, v in dataclasses.asdict(ev).items()
                        if k != "wall_s"}
    assert [strip(e) for e in got.migrations] == \
        [strip(e) for e in want.migrations]
    assert got.migrations
