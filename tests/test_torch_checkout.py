"""The port's wave engine held against the JAX package on the same numpy
inputs: every tier of ``checkout_partitioned`` equals the reference host
tier, the superblock layout and byte estimates equal the reference's, the
partition-group layer pins/evicts/launches exactly as the reference kernel
tier does (interpret mode, tiny store), ``WaveResult`` defers and caches as
specified, and the query layer over a store returns the reference's rows.
Gathers and store state are compared for exact equality."""
import types

import jax
import numpy as np
import pytest
import torch

import repro.core.checkout as rck
import repro.core.journal as rjournal
import repro.core.partition as rpart
import repro.core.query as rq
import repro_torch.core.checkout as ck
import repro_torch.core.journal as pjournal
import repro_torch.core.partition as tpart
import repro_torch.core.query as q
from repro.core import generate
from repro.core.graph import BipartiteGraph as RefGraph
from repro.core.partition import PartitionedCVD as RefStore
from repro_torch.core.faults import FaultPlan, InjectedFault
from repro_torch.core.partition import store_from_arrays


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference kernel tier's Pallas traces are cached process-wide;
    drop them when this module ends, so that a later test file in the same
    process that counts fresh traces of the same kernel starts cold."""
    yield
    jax.clear_caches()


def _pair(w, assignment):
    """The port's and the reference's store over one set of arrays."""
    port = store_from_arrays(w.graph.indptr, w.graph.indices,
                             w.graph.n_records, w.data, assignment,
                             device="cpu")
    return port, RefStore(w.graph, w.data, assignment)


def _sci_pair(seed=0, n_versions=40, n_partitions=4, n_attrs=20):
    w = generate("SCI", n_versions=n_versions, inserts=60, n_branches=6,
                 n_attrs=n_attrs, seed=seed)
    rng = np.random.default_rng(seed)
    assignment = rng.permutation(np.arange(w.n_versions) % n_partitions)
    return _pair(w, assignment) + (w,)


def _uniform_pair(seed=0, p=8, n_versions=32, r=1024, rows=24, d=12):
    """Uniform partitions (v -> v%p), half dense-run / half scattered
    versions: group byte sizes come out near-equal."""
    rng = np.random.default_rng(seed)
    rls = []
    for v in range(n_versions):
        if v % 2 == 0:
            s = int(rng.integers(0, r - rows))
            rls.append(np.arange(s, s + rows, dtype=np.int64))
        else:
            rls.append(np.sort(rng.choice(r, rows, replace=False)))
    graph = RefGraph.from_rlists(rls, n_records=r)
    data = rng.integers(0, 1 << 20, (r, d)).astype(np.int32)
    w = types.SimpleNamespace(graph=graph, data=data, n_versions=n_versions)
    return _pair(w, np.arange(n_versions) % p)


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        g, w_ = np.asarray(g), np.asarray(w_)
        assert g.dtype == w_.dtype and g.shape == w_.shape
        np.testing.assert_array_equal(g, w_)


# ----------------------------------------------------------------- tiers --
@pytest.mark.parametrize("engine,use_kernel", [
    ("wave", True), ("wave", None), ("perpart", True), ("wave", False),
    ("perpart", False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_checkout_partitioned_tiers_match_reference_host(seed, engine,
                                                         use_kernel):
    port, ref, w = _sci_pair(seed)
    rng = np.random.default_rng(seed)
    # None: the entry point's default tier (the kernel tier)
    tier = {} if use_kernel is None else {"use_kernel": use_kernel}
    for _ in range(3):
        vids = rng.choice(w.n_versions, 7).tolist()      # duplicates too
        want = rck.checkout_partitioned(ref, vids, use_kernel=False)
        got = ck.checkout_partitioned(port, vids, engine=engine, **tier)
        _same_blocks(got, want)
    assert ck.checkout_partitioned(port, [], engine=engine, **tier) == []
    with pytest.raises(ValueError):
        ck.checkout_partitioned(port, [w.n_versions], engine=engine)


def test_checkout_many_and_single_checkout_match_reference():
    port, ref, w = _sci_pair(2, n_partitions=3)
    vids = [0, 9, 9, 33, 5]
    _same_blocks(port.checkout_many(vids), ref.checkout_many(
        vids, use_kernel=False))
    for v in vids:
        np.testing.assert_array_equal(port.checkout(v), ref.checkout(v))
        np.testing.assert_array_equal(port.global_rlist(v),
                                      ref.global_rlist(v))
    assert port.storage_cost() == ref.storage_cost()
    assert port.avg_checkout_cost() == ref.avg_checkout_cost()
    assert [port.checkout_cost(v) for v in vids] == \
        [ref.checkout_cost(v) for v in vids]


def test_checkout_versions_off_a_graph_matches_reference():
    _, _, w = _sci_pair(1)
    vids = [3, 1, 30]
    want = rck.checkout_versions(w.graph, w.data, vids, use_kernel=False)
    for uk in (False, True):
        got = ck.checkout_versions(w.graph, w.data, vids, use_kernel=uk,
                                   device="cpu")
        _same_blocks(got, want)


# ------------------------------------------------------------ superblock --
def _words(n: int) -> int:
    """``n`` int32 columns rounded up to whole 16-byte words."""
    return -(-n // 4) * 4


def _same_layout(got, want):
    """The port's superblock is the reference's with each row padded on to
    whole 16-byte words (zeros), its lane tile rounded the same way."""
    wd = want.host.shape[1]
    assert got.host.shape == (want.host.shape[0], _words(wd))
    np.testing.assert_array_equal(got.host[:, :wd], want.host)
    assert not got.host[:, wd:].any()
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    np.testing.assert_array_equal(got.bounds, want.bounds)
    assert (got.d, got.bd, got.block_n, got.epoch) == \
        (want.d, _words(want.bd), want.block_n, want.epoch)


@pytest.mark.parametrize("seed,n_attrs", [(0, 20), (1, 130), (2, 7)])
def test_superblock_layout_matches_reference(seed, n_attrs):
    """The reference's layout, rows padded on to 16-byte words: D = 130
    int32 (520 bytes) gets 132 columns, the others are unchanged."""
    port, ref, w = _sci_pair(seed, n_attrs=n_attrs, n_partitions=5)
    sb, hit = ck.get_superblock(port)
    rsb, rhit = rck.get_superblock(ref)
    assert (hit, rhit) == (False, False)
    _same_layout(sb, rsb)
    widen = _words(rsb.host.shape[1]) / rsb.host.shape[1]
    assert ck.estimate_superblock_bytes(port) == sb.host.nbytes == \
        rck.estimate_superblock_bytes(ref) * widen
    for pids in ([0], [1, 3], [4, 2, 0]):
        assert ck.estimate_superblock_bytes(port, pids=pids) == \
            rck.estimate_superblock_bytes(ref, pids=pids) * widen
        _same_layout(ck.build_superblock(port, pids=pids),
                     rck.build_superblock(ref, pids=pids))
    np.testing.assert_array_equal(ck.partition_segment_bytes(port),
                                  rck.partition_segment_bytes(ref) * widen)
    assert ck.get_superblock(port)[1] is True


@pytest.mark.parametrize("n_attrs", [100, 257, 300])
def test_superblock_rows_are_whole_16_byte_words(n_attrs):
    """The CUDA kernels copy 16-byte words: every superblock row is a
    whole number of them (D 100 -> 128, 257 -> 260, 300 -> 300), and the
    wave tier's tickets, a commit wave's extension and a migration's
    reassembly still equal the reference's host tier."""
    port, ref, w = _sci_pair(3, n_attrs=n_attrs, n_partitions=4)
    sb, _ = ck.get_superblock(port)
    assert sb.host.shape[1] * sb.host.itemsize % 16 == 0
    assert sb.host.shape[1] == {100: 128, 257: 260, 300: 300}[n_attrs]
    vids = [0, 7, 7, 21, 39, 12]
    want = rck.checkout_partitioned(ref, vids, use_kernel=False)
    _same_blocks(ck.checkout_partitioned(port, vids, engine="wave",
                                         use_kernel=True), want)
    # a commit wave extends the pinned superblock (segment_append's
    # plain version here), then a migration moves its rows
    sb.device()
    commits = [{"parent": 39, "rlist": w.graph.rlist(39)[:-2]},
               {"parent": 3, "rlist": w.graph.rlist(3)}]
    assert port.commit_many(commits) == ref.commit_many(commits) == [40, 41]
    vids += [40, 41]
    _same_blocks(ck.checkout_partitioned(port, vids, engine="wave",
                                         use_kernel=True),
                 rck.checkout_partitioned(ref, vids, use_kernel=False))
    _same_layout(ck.get_superblock(port)[0], rck.get_superblock(ref)[0])
    old, rold = ck.take_superblock(port), rck.take_superblock(ref)
    assignment = np.arange(42) % 3
    plan = tpart.plan_migration(port, assignment)
    rplan = rpart.plan_migration(ref, assignment)
    port.apply_migration(plan)
    ref.apply_migration(rplan)
    new, st = ck.migrate_superblock(port, old, plan)
    rnew, _ = rck.migrate_superblock(ref, rold, rplan)
    assert st.used_device and st.reused_tiles > 0
    _same_layout(new, rnew)
    _same_blocks(ck.checkout_partitioned(port, vids, engine="wave",
                                         use_kernel=True),
                 rck.checkout_partitioned(ref, vids, use_kernel=False))


def test_superblock_device_uploads_once_and_survives_upload_fault():
    port, _, _ = _sci_pair(0)
    sb, _ = ck.get_superblock(port)
    with FaultPlan.single("superblock.upload").armed():
        with pytest.raises(InjectedFault):
            sb.device()
        assert sb._device is None and sb.uploads == 0
        dev = sb.device()
    assert sb.uploads == 1 and sb.device() is dev
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), sb.host)


def test_superblock_rejects_rows_beyond_int32_plans():
    big = types.SimpleNamespace(block=types.SimpleNamespace(
        shape=(2 ** 31, 4), dtype=np.dtype(np.int32)))
    store = types.SimpleNamespace(partitions=[big], epoch=0, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ck.build_superblock(store)


def test_evict_take_reinstall_and_repartition_match_reference(tmp_path):
    port, ref, w = _sci_pair(0)
    ck.get_superblock(port)[0].device()
    assert ck.peek_superblock(port) is not None
    sb = ck.take_superblock(port)
    assert ck.peek_superblock(port) is None and sb._device is not None
    assert ck.reinstall_superblock(port, sb)
    assert ck.peek_superblock(port) is sb
    assignment = np.arange(w.n_versions) % 3
    port.repartition(assignment)
    ref.repartition(assignment)
    assert sb._device is None and ck.peek_superblock(port) is None
    assert port._superblock_evictions == 1 and port.epoch == ref.epoch
    vids = [0, 4, 17, 39]
    _same_blocks(ck.checkout_wave(port, vids),
                 rck.checkout_wave(ref, vids, use_kernel=False))
    # with journals attached, both write the same repartition record
    # before the rebuild
    pj = pjournal.Journal(str(tmp_path / "port.wal"))
    rj = rjournal.Journal(str(tmp_path / "ref.wal"))
    pjournal.attach_journal(port, pj)
    rjournal.attach_journal(ref, rj)
    port.repartition(np.arange(w.n_versions) % 2)
    ref.repartition(np.arange(w.n_versions) % 2)
    pj.close()
    rj.close()
    recs, bad = pjournal.read_records(pj.path)
    assert bad is None and [r.kind for r in recs] == ["repartition"]
    assert recs[0].payload["epoch_after"] == port.epoch == ref.epoch
    assert (tmp_path / "port.wal").read_bytes() == \
        (tmp_path / "ref.wal").read_bytes()


# ----------------------------------------------------- partition groups --
GROUP_WAVES = ([0, 8, 16, 1, 9], [2, 10, 3], [4, 12, 5, 13], [0, 8, 6],
               [7, 15, 1], [2, 3, 4, 5])


@pytest.mark.parametrize("budget_div", [3, 5])
def test_group_layer_counters_match_reference_kernel_tier(budget_div):
    """Same wave sequence, same budget: the port's group layer launches,
    pins and evicts exactly as the reference kernel tier (Pallas interpret
    mode) does, and every gather is identical."""
    port, ref = _uniform_pair(budget_div)
    budget = rck.estimate_superblock_bytes(ref) // budget_div
    port.superblock_max_bytes = ref.superblock_max_bytes = budget
    for vids in GROUP_WAVES:
        got = ck.checkout_wave(port, vids, use_kernel=True)
        want = rck.checkout_wave(ref, vids, use_kernel=True)
        _same_blocks(got, want)
        mgr, rmgr = (ck.get_superblock_groups(port),
                     rck.get_superblock_groups(ref))
        assert vars(mgr.last_wave) == vars(rmgr.last_wave)
        for f in ("pins", "evictions", "launches", "waves",
                  "groups_touched", "straggler_requests", "pinned_bytes"):
            assert getattr(mgr, f) == getattr(rmgr, f), f
        assert list(mgr.groups) == list(rmgr.groups)
        assert mgr.planned == rmgr.planned
        assert mgr.pins - mgr.evictions == len(mgr.groups)
        assert mgr.pinned_bytes <= mgr.budget
    pol = port._hot_set_policy
    np.testing.assert_array_equal(pol.rank(port, 8),
                                  ref._hot_set_policy.rank(ref, 8))


def test_group_layer_host_tier_and_regroup_match_reference():
    port, ref = _uniform_pair(7)
    budget = rck.estimate_superblock_bytes(ref) // 3
    port.superblock_max_bytes = ref.superblock_max_bytes = budget
    for vids in GROUP_WAVES[:3]:
        ck.checkout_wave(port, vids, use_kernel=True)
        rck.checkout_wave(ref, vids, use_kernel=True)
    for vids in GROUP_WAVES:            # host tier: pinned groups only
        _same_blocks(ck.checkout_wave(port, vids, use_kernel=False),
                     rck.checkout_wave(ref, vids, use_kernel=False))
    mgr, rmgr = (ck.get_superblock_groups(port),
                 rck.get_superblock_groups(ref))
    mgr.regroup()
    rmgr.regroup()
    assert mgr.planned == rmgr.planned and mgr.evictions == rmgr.evictions
    assert mgr.regroup_drift() == rmgr.regroup_drift()


def test_group_take_all_and_install_match_reference():
    """Detaching every pinned group and re-pinning one under the budget
    keeps the same books as the reference."""
    port, ref = _uniform_pair(11)
    budget = rck.estimate_superblock_bytes(ref) // 3
    port.superblock_max_bytes = ref.superblock_max_bytes = budget
    for vids in GROUP_WAVES[:2]:
        ck.checkout_wave(port, vids, use_kernel=True)
        rck.checkout_wave(ref, vids, use_kernel=True)
    mgr, rmgr = (ck.get_superblock_groups(port),
                 rck.get_superblock_groups(ref))
    taken, rtaken = mgr.take_all(), rmgr.take_all()
    assert [list(t.pids) for t in taken] == [list(t.pids) for t in rtaken]
    assert all(t._device is not None for t in taken)
    assert mgr.install(taken[0]) and rmgr.install(rtaken[0])
    for f in ("pins", "evictions", "pinned_bytes"):
        assert getattr(mgr, f) == getattr(rmgr, f), f
    assert mgr.pins - mgr.evictions == len(mgr.groups) == 1


# ---------------------------------------------------------- wave results --
def test_wave_result_defers_and_caches():
    port, ref, w = _sci_pair(0)
    vids = [3, 22, 3, 39]
    res = ck.checkout_wave(port, vids, device_out=True)
    assert isinstance(res, ck.WaveResult) and not res.delivered
    assert res.ready()                  # CPU launches complete inline
    (part,) = res.parts
    assert isinstance(part.packed, torch.Tensor) and part.event is None
    mats = res.materialize()
    assert res.delivered and res.materialize() is mats
    assert part.packed is None          # device tensor released at split
    _same_blocks(mats, rck.checkout_wave(ref, vids, use_kernel=False))
    host = ck.checkout_wave(port, vids, use_kernel=False, device_out=True)
    assert host.delivered and host.ready()


def test_wave_result_ready_reads_the_launch_event():
    """``ready()`` reports an in-flight launch until its event completes."""
    port, _, _ = _sci_pair(0)
    res = ck.checkout_wave(port, [1, 2], device_out=True)

    class Event:
        done = False

        def query(self):
            return self.done

    ev = res.parts[0].event = Event()
    assert not res.ready()
    ev.done = True
    assert res.ready()


def test_transfer_fault_keeps_the_device_result():
    port, _, _ = _sci_pair(0)
    res = ck.checkout_wave(port, [5, 6, 7], device_out=True)
    with FaultPlan.single("serve.transfer").armed():
        with pytest.raises(InjectedFault):
            res.materialize()
        assert res.parts[0].packed is not None
        mats = res.materialize()
    _same_blocks(mats, ck.checkout_wave(port, [5, 6, 7], use_kernel=False))


def test_density_telemetry_matches_reference():
    port, ref, w = _sci_pair(1)
    ck.get_density_stats(port, create=True)
    rck.get_density_stats(ref, create=True)
    rng = np.random.default_rng(4)
    for _ in range(3):
        vids = rng.choice(w.n_versions, 5, replace=False).tolist()
        ck.checkout_wave(port, vids, use_kernel=True)
        rck.checkout_wave(ref, vids, use_kernel=False)
    a, b = port._density_stats, ref._density_stats
    assert (a.waves, a.tiles, a.low_streak, a.per_vid) == \
        (b.waves, b.tiles, b.low_streak, b.per_vid)
    assert a.run_tiles == pytest.approx(b.run_tiles, rel=0, abs=0)


# ----------------------------------------------------------------- query --
@pytest.mark.parametrize("use_kernel", [True, False])
def test_query_join_and_diff_on_a_store_match_reference(use_kernel):
    port, ref, w = _sci_pair(3, n_partitions=5)
    for v1, v2 in ((0, 1), (5, 30), (12, 12), (39, 2)):
        np.testing.assert_array_equal(
            q.join_versions(port, None, v1, v2, on=2, use_kernel=use_kernel),
            rq.join_versions(ref, None, v1, v2, on=2, use_kernel=False))
        for a, b in zip(q.diff(port, None, v1, v2, use_kernel=use_kernel),
                        rq.diff(ref, None, v1, v2, use_kernel=False)):
            np.testing.assert_array_equal(a, b)


def test_query_graph_path_matches_reference():
    _, _, w = _sci_pair(2)
    np.testing.assert_array_equal(
        q.join_versions(w.graph, w.data, 3, 7, use_kernel=False),
        rq.join_versions(w.graph, w.data, 3, 7, use_kernel=False))
    np.testing.assert_array_equal(
        q.versions_with_record(w.graph, w.data, lambda d: d[:, 2] > 900),
        rq.versions_with_record(w.graph, w.data, lambda d: d[:, 2] > 900))
    np.testing.assert_array_equal(
        q.per_version_aggregate(w.graph, w.data, 3, "mean"),
        rq.per_version_aggregate(w.graph, w.data, 3, "mean"))


def test_store_from_arrays_owns_its_state():
    _, _, w = _sci_pair(0)
    indices = w.graph.indices.copy()
    data = w.data.copy()
    store = store_from_arrays(w.graph.indptr, indices, w.graph.n_records,
                              data, np.zeros(w.n_versions, np.int64),
                              device="cpu")
    before = store.checkout(5).copy()
    indices[:] = 0
    data[:] = -1
    np.testing.assert_array_equal(store.checkout(5), before)
    assert store.device == torch.device("cpu")

