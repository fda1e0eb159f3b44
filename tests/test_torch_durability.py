"""The port's store durability (``repro_torch.core.durability``) and its
checkpoint CVD (``repro_torch.train.checkpoint``) on CPU stores, case for
case with the JAX package's durability suite: bitexact checkpoint
encoding, atomic persistence, snapshot/restore of the graph, partitioning,
heat, density and group state, ticket watermarks, parent-chained dedup,
and the snapshot -> kill -> restore cycle mid migration.  Then the two
packages against each other: the same tree flattens to the same paths,
the same store snapshots to the same manifest entries and restores to the
same state, and the port's ``cvd.pkl`` names only the port's classes."""
import collections
import os
import pickletools

import numpy as np
import pytest
import torch

import repro.core.datamodels as rdatamodels
import repro.core.durability as rdur
import repro.core.partition as rpart
from repro.core.checkout import get_density_stats as ref_density
from repro.core.checkout import get_superblock_groups as ref_groups
from repro.core.graph import BipartiteGraph as RefGraph
from repro.core.online import get_hot_set_policy as ref_heat
from repro.train import checkpoint as rckpt
from repro_torch.core.checkout import (checkout_wave,
                                       estimate_superblock_bytes,
                                       get_density_stats,
                                       get_superblock_groups)
from repro_torch.core.datamodels import SplitByRlist as PortSplit
from repro_torch.core.durability import (StoreDurability,
                                         snapshot_roundtrip_equal)
from repro_torch.core.faults import FaultPlan, InjectedFault
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.online import RepartitionTrigger, get_hot_set_policy
from repro_torch.core.partition import PartitionedCVD
from repro_torch.core.version_graph import WeightedTree
from repro_torch.serve.checkout import BatchedCheckoutServer
from repro_torch.train import checkpoint as pckpt
from repro_torch.train.checkpoint import CheckpointStore


def _arrays(seed=7, n_versions=12, n_records=512, size=24, n_attrs=8):
    rng = np.random.default_rng(seed)
    rls = [np.sort(rng.choice(n_records, size,
                              replace=False)).astype(np.int64)
           for _ in range(n_versions)]
    data = rng.integers(0, 1 << 20, (n_records, n_attrs)).astype(np.int32)
    return rls, data


def _scattered_store(**kw):
    rls, data = _arrays(**kw)
    graph = BipartiteGraph.from_rlists(rls, n_records=len(data))
    store = PartitionedCVD(graph, data, np.zeros(len(rls), np.int64),
                           device="cpu")
    tree = WeightedTree(
        parent=np.concatenate([[-1], np.zeros(len(rls) - 1, np.int64)]),
        n_records=np.array([len(r) for r in rls], np.int64),
        edge_w=np.zeros(len(rls), np.int64))
    return store, tree, graph, data


def _ref_store(**kw):
    rls, data = _arrays(**kw)
    graph = RefGraph.from_rlists(rls, n_records=len(data))
    return rpart.PartitionedCVD(graph, data, np.zeros(len(rls), np.int64))


# ------------------------------------------------------ bitexact encoding --
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64,
                                   np.float32, np.uint8])
def test_checkpoint_bitexact_roundtrip(tmp_path, dtype, rng):
    """The raw encoding round-trips ANY dtype exactly — int64 rid arrays
    are precisely what the fp32 cast would corrupt."""
    ck = CheckpointStore(str(tmp_path), shard_rows=64)
    if np.issubdtype(dtype, np.integer):
        leaf = rng.integers(np.iinfo(dtype).min // 2,
                            np.iinfo(dtype).max // 2,
                            (37, 3)).astype(dtype)
    else:
        leaf = rng.standard_normal((37, 3)).astype(dtype)
    tree = {"a": leaf, "b": np.arange(5, dtype=dtype)}
    vid = ck.save(0, tree, bitexact=True)
    got = ck.restore(vid, treedef_like={"a": 0, "b": 0})
    assert got["a"].dtype == dtype
    np.testing.assert_array_equal(got["a"], leaf)
    np.testing.assert_array_equal(got["b"], tree["b"])


def test_checkpoint_int64_survives_values_fp32_would_mangle(tmp_path):
    ck = CheckpointStore(str(tmp_path), shard_rows=32)
    big = np.array([2**53 + 1, -(2**53) - 3, 2**62], np.int64)
    vid = ck.save(0, {"rids": big}, bitexact=True)
    got = ck.restore(vid, treedef_like={"rids": 0})
    np.testing.assert_array_equal(got["rids"], big)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32,
                                   torch.float32])
def test_checkpoint_takes_tensors_and_restores_to_a_device(tmp_path, dtype):
    """Tensor leaves save as their host bytes; ``device`` restores them as
    tensors there, bit for bit, and no ``device`` gives host numpy."""
    ck = CheckpointStore(str(tmp_path), shard_rows=16)
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((7, 5), generator=gen) * 1e6).to(dtype)
    vid = ck.save(0, {"x": x, "n": [x[0], None]}, bitexact=True)
    got = ck.restore(vid, device="cpu", treedef_like={"x": 0, "n": [0, None]})
    assert isinstance(got["x"], torch.Tensor) and got["x"].dtype == dtype
    assert torch.equal(got["x"], x) and torch.equal(got["n"][0], x[0])
    assert got["n"][1] is None
    flat = ck.restore(vid)
    assert [type(a) for a in flat] == [np.ndarray, np.ndarray]
    np.testing.assert_array_equal(flat[1], x.numpy())


def test_persist_is_atomic_no_tmp_left(tmp_path):
    ck = CheckpointStore(str(tmp_path))
    ck.save(0, {"x": np.arange(4, dtype=np.float32)})
    names = set(os.listdir(tmp_path))
    assert not any(n.endswith(".tmp") for n in names)
    assert {"cvd.pkl", "manifest.json"} <= names


@pytest.mark.parametrize("seed", [0, 1])
def test_split_by_rlist_matches_the_jax_package(seed):
    """The checkpoint CVD's storage model: the same commits (a root, a
    child that keeps most rows and adds some, a two-parent merge) give the
    same vids, rlists, checkouts, stored cells and version graph."""
    rng = np.random.default_rng(seed)
    port, ref = PortSplit(n_attrs=6), rdatamodels.SplitByRlist(n_attrs=6)
    t0 = rng.integers(0, 50, (40, 6)).astype(np.int32)
    t1 = np.concatenate([t0[rng.permutation(40)[:30]],
                         rng.integers(0, 50, (7, 6)).astype(np.int32)])
    t2 = np.concatenate([t0[5:15], t1[-4:]])
    for model in (port, ref):
        assert model.commit(t0, t=0.0) == 0
        assert model.commit(t1, parents=(0,), t=1.0) == 1
        assert model.commit(t2, parents=(0, 1), t=2.0) == 2
    for v in range(3):
        np.testing.assert_array_equal(port.rlist(v), ref.rlist(v))
        np.testing.assert_array_equal(port.checkout(v), ref.checkout(v))
        assert port.vgraph.ancestors(v) == ref.vgraph.ancestors(v)
    assert port.storage_cells() == ref.storage_cells()
    np.testing.assert_array_equal(port.data_table, ref.data_table)


_NT = collections.namedtuple("_NT", "x y")


@pytest.mark.parametrize("tree", [
    {"b": [1, (2, 3)], "a": {"z": 4, "c": None, "k": _NT(5, 6)}, "e": []},
    {"w": np.arange(3), "v": ({"q": 1.5}, [None, 7])},
    np.arange(4),
    [[], [[1]], {"1": 2, "0": 3}],
], ids=["nested", "mixed", "leaf", "lists"])
def test_flatten_matches_the_jax_package(tree):
    """The port's walk gives the paths and leaves that jax's
    ``tree_flatten_with_path`` gives the reference, in the same order,
    and unflattens back into the same structure."""
    paths, leaves, _ = pckpt._flatten_with_paths(tree)
    want_paths, want_leaves, _ = rckpt._flatten_with_paths(tree)
    assert paths == want_paths
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        np.testing.assert_array_equal(a, b)
    back = pckpt._unflatten(tree, iter(leaves))
    assert pckpt._flatten_with_paths(back)[0] == paths


# ------------------------------------------------------ store round-trip --
def test_snapshot_restore_roundtrip_full_state(tmp_path):
    store, tree, graph, data = _scattered_store()
    store.repartition(np.arange(graph.n_versions) % 4)
    store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    mgr = get_superblock_groups(store, budget=store.superblock_max_bytes,
                                create=True)
    mgr.warm(device=False)
    pol = get_hot_set_policy(store, create=True)
    pol.touch([0, 1])
    pol.touch([1])
    stats = get_density_stats(store, create=True)
    stats.record([1, 5], np.array([0.2, 0.4]), np.array([3, 5]))

    dur = StoreDurability(str(tmp_path))
    snap = dur.snapshot(store)
    rs = dur.restore(device="cpu")
    assert rs.snapshot.vid == snap.vid
    assert rs.store.device == torch.device("cpu")
    assert snapshot_roundtrip_equal(store, rs.store)
    assert rs.store.epoch == store.epoch
    pol2 = get_hot_set_policy(rs.store)
    assert pol2.alpha == pol.alpha and pol2.waves == pol.waves
    assert pol2.touch_ewma == pol.touch_ewma
    st2 = get_density_stats(rs.store)
    assert st2.low_streak == stats.low_streak
    assert st2.per_vid == stats.per_vid
    assert st2.last_wave_density == stats.last_wave_density
    mgr2 = get_superblock_groups(rs.store)
    assert mgr2.planned == mgr.planned
    assert mgr2.straggler_pids == mgr.straggler_pids
    assert mgr2.budget == mgr.budget
    assert len(mgr2.groups) == 0
    assert mgr2.pins - mgr2.evictions == len(mgr2.groups) == 0
    for v in range(graph.n_versions):
        np.testing.assert_array_equal(rs.store.checkout(v),
                                      data[graph.rlist(v)])


def test_restored_warmup_repins_lazily(tmp_path):
    """Superblocks are NOT persisted: the first warmup of a restored
    server re-pins the planned groups under the same budget."""
    store, tree, graph, data = _scattered_store()
    store.repartition(np.arange(graph.n_versions) % 4)
    store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    mgr = get_superblock_groups(store, budget=store.superblock_max_bytes,
                                create=True)
    mgr.warm(device=False)
    assert len(mgr.groups) > 0
    dur = StoreDurability(str(tmp_path))
    dur.snapshot(store)
    rs = dur.restore(device="cpu")
    srv = rs.make_server()
    mgr2 = get_superblock_groups(rs.store)
    assert len(mgr2.groups) == 0                     # cold after restore
    srv.warmup()
    assert len(mgr2.groups) > 0                      # lazily re-pinned
    assert mgr2.pins - mgr2.evictions == len(mgr2.groups)
    outs = srv.serve([2, 7, 9])
    for v, m in zip([2, 7, 9], outs):
        np.testing.assert_array_equal(np.asarray(m), data[graph.rlist(v)])
    srv.close()


def test_ticket_watermark_restored(tmp_path):
    store, tree, graph, data = _scattered_store()
    srv = BatchedCheckoutServer(store, use_kernel=False)
    tickets = [srv.submit(v) for v in (1, 2, 3)]
    srv.flush()
    dur = StoreDurability(str(tmp_path))
    dur.snapshot(store, server=srv)
    rs = dur.restore(device="cpu")
    srv2 = rs.make_server(use_kernel=False)
    t = srv2.submit(4)
    assert t >= srv._next_ticket                     # no collision
    assert t > max(tickets)
    srv.close()
    srv2.close()


def test_per_tenant_ticket_watermarks_restored(tmp_path):
    store, tree, graph, data = _scattered_store()
    sa = BatchedCheckoutServer(store, use_kernel=False, tenant="a")
    sb = BatchedCheckoutServer(store, use_kernel=False, tenant="b")
    for v in (1, 2, 3, 4, 5):
        sa.submit(v)
    sa.flush()
    sb.submit(7)
    sb.flush()
    dur = StoreDurability(str(tmp_path))
    snap = dur.snapshot(store, servers={"a": sa, "b": sb})
    assert snap.meta["ticket_watermarks"] == {"a": 5, "b": 1}
    assert snap.meta["ticket_watermark"] == 5        # legacy scalar = max
    rs = dur.restore(device="cpu")
    ra = rs.make_server(use_kernel=False, tenant="a")
    rb = rs.make_server(use_kernel=False, tenant="b")
    assert ra._next_ticket == 5 and rb._next_ticket == 1
    assert ra.submit(0) == 5                          # resumes a's stream
    assert rb.submit(0) == 1                          # NOT the global max
    rz = rs.make_server(use_kernel=False, tenant="z")
    assert rz._next_ticket == 5
    r0 = rs.make_server(use_kernel=False)
    r1 = rs.make_server(use_kernel=False)
    assert r0.tenant is None and r1.tenant == "restored-1"
    assert r0._next_ticket == r1._next_ticket == 5
    dup = BatchedCheckoutServer(store, use_kernel=False, tenant="a")
    with pytest.raises(ValueError, match="namespace"):
        dur.snapshot(store, servers=[sa, dup])
    for s in (sa, sb, ra, rb, rz, r0, r1, dup):
        s.close()


def test_snapshots_parent_chain_and_dedup(tmp_path):
    store, tree, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path))
    s0 = dur.snapshot(store)
    s1 = dur.snapshot(store)
    assert dur.snapshots() == [s0.vid, s1.vid]
    assert s0.vid in dur.lineage(s1.vid)
    assert dur.dedup_ratio() <= 0.55                 # ~2x stored once


def test_restore_empty_raises(tmp_path):
    dur = StoreDurability(str(tmp_path))
    with pytest.raises(ValueError):
        dur.restore(device="cpu")


# ------------------------------------- the mid-migration kill/restore bar --
def test_snapshot_kill_restore_mid_migration(tmp_path):
    """snapshot -> injected crash at the migration commit point -> the
    live store is still pre-migration AND the restored store matches it;
    the restored store's trigger picks the migration back up, and a
    second snapshot restores the POST-migration state."""
    store, tree, graph, data = _scattered_store()
    trig = RepartitionTrigger(store, tree, min_waves=2, use_kernel=False)
    for _ in range(2):
        checkout_wave(store, [0, 3, 7, 11], use_kernel=False)
    pol = get_hot_set_policy(store, create=True)
    pol.touch([0])
    dur = StoreDurability(str(tmp_path))
    dur.snapshot(store)
    epoch0 = store.epoch

    with FaultPlan.single("migration.commit").armed():
        with pytest.raises(InjectedFault):
            trig.observe()                           # the "crash"
    assert store.epoch == epoch0                     # commit never landed

    rs = dur.restore(device="cpu")
    assert snapshot_roundtrip_equal(store, rs.store)
    assert get_hot_set_policy(rs.store).touch_ewma == pol.touch_ewma
    assert get_density_stats(rs.store).low_streak >= 2

    trig2 = RepartitionTrigger(rs.store, tree, min_waves=2,
                               use_kernel=False)
    rep = trig2.observe()
    assert rep is not None and rs.store.epoch == epoch0 + 1
    for v in range(graph.n_versions):
        np.testing.assert_array_equal(rs.store.checkout(v),
                                      data[graph.rlist(v)])
    dur.snapshot(rs.store)
    rs2 = dur.restore(device="cpu")
    assert rs2.store.epoch == epoch0 + 1
    assert snapshot_roundtrip_equal(rs.store, rs2.store)


# ------------------------------------------------------- the two packages --
def _prime(store, groups, heat, density):
    """The same maintenance state on either package's store."""
    store.repartition(np.arange(store.graph.n_versions) % 4)
    store.superblock_max_bytes = 49152
    groups(store, budget=49152, create=True).warm(device=False)
    pol = heat(store, create=True)
    pol.touch([0, 1])
    pol.touch([1])
    density(store, create=True).record([1, 5], np.array([0.2, 0.4]),
                                       np.array([3, 5]))


def test_manifest_and_restore_agree_across_packages(tmp_path):
    """The same store snapshotted twice (with a commit between) by both
    packages: every manifest ``versions`` entry agrees on paths, shapes,
    dtypes, crc32, n_blocks, nbytes, row_perm and meta, and the restored
    states are equal."""
    port, _, graph, data = _scattered_store()
    ref = _ref_store()
    _prime(port, get_superblock_groups, get_hot_set_policy,
           get_density_stats)
    _prime(ref, ref_groups, ref_heat, ref_density)
    pd = StoreDurability(str(tmp_path / "port"), shard_rows=256)
    rd = rdur.StoreDurability(str(tmp_path / "ref"), shard_rows=256)
    rng = np.random.default_rng(9)
    new = rng.integers(0, 99, (5, 8)).astype(np.int32)
    for s, d in ((port, pd), (ref, rd)):
        d.snapshot(s)
        k = s.graph.n_records
        s.commit_version(np.concatenate([s.graph.rlist(3),
                                         np.arange(k, k + 5)]),
                         parent=3, new_rows=new)
        d.snapshot(s)
    pv, rv = pd.ckpt.manifest["versions"], rd.ckpt.manifest["versions"]
    assert sorted(pv) == sorted(rv) == ["0", "1"]
    assert "row_perm" in pv["1"]
    for vid in pv:
        assert pv[vid] == rv[vid]
        for entry in pv[vid]["layout"]:
            assert {"path", "shape", "dtype", "crc32", "n_blocks",
                    "nbytes"} <= set(entry)
    assert pd.dedup_ratio() == rd.dedup_ratio()
    a = pd.restore(device="cpu")
    b = rd.restore()
    assert snapshot_roundtrip_equal(a.store, b.store)
    assert snapshot_roundtrip_equal(a.store, port)
    assert get_superblock_groups(a.store).planned == \
        ref_groups(b.store).planned
    assert get_hot_set_policy(a.store).touch_ewma == \
        ref_heat(b.store).touch_ewma


def test_cvd_pickle_names_only_port_classes(tmp_path):
    """``cvd.pkl`` pickles each package's own ``SplitByRlist``: the port's
    names ``repro_torch`` classes and never the JAX package's (so a
    snapshot directory is not cross-restored between the packages)."""
    store, *_ = _scattered_store()
    StoreDurability(str(tmp_path)).snapshot(store)
    with open(tmp_path / "cvd.pkl", "rb") as f:
        blob = f.read()
    globals_ = [arg for op, arg, _ in pickletools.genops(blob)
                if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "GLOBAL")
                and isinstance(arg, str) and arg.startswith("repro")]
    assert set(globals_) == {"repro_torch.core.datamodels",
                             "repro_torch.core.version_graph"}
