"""The port's integrity layer on CPU stores, case for case with the JAX
package's scrub suite: checkpoint digest verification, ``scrub()``'s
zero-false-positive sweep, restore's parent-chain fallback past corrupt
generations, the snapshot ``format_version``, retention through
``prune(keep_last=N)``, and the ``MultiTenantServer`` snapshot path with
its per-tenant watermarks journaled on every grant."""
import json
import os

import numpy as np
import pytest

from repro_torch.core.durability import (SNAPSHOT_FORMAT, StoreDurability,
                                         snapshot_roundtrip_equal)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.journal import read_records
from repro_torch.core.partition import PartitionedCVD
from repro_torch.serve.checkout import BatchedCheckoutServer
from repro_torch.serve.tenancy import MultiTenantServer, TenantQuota


def _scattered_store(seed=7, n_versions=12, n_records=512, size=24,
                     n_attrs=8):
    rng = np.random.default_rng(seed)
    rls = [np.sort(rng.choice(n_records, size,
                              replace=False)).astype(np.int64)
           for _ in range(n_versions)]
    graph = BipartiteGraph.from_rlists(rls, n_records=n_records)
    data = rng.integers(0, 1 << 20, (n_records, n_attrs)).astype(np.int32)
    return PartitionedCVD(graph, data, np.zeros(n_versions, np.int64),
                          device="cpu"), graph, data


def _commit_some(store, rng, parent):
    """One commit with fresh rows — the NEXT snapshot stores new chunks of
    its own (so corrupting them spares older generations)."""
    k = store.graph.n_records
    new = rng.integers(0, 1 << 20, (6, store.data.shape[1])
                       ).astype(store.data.dtype)
    rl = np.concatenate([store.graph.rlist(parent), np.arange(k, k + 6)])
    return store.commit_version(rl, parent=parent, new_rows=new)


def _corrupt_newest_chunk(dur):
    """Flip one bit in the newest stored chunk — rows only the NEWEST
    snapshot references, so its parent still verifies."""
    cvd = dur.ckpt.cvd
    cvd._chunks[-1] = cvd._chunks[-1].copy()
    cvd._chunks[-1][0, 0] ^= 1
    cvd._cache = None
    dur.ckpt._persist()


def _restore(path, **kw):
    return StoreDurability(str(path)).restore(device="cpu", **kw)


# ------------------------------------------------------------ scrub layer --
def test_scrub_clean_store_zero_findings(tmp_path):
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    rng = np.random.default_rng(1)
    dur.snapshot(store)
    _commit_some(store, rng, 2)
    dur.snapshot(store)
    rep = dur.scrub()
    assert rep["clean"] is True
    assert all(bad == [] for bad in rep["snapshots"].values())
    assert all(j["bad_offset"] is None for j in rep["journals"].values())


def test_scrub_detects_bitflip_and_restore_falls_back(tmp_path):
    """A flipped bit in the newest generation's rows: scrub names exactly
    that generation, restore() falls back to the verified parent and
    replays BOTH journals back to the live state, restore(vid=newest)
    refuses."""
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    rng = np.random.default_rng(2)
    s0 = dur.snapshot(store)
    _commit_some(store, rng, 1)                 # journaled in gen 0
    s1 = dur.snapshot(store)
    _commit_some(store, rng, 3)                 # journaled in gen 1
    _corrupt_newest_chunk(dur)

    rep = dur.scrub()
    assert rep["clean"] is False
    assert rep["snapshots"][s1.vid] != []
    assert rep["snapshots"][s0.vid] == []

    rs = _restore(tmp_path / "d")
    assert rs.snapshot.vid == s0.vid            # fell back past s1
    assert rs.replayed >= 2                     # both commits replayed
    assert snapshot_roundtrip_equal(rs.store, store)

    with pytest.raises(ValueError, match="digest verification"):
        _restore(tmp_path / "d", vid=s1.vid)
    assert _restore(tmp_path / "d", vid=s1.vid, verify=False) is not None


def test_every_generation_corrupt_raises(tmp_path):
    store, graph, data = _scattered_store(n_versions=4, n_records=64,
                                          size=8)
    dur = StoreDurability(str(tmp_path / "d"))
    dur.snapshot(store)
    cvd = dur.ckpt.cvd
    cvd._chunks[0] = cvd._chunks[0].copy()
    cvd._chunks[0][0, 0] ^= 1                   # the base chunk: every
    cvd._cache = None                           # generation reads it
    dur.ckpt._persist()
    with pytest.raises(ValueError, match="every snapshot failed"):
        _restore(tmp_path / "d")


def test_checkpoint_verify_names_bad_leaves(tmp_path):
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    vid = dur.snapshot(store).vid
    assert dur.verify(vid) == []
    _corrupt_newest_chunk(dur)
    bad = StoreDurability(str(tmp_path / "d")).verify(vid)
    assert bad != [] and all(isinstance(p, str) for p in bad)


# ----------------------------------------------------------- format layer --
def test_format_version_recorded_and_future_refused(tmp_path):
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    snap = dur.snapshot(store)
    assert snap.meta["format_version"] == SNAPSHOT_FORMAT == 2
    meta = dur.ckpt.manifest["versions"][str(snap.vid)]["meta"]
    meta["format_version"] = SNAPSHOT_FORMAT + 7
    dur.ckpt._persist()
    with pytest.raises(ValueError, match="format_version"):
        _restore(tmp_path / "d")


def test_old_snapshot_missing_fields_tolerated(tmp_path):
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"), journal=False)
    snap = dur.snapshot(store)
    meta = dur.ckpt.manifest["versions"][str(snap.vid)]["meta"]
    for key in ("format_version", "epoch", "n_records",
                "ticket_watermarks", "density", "heat", "groups",
                "superblock_max_bytes"):
        meta.pop(key, None)
    dur.ckpt._persist()
    rs = StoreDurability(str(tmp_path / "d"), journal=False).restore(
        device="cpu")
    assert rs.store.epoch == 0
    assert rs.ticket_watermark == 0
    np.testing.assert_array_equal(np.asarray(rs.store.data), data)
    np.testing.assert_array_equal(rs.store.assignment, store.assignment)


def test_corrupt_manifest_files_raise_clearly(tmp_path):
    store, graph, data = _scattered_store(n_versions=4, n_records=64,
                                          size=8)
    d = tmp_path / "d"
    StoreDurability(str(d)).snapshot(store)
    with open(d / "manifest.json", "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        StoreDurability(str(d))

    d2 = tmp_path / "d2"
    StoreDurability(str(d2)).snapshot(store)
    with open(d2 / "manifest.json", "w") as f:
        json.dump({"wrong": "shape"}, f)
    with pytest.raises(ValueError, match="versions table"):
        StoreDurability(str(d2))

    d3 = tmp_path / "d3"
    StoreDurability(str(d3)).snapshot(store)
    with open(d3 / "cvd.pkl", "wb") as f:
        f.write(b"\x80\x04 not a pickle")
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        StoreDurability(str(d3))


# -------------------------------------------------------- retention layer --
def test_prune_keeps_lineage_dedup_and_journal_tail(tmp_path):
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    rng = np.random.default_rng(4)
    vids = []
    for parent in (1, 3, 5):
        vids.append(dur.snapshot(store).vid)
        _commit_some(store, rng, parent)
    vids.append(dur.snapshot(store).vid)
    _commit_some(store, rng, 7)                  # tail rides the journal
    dedup_before = dur.dedup_ratio()

    mapping = dur.prune(keep_last=2)
    assert sorted(mapping) == vids[-2:]
    assert dur.snapshots() == sorted(mapping.values())
    live = {os.path.basename(dur._journal_path(v))
            for v in dur.snapshots()}
    on_disk = {p for p in os.listdir(tmp_path / "d")
               if p.startswith("journal-")}
    assert on_disk == live
    assert dur.dedup_ratio() < 1.0
    assert dedup_before < 1.0
    new_latest = mapping[vids[-1]]
    assert dur.lineage(new_latest) == [mapping[vids[-2]]]

    rs = _restore(tmp_path / "d")
    assert snapshot_roundtrip_equal(rs.store, store)
    # the PRUNING handle's own journal stayed attached + appendable
    _commit_some(store, rng, 9)
    rs2 = _restore(tmp_path / "d")
    assert snapshot_roundtrip_equal(rs2.store, store)


def test_prune_noop_and_validation(tmp_path):
    store, graph, data = _scattered_store(n_versions=4, n_records=64,
                                          size=8)
    dur = StoreDurability(str(tmp_path / "d"))
    v0 = dur.snapshot(store).vid
    assert dur.prune(keep_last=5) == {v0: v0}    # fewer than keep: no-op
    with pytest.raises(ValueError, match="keep_last"):
        dur.prune(keep_last=0)


# ------------------------------------------------------ multi-tenant path --
def test_snapshot_accepts_multitenant_server(tmp_path):
    store, graph, data = _scattered_store()
    mts = MultiTenantServer(store, threads=False,
                            quotas={"a": TenantQuota(),
                                    "b": TenantQuota()})
    mts.submit_many("a", [0, 1, 2])
    mts.submit("b", 3)
    dur = StoreDurability(str(tmp_path / "d"))
    snap = dur.snapshot(store, servers=mts)
    assert snap.meta["ticket_watermarks"] == {"a": 3, "b": 1}
    mts.close()
    rs = _restore(tmp_path / "d")
    sa = rs.make_server(tenant="a")
    sb = rs.make_server(tenant="b")
    assert sa._next_ticket >= 3 and sb._next_ticket >= 1


def test_snapshot_multitenant_aliased_namespace_refused(tmp_path):
    store, graph, data = _scattered_store()
    mts = MultiTenantServer(store, threads=False,
                            quotas={"a": TenantQuota()})
    rogue = BatchedCheckoutServer(store, use_kernel=False, tenant="a")
    dur = StoreDurability(str(tmp_path / "d"))
    with pytest.raises(ValueError, match="namespace"):
        dur.snapshot(store, server=rogue, servers=mts)
    mts.close()


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "host"])
def test_multitenant_watermarks_journaled_on_grant(tmp_path, use_kernel):
    """Granted waves advance the per-tenant watermark records in the
    journal: a restore AFTER the snapshot still seeds past every ticket
    the dead coordinator acknowledged."""
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    mts = MultiTenantServer(store, threads=False, use_kernel=use_kernel,
                            quotas={"a": TenantQuota(),
                                    "b": TenantQuota()})
    dur.snapshot(store, servers=mts)             # journal attached HERE
    mts.submit_many("a", [0, 1])
    mts.submit("b", 2)
    mts.pump()                                   # grant -> server flush
    mts.close()
    dur.journal.flush(sync=False)
    recs, bad = read_records(dur.journal.path)
    assert bad is None
    assert {r.payload["tenant"] for r in recs if r.kind == "ticket"} \
        == {"a", "b"}
    rs = _restore(tmp_path / "d")
    assert rs.ticket_watermarks.get("a", 0) >= 2
    assert rs.ticket_watermarks.get("b", 0) >= 1
