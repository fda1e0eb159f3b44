"""The port's write-ahead journal (``repro_torch.core.journal``) on CPU
stores, case for case with the JAX package's journal suite: framing and
checksum units, append repair, the single-fault sweep over the five
journal/disk sites, the kill between any two records and a bitflip mid
journal.  Then the two packages against each other: one seeded stream of
commits, a ``commit_many`` wave, a migration, a regroup, a repartition and
tickets writes byte-identical journal files in both, and either package's
journal replays into the other's store restored from the same snapshot."""
import contextlib
import filecmp
import os
import shutil

import numpy as np
import pytest

import repro.core.durability as rdur
import repro.core.journal as rjournal
import repro.core.partition as rpart
import repro.serve.checkout as rsc
from repro.core.checkout import get_superblock_groups as ref_groups
from repro.core.graph import BipartiteGraph as RefGraph
from repro_torch.core.checkout import (estimate_superblock_bytes,
                                       get_superblock_groups)
from repro_torch.core.durability import (StoreDurability,
                                         snapshot_roundtrip_equal)
from repro_torch.core.faults import FaultPlan, GuardedCounter, InjectedFault
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.journal import (Journal, _dec, _enc, attach_journal,
                                      get_journal, read_records, replay_into)
from repro_torch.core.partition import PartitionedCVD, plan_migration
from repro_torch.serve.checkout import BatchedCheckoutServer

SEED = int(os.environ.get("REPRO_FAULT_SEED", "0"))

JOURNAL_SITES = ("journal.append", "journal.fsync", "journal.replay",
                 "disk.torn_write", "disk.bitflip")

WAVES = ([0, 3, 7, 11], [1, 4, 8], [2, 5, 9, 11], [0, 6, 10], [3, 7, 1])


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
    return store, graph, data


def _ref_store(**kw):
    rls, data = _arrays(**kw)
    graph = RefGraph.from_rlists(rls, n_records=len(data))
    return rpart.PartitionedCVD(graph, data, np.zeros(len(rls), np.int64))


def _retry(fn):
    """The single-fault recovery contract: an injected fault surfaces to
    the caller with nothing mutated — one bare retry must succeed."""
    try:
        return fn()
    except InjectedFault:
        return fn()


def _state(store):
    return (int(store.epoch), store.graph.indptr.copy(),
            store.graph.indices.copy(), store.assignment.copy(),
            np.asarray(store.data).copy())


def _state_equal(s, store):
    epoch, indptr, indices, assignment, data = s
    return (int(store.epoch) == epoch
            and np.array_equal(store.graph.indptr, indptr)
            and np.array_equal(store.graph.indices, indices)
            and np.array_equal(store.assignment, assignment)
            and np.array_equal(np.asarray(store.data), data))


# ------------------------------------------------------------- unit layer --
def test_frame_roundtrip_and_seq(tmp_path):
    p = str(tmp_path / "j.wal")
    j = Journal(p)
    arr = np.arange(12, dtype=np.int64).reshape(3, 4)
    assert j.append("commit", {"vid": 7, "rlist": _enc(arr)}) == 0
    assert j.append("ticket", {"tenant": "a", "watermark": 3},
                    sync=False) == 1
    j.close()
    recs, bad = read_records(p)
    assert bad is None
    assert [(r.kind, r.seq) for r in recs] == [("commit", 0), ("ticket", 1)]
    np.testing.assert_array_equal(_dec(recs[0].payload["rlist"]), arr)
    # a reopened journal continues the seq where the file left off
    j2 = Journal(p)
    assert j2.append("ticket", {"tenant": "a", "watermark": 5}) == 2
    j2.close()
    # the frames are the JAX package's: its reader decodes the same
    # records from the port's file, and its writer makes the same bytes
    want, bad = rjournal.read_records(p)
    assert bad is None
    assert [(r.kind, r.seq, r.offset, r.end) for r in want] == \
        [(r.kind, r.seq, r.offset, r.end) for r in read_records(p)[0]]
    q = str(tmp_path / "ref.wal")
    rj = rjournal.Journal(q)
    rj.append("commit", {"vid": 7, "rlist": rjournal._enc(arr)})
    rj.append("ticket", {"tenant": "a", "watermark": 3}, sync=False)
    rj.append("ticket", {"tenant": "a", "watermark": 5})
    rj.close()
    assert filecmp.cmp(p, q, shallow=False)


@pytest.mark.parametrize("damage", ["bitflip", "torn", "garbage"])
def test_read_stops_at_first_bad_record(tmp_path, damage):
    p = str(tmp_path / "j.wal")
    j = Journal(p)
    for i in range(3):
        j.append("ticket", {"tenant": "t", "watermark": i})
    j.close()
    recs, _ = read_records(p)
    assert len(recs) == 3
    with open(p, "r+b") as f:
        if damage == "bitflip":                 # flip a payload byte of #1
            f.seek(recs[1].end - 1)
            b = f.read(1)
            f.seek(recs[1].end - 1)
            f.write(bytes([b[0] ^ 0x10]))
        elif damage == "torn":                  # record #1 half-written
            f.truncate(recs[1].offset + 5)
        else:                                   # garbage tail after #2
            f.seek(0, os.SEEK_END)
            f.write(b"\x00garbage\xff")
    got, bad = read_records(p)
    want = 3 if damage == "garbage" else 1
    assert len(got) == want
    assert bad == (recs[want - 1].end if damage == "garbage"
                   else recs[1].offset)
    # recover() truncates the tail and the journal is appendable again
    jr = Journal(p)
    kept = jr.recover()
    assert len(kept) == want
    assert os.path.getsize(p) == (recs[want - 1].end)
    assert jr.append("ticket", {"tenant": "t", "watermark": 9}) == want
    jr.close()
    final, bad2 = read_records(p)
    assert bad2 is None and [r.seq for r in final] == list(range(want + 1))


@pytest.mark.parametrize("site", ["journal.append", "journal.fsync",
                                  "disk.torn_write", "disk.bitflip"])
def test_append_fault_repairs_file_and_retry_is_clean(tmp_path, site):
    """ANY append failure — before the write, mid-frame (torn), with a
    damaged frame (bitflip), or at the fsync — truncates the file back to
    its pre-append length, so a bare retry never duplicates a record."""
    p = str(tmp_path / "j.wal")
    j = Journal(p)
    j.append("ticket", {"tenant": "t", "watermark": 1})
    size0 = os.path.getsize(p)
    with FaultPlan.single(site).armed():
        with pytest.raises(InjectedFault):
            j.append("commit", {"vid": 1})
    assert os.path.getsize(p) == size0            # damage truncated away
    # journal.append fires before any byte is written — nothing to repair
    assert j.repairs == (0 if site == "journal.append" else 1)
    assert j.append("commit", {"vid": 1}) == 1    # bare retry, same seq
    j.close()
    recs, bad = read_records(p)
    assert bad is None
    assert [(r.kind, r.seq) for r in recs] == [("ticket", 0), ("commit", 1)]


def test_advisory_append_absorbs_faults(tmp_path):
    j = Journal(str(tmp_path / "j.wal"))
    with FaultPlan.single("journal.append").armed():
        assert j.append_advisory("ticket",
                                 {"tenant": "t", "watermark": 1}) is False
    assert j.dropped == 1
    assert j.append_advisory("ticket",
                             {"tenant": "t", "watermark": 2}) is True
    j.close()


def test_replay_refuses_attached_journal(tmp_path):
    store, *_ = _scattered_store()
    j = Journal(str(tmp_path / "j.wal"))
    attach_journal(store, j)
    with pytest.raises(RuntimeError, match="re-journal"):
        replay_into(store, [])
    attach_journal(store, None)
    assert get_journal(store) is None
    j.close()


def test_replay_is_idempotent(tmp_path):
    """Replaying the same records twice applies once: every state-changing
    record carries the epoch/vid it produces."""
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    dur.snapshot(store)
    rng = np.random.default_rng(3)
    new = rng.integers(0, 1 << 20, (4, 8)).astype(np.int32)
    rl = np.concatenate([graph.rlist(2),
                         np.arange(graph.n_records, graph.n_records + 4)])
    store.commit_version(rl, parent=2, new_rows=new)
    store.apply_migration(
        plan_migration(store, np.arange(store.graph.n_versions) % 3))
    dur.journal.flush(sync=False)
    recs, bad = read_records(dur.journal.path)
    assert bad is None
    fresh = dur.restore(replay=False, device="cpu").store
    out1 = replay_into(fresh, recs)
    assert out1["applied"] >= 2
    assert snapshot_roundtrip_equal(fresh, store)
    out2 = replay_into(fresh, recs)
    assert out2["applied"] == len([r for r in recs if r.kind == "ticket"])
    assert snapshot_roundtrip_equal(fresh, store)


def test_payloads_hold_no_tensors(tmp_path):
    """Every value a journaled mutation writes is a Python scalar, list,
    bytes or an ``_enc`` dict — never a torch tensor, which would tie the
    file to torch and to a device."""
    import torch
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    dur.snapshot(store)
    store.commit_many([{"rlist": graph.rlist(1), "parent": 1},
                       {"table": data[graph.rlist(2)], "parent": 2}])
    store.apply_migration(
        plan_migration(store, np.arange(store.graph.n_versions) % 2))
    dur.journal.flush(sync=False)
    recs, bad = read_records(dur.journal.path)
    assert bad is None and len(recs) == 3

    def walk(v):
        assert not isinstance(v, (torch.Tensor, np.ndarray, np.generic)), \
            type(v)
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, list):
            for x in v:
                walk(x)
        else:
            assert v is None or isinstance(v, (int, float, str, bytes))

    for r in recs:
        walk(r.payload)


# ----------------------------------------------------- single-fault sweep --
def _journaled_stream(root, plan=None):
    """One deterministic mutation stream under a journal: 5 served waves
    interleaved with two commits, a staged migration and a regroup —
    every journaled record kind fires at least once."""
    store, graph, data = _scattered_store()
    store.repartition(np.arange(graph.n_versions) % 4)
    store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    dur = StoreDurability(str(root))
    srv = BatchedCheckoutServer(store, use_kernel=True, tenant="t0")
    dur.snapshot(store, server=srv)
    rng = np.random.default_rng(11)
    outs = []
    ctx = plan.armed() if plan is not None else contextlib.nullcontext()
    with ctx:
        for i, vids in enumerate(WAVES):
            outs.append([np.asarray(m) for m in srv.serve(vids)])
            if i in (1, 3):
                k = store.graph.n_records
                new = rng.integers(0, 1 << 20, (4, 8)).astype(np.int32)
                rl = np.concatenate([store.graph.rlist(i),
                                     np.arange(k, k + 4)])
                _retry(lambda: store.commit_version(rl, parent=i,
                                                    new_rows=new))
        _retry(lambda: store.apply_migration(
            plan_migration(store, np.arange(store.graph.n_versions) % 3)))
        mgr = get_superblock_groups(store)
        if mgr is not None:
            _retry(mgr.regroup)
        outs.append([np.asarray(m) for m in srv.serve([0, 5, 12])])
        srv.close()
        rs = _retry(lambda: StoreDurability(str(root)).restore(
            device="cpu"))
    return dur, srv, store, outs, rs


@pytest.fixture(scope="module")
def journal_oracle(tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle") / "d"
    dur, srv, store, outs, rs = _journaled_stream(root)
    return store, outs


# nth picks WHICH hit of the site fires: 0 lands on the first advisory
# (ticket) append, 2 on the first version-commit append, 8 on the
# migration-commit append
@pytest.mark.parametrize("nth", [0, 2, 8])
@pytest.mark.parametrize("site", JOURNAL_SITES)
def test_single_fault_sweep_bit_identical(tmp_path, site, nth,
                                          journal_oracle):
    """A single injected fault at every journal/disk site: the delivered
    stream and the post-kill restored store are bit-identical to the
    fault-free oracle, with balanced group counters and zero leaked
    in-flight waves."""
    o_store, o_outs = journal_oracle
    plan = FaultPlan.single(site, nth=nth)
    dur, srv, store, outs, rs = _journaled_stream(tmp_path / "d", plan)
    assert len(outs) == len(o_outs)
    for a, b in zip(outs, o_outs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert snapshot_roundtrip_equal(store, o_store)
    assert snapshot_roundtrip_equal(rs.store, store)
    assert rs.ticket_watermarks.get("t0", 0) == srv._next_ticket
    assert int(getattr(store, "_inflight_waves", 0) or 0) == 0
    cnt = getattr(store, "_inflight_waves", None)
    if isinstance(cnt, GuardedCounter):
        assert cnt.underflows == 0
    assert srv._reserved == set()
    for s in (store, rs.store):
        mgr = get_superblock_groups(s)
        if mgr is not None:
            assert mgr.pins - mgr.evictions == len(mgr.groups)


def test_seeded_plan_journal_sites(tmp_path):
    plan = FaultPlan.seeded(SEED, sites=JOURNAL_SITES)
    dur, srv, store, outs, rs = _journaled_stream(tmp_path / "d", plan)
    assert snapshot_roundtrip_equal(rs.store, store)
    assert rs.ticket_watermarks.get("t0", 0) == srv._next_ticket


# ------------------------------------------------------- kill crash matrix --
def test_kill_between_any_two_journal_records(tmp_path):
    """Truncate the journal at EVERY record boundary (and tear the next
    frame) and restore: each cut recovers exactly the prefix of
    acknowledged operations — an intent without its commit restores the
    pre-migration state, never a half-migrated one."""
    store, graph, data = _scattered_store()
    src = tmp_path / "d"
    dur = StoreDurability(str(src))
    srv = BatchedCheckoutServer(store, use_kernel=False, tenant="t0")
    dur.snapshot(store, server=srv)

    marks = []          # (records on disk so far, state they produce)

    def mark():
        dur.journal.flush(sync=False)
        recs, bad = read_records(dur.journal.path)
        assert bad is None
        marks.append((len(recs), _state(store)))

    mark()
    srv.serve([0, 1, 2])
    mark()
    rng = np.random.default_rng(5)
    k = graph.n_records
    store.commit_version(
        np.concatenate([graph.rlist(1), np.arange(k, k + 3)]), parent=1,
        new_rows=rng.integers(0, 99, (3, 8)).astype(np.int32))
    mark()
    store.apply_migration(
        plan_migration(store, np.arange(store.graph.n_versions) % 3))
    mark()
    store.commit_version(graph.rlist(4), parent=4)
    mark()
    srv.serve([3, 4])
    srv.close()
    mark()

    recs, bad = read_records(dur.journal.path)
    assert bad is None
    assert {r.kind for r in recs} >= {"ticket", "commit",
                                      "migration.intent",
                                      "migration.commit"}
    boundaries = [0] + [r.end for r in recs]

    def check_cut(tag, cut, n_records):
        work = tmp_path / tag
        shutil.copytree(src, work)
        with open(work / os.path.basename(dur.journal.path), "r+b") as f:
            f.truncate(cut)
        rs = StoreDurability(str(work)).restore(device="cpu")
        expected = [s for c, s in marks if c <= n_records][-1]
        assert _state_equal(expected, rs.store), \
            f"cut at {tag} restored the wrong prefix"

    for i, b in enumerate(boundaries):
        check_cut(f"cut{i}", b, i)
        if i < len(recs):
            check_cut(f"tear{i}", b + 5, i)


def test_bitflip_mid_journal_restores_prefix(tmp_path):
    store, graph, data = _scattered_store()
    src = tmp_path / "d"
    dur = StoreDurability(str(src))
    dur.snapshot(store)
    s0 = _state(store)
    store.commit_version(graph.rlist(0), parent=0)
    s1 = _state(store)
    store.commit_version(graph.rlist(2), parent=2)
    recs, _ = read_records(dur.journal.path)
    assert [r.kind for r in recs] == ["commit", "commit"]
    with open(dur.journal.path, "r+b") as f:
        f.seek(recs[1].offset + 12)
        b = f.read(1)
        f.seek(recs[1].offset + 12)
        f.write(bytes([b[0] ^ 0x01]))
    scrubbed = StoreDurability(str(src)).scrub()
    assert not scrubbed["clean"]          # detection BEFORE restore heals
    rs = StoreDurability(str(src)).restore(device="cpu")
    assert _state_equal(s1, rs.store) and not _state_equal(s0, rs.store)


def test_restored_store_keeps_journaling(tmp_path):
    store, graph, data = _scattered_store()
    n0 = graph.n_versions
    dur = StoreDurability(str(tmp_path / "d"))
    dur.snapshot(store)
    store.commit_version(graph.rlist(1), parent=1)
    rs = StoreDurability(str(tmp_path / "d")).restore(device="cpu")
    assert get_journal(rs.store) is not None
    rs.store.commit_version(graph.rlist(3), parent=3)
    rs2 = StoreDurability(str(tmp_path / "d")).restore(device="cpu")
    assert snapshot_roundtrip_equal(rs2.store, rs.store)
    assert rs2.store.graph.n_versions == n0 + 2


def test_commit_many_wave_pays_one_fsync(tmp_path):
    """A ``commit_many`` wave is ONE ``commit.batch`` record under ONE
    fsync; a failed fsync leaves neither the store nor the journal with a
    trace of the wave."""
    store, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    dur.snapshot(store)
    j = dur.journal
    wave = [{"rlist": graph.rlist(v), "parent": v} for v in (1, 2, 3)]
    before = _state(store)
    size0 = os.path.getsize(j.path)
    with FaultPlan.single("journal.fsync").armed():
        with pytest.raises(InjectedFault):
            store.commit_many(wave)
    assert _state_equal(before, store)
    assert os.path.getsize(j.path) == size0 and j.repairs == 1
    synced = j.synced
    assert store.commit_many(wave) == [12, 13, 14]
    assert j.synced == synced + 1
    recs, bad = read_records(j.path)
    assert bad is None and [r.kind for r in recs] == ["commit.batch"]
    assert recs[0].payload["vid0"] == 12
    assert len(recs[0].payload["commits"]) == 3


# ------------------------------------------------------- the two packages --
def _twin_stream(pkg, root):
    """The same seeded mutation stream through one package: served waves
    (ticket records), two commits, a ``commit_many`` wave, a migration, a
    regroup and a repartition, all under a journal.  The port runs its
    kernels' plain versions, the JAX package its Pallas kernels in
    interpret mode."""
    if pkg == "port":
        store, graph, data = _scattered_store()
        D, S, migrate, groups = (StoreDurability, BatchedCheckoutServer,
                                 plan_migration, get_superblock_groups)
    else:
        store = _ref_store()
        D, S, migrate, groups = (rdur.StoreDurability,
                                 rsc.BatchedCheckoutServer,
                                 rpart.plan_migration, ref_groups)
    store.repartition(np.arange(store.graph.n_versions) % 4)
    store.superblock_max_bytes = 49152
    dur = D(str(root))
    srv = S(store, use_kernel=True, tenant="t0")
    dur.snapshot(store, server=srv)
    rng = np.random.default_rng(11)
    outs = []
    for i, vids in enumerate(WAVES[:3]):
        outs.append([np.asarray(m) for m in srv.serve(vids)])
        k = store.graph.n_records
        new = rng.integers(0, 1 << 20, (4, 8)).astype(np.int32)
        rl = np.concatenate([store.graph.rlist(i), np.arange(k, k + 4)])
        store.commit_version(rl, parent=i, new_rows=new)
    g = store.graph
    store.commit_many([
        {"rlist": g.rlist(2), "parent": 2},
        {"table": np.concatenate([np.asarray(store.data)[g.rlist(3)],
                                  rng.integers(0, 99, (2, 8))
                                  .astype(np.int32)]), "parent": 3}])
    store.apply_migration(migrate(store, np.arange(g.n_versions) % 3))
    groups(store).regroup()
    store.repartition(np.arange(store.graph.n_versions) % 2)
    outs.append([np.asarray(m) for m in srv.serve([0, 5, 12, 16])])
    srv.close()
    dur.journal.close()
    return store, outs


def test_journal_files_byte_identical_across_packages(tmp_path):
    """One operation stream through both packages with journals attached
    writes the same journal file, byte for byte, and the same manifest;
    the stores and every served ticket agree."""
    ps, po = _twin_stream("port", tmp_path / "port")
    rs, ro = _twin_stream("ref", tmp_path / "ref")
    for a, b in zip(po, ro):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert snapshot_roundtrip_equal(ps, rs)
    name = "journal-0.wal"
    recs, bad = read_records(str(tmp_path / "port" / name))
    assert bad is None
    assert {r.kind for r in recs} == {
        "ticket", "commit", "commit.batch", "migration.intent",
        "migration.commit", "regroup", "repartition"}
    assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "ref" / name,
                       shallow=False)
    assert filecmp.cmp(tmp_path / "port" / "manifest.json",
                       tmp_path / "ref" / "manifest.json", shallow=False)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_replays_into_the_other_package(tmp_path, writer):
    """A journal written by one package replays into the OTHER package's
    store restored from the same snapshot state: every version's checkout
    is identical to the writer's live store."""
    live, _ = _twin_stream(writer, tmp_path / "w")
    recs, bad = (read_records if writer == "port" else
                 rjournal.read_records)(str(tmp_path / "w" /
                                            "journal-0.wal"))
    assert bad is None
    # the snapshot's state, rebuilt in the other package: the seeded
    # store, its partitioning and its group layer's budget
    if writer == "port":
        fresh, groups, replay = _ref_store(), ref_groups, \
            rjournal.replay_into
    else:
        fresh, groups, replay = _scattered_store()[0], \
            get_superblock_groups, replay_into
    fresh.repartition(np.arange(fresh.graph.n_versions) % 4)
    fresh.superblock_max_bytes = 49152
    groups(fresh, budget=49152, create=True)
    out = replay(fresh, recs)
    assert out["skipped"] == 1                 # the migration intent
    assert out["applied"] == len(recs) - 1
    assert out["ticket_watermarks"] == {"t0": 15}
    assert snapshot_roundtrip_equal(fresh, live)
    for v in range(live.graph.n_versions):
        np.testing.assert_array_equal(fresh.checkout(v), live.checkout(v))
