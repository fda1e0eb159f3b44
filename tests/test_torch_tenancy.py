"""The port's multi-tenant serve coordinator (``repro_torch.serve.tenancy``)
on CPU stores, case for case with the JAX package's tenancy suites:
admission control and explicit shedding, deficit-round-robin fairness
(grant-log audited), pinned-byte share throttling, epoch-consistent reads
under a concurrent migration, threaded 4-tenant bit-identity, the
single-fault sweep over every catalogued site, and the property suite over
random tenant mixes.  Then the two packages against each other: one
stream through ``MultiTenantServer(threads=False)`` in both gives the same
grant log, sheds and per-tenant tickets; and journaled write waves through
the coordinator pay one fsync a wave."""
import contextlib
import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core.graph as rgraph
import repro.core.partition as rpart
import repro.serve.tenancy as rtenancy
from repro.core.online import RepartitionTrigger as RefTrigger
from repro.core.version_graph import WeightedTree as RefTree
from repro_torch.core.checkout import (estimate_superblock_bytes,
                                       get_superblock_groups)
from repro_torch.core.durability import StoreDurability
from repro_torch.core.faults import (SITES, FaultPlan, GuardedCounter,
                                     InjectedFault, read_leases)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.journal import read_records
from repro_torch.core.online import RepartitionTrigger
from repro_torch.core.partition import PartitionedCVD
from repro_torch.core.version_graph import WeightedTree
from repro_torch.serve import (MultiTenantServer, Overloaded, QuotaExceeded,
                               TenantQuota, jain_index)
from repro_torch.serve.checkout import BatchedCheckoutServer, RetryPolicy

NEW_SITES = ("serve.admit", "serve.shed", "tenant.preempt", "lease.expire")


def _arrays(seed=7, n_versions=12, n_records=512, size=24, n_attrs=8):
    rng = np.random.default_rng(seed)
    rls = [np.sort(rng.choice(n_records, size,
                              replace=False)).astype(np.int64)
           for _ in range(n_versions)]
    data = rng.integers(0, 1 << 20, (n_records, n_attrs)).astype(np.int32)
    return rls, data


def _scattered_store(**kw):
    """Scattered rlists trip the density trigger mid-stream, so one run
    exercises dispatch, delivery, migration and the group layer under
    multi-tenant contention."""
    rls, data = _arrays(**kw)
    graph = BipartiteGraph.from_rlists(rls, n_records=len(data))
    store = PartitionedCVD(graph, data, np.zeros(len(rls), np.int64),
                           device="cpu")
    tree = WeightedTree(
        parent=np.concatenate([[-1], np.zeros(len(rls) - 1, np.int64)]),
        n_records=np.array([len(r) for r in rls], np.int64),
        edge_w=np.zeros(len(rls), np.int64))
    return store, tree, graph, data


# the canonical 3-tenant contention stream (phase-barrier submits, tenant
# c over-subscribed: its phase-2 tail sheds Overloaded and its phase-3
# tail QuotaExceeded)
TENANTS = {
    "a": TenantQuota(wave_share=2.0, max_wave=2),
    "b": TenantQuota(wave_share=1.0, max_wave=3),
    "c": TenantQuota(max_inflight=3, max_wave=2),
}
MAX_BACKLOG = 9
PHASES = (
    {"a": [0, 3, 7, 11], "b": [1, 4, 8], "c": [2, 5]},
    {"a": [6, 10, 0, 2, 9], "b": [11, 3], "c": [7, 1, 4, 8]},
    {"a": [5, 8], "b": [6, 9, 10], "c": [0, 11, 5, 9]},
)
EXPECT_ADMIT = {
    "a": [[0, 3, 7, 11], [6, 10, 0, 2, 9], [5, 8]],
    "b": [[1, 4, 8], [11, 3], [6, 9, 10]],
    "c": [[2, 5], [7, 1], [0, 11, 5]],
}
EXPECT_SHEDS = [("c", 4, "Overloaded"), ("c", 8, "Overloaded"),
                ("c", 9, "QuotaExceeded")]


def _drive(mts, shed=(QuotaExceeded, Overloaded)):
    delivered = {t: [] for t in TENANTS}
    sheds = []
    for phase in PHASES:
        tickets = {t: [] for t in TENANTS}
        for tid, vids in phase.items():
            for v in vids:
                try:
                    tickets[tid].append(mts.submit(tid, v))
                except shed as e:
                    sheds.append((tid, v, type(e).__name__))
        for tid, tks in tickets.items():
            for tk in tks:
                delivered[tid].append(np.asarray(mts.result(tid, tk)))
    mts.close()
    return delivered, sheds


def _run_tenant_stream(*, plan=None, retry=None, use_kernel=True):
    """The full multi-tenant serve run: budget-limited scattered store,
    coordinator-owned drain-mode trigger, inline scheduling."""
    store, tree, graph, data = _scattered_store()
    store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    trig = RepartitionTrigger(store, tree, min_waves=2,
                              use_kernel=use_kernel, drain_timeout_s=5.0)
    mts = MultiTenantServer(store, threads=False, quotas=TENANTS,
                            max_backlog=MAX_BACKLOG, retry=retry,
                            trigger=trig, use_kernel=use_kernel)
    ctx = plan.armed() if plan is not None else contextlib.nullcontext()
    with ctx:
        delivered, sheds = _drive(mts)
    return mts, store, delivered, sheds


def _serial_oracle(use_kernel=True):
    """Each tenant's fault-free SERIAL run through a lone single-tenant
    server on a fresh identical store."""
    out = {}
    for tid in TENANTS:
        store, tree, graph, data = _scattered_store()
        store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
        srv = BatchedCheckoutServer(store, use_kernel=use_kernel)
        outs = []
        for phase_vids in EXPECT_ADMIT[tid]:
            outs.extend(np.asarray(m) for m in srv.serve(phase_vids))
        srv.close()
        out[tid] = outs
    return out


def _assert_balanced(mts, store):
    acct = mts.accounting()
    assert acct["backlog"] == 0
    assert acct["leases_held"] == 0
    for tid, t in acct["tenants"].items():
        assert t["queued"] == 0, (tid, t)
        assert t["inflight"] == 0, (tid, t)
        assert t["reserved"] == 0, (tid, t)
    cnt = getattr(store, "_inflight_waves", None)
    assert int(cnt or 0) == 0
    if isinstance(cnt, GuardedCounter):
        assert cnt.underflows == 0
    reg = read_leases(store, create=False)
    assert reg is not None and reg.held() == 0
    mgr = get_superblock_groups(store)
    if mgr is not None:
        assert mgr.pins - mgr.evictions == len(mgr.groups)
        assert mgr.pinned_bytes <= mgr.budget


# ------------------------------------------------------------- validation --
def test_quota_and_registration_validation():
    store, *_ = _scattered_store()
    with pytest.raises(ValueError, match="max_inflight"):
        TenantQuota(max_inflight=0)
    with pytest.raises(ValueError, match="wave_share"):
        TenantQuota(wave_share=0)
    with pytest.raises(ValueError, match="pinned_share"):
        TenantQuota(pinned_share=1.5)
    with pytest.raises(ValueError, match="max_wave"):
        TenantQuota(max_wave=0)
    with pytest.raises(ValueError, match="max_backlog"):
        MultiTenantServer(store, max_backlog=0)
    mts = MultiTenantServer(store, threads=False, quotas={"a": None})
    with pytest.raises(ValueError, match="already registered"):
        mts.register("a")
    with pytest.raises(KeyError):
        mts.submit("ghost", 0)
    with pytest.raises(ValueError, match="unknown version"):
        mts.submit("a", 99)
    mts.close()
    with pytest.raises(RuntimeError, match="closed"):
        mts.submit("a", 0)


# ----------------------------------------------- inline stream bit-identity --
@pytest.fixture(scope="module")
def serial_oracle():
    return _serial_oracle()


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "host"])
def test_inline_stream_bit_identical_to_serial_runs(serial_oracle,
                                                    use_kernel):
    """Every tenant's delivered stream through the shared coordinator is
    bit-identical to its own serial single-server run, sheds land exactly
    where admission state says, and the books balance after close()."""
    mts, store, delivered, sheds = _run_tenant_stream(use_kernel=use_kernel)
    assert sheds == EXPECT_SHEDS
    for tid, outs in delivered.items():
        want = serial_oracle[tid]
        assert len(outs) == len(want) == sum(
            len(p) for p in EXPECT_ADMIT[tid])
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g, w)
    assert mts.peak_backlog <= MAX_BACKLOG
    sa, sb, sc = (mts.stats(t) for t in ("a", "b", "c"))
    assert sa.submitted == 11 and sa.delivered == 11 and sa.failed == 0
    assert sb.submitted == 8 and sb.delivered == 8
    assert sc.submitted == 7 and sc.delivered == 7
    assert sc.shed_overload == 2 and sc.shed_quota == 1
    assert sa.preempts > 0
    assert mts.repartitions >= 1 and store.epoch >= 1
    _assert_balanced(mts, store)


# -------------------------------------------------------------- fair share --
def test_drr_weighted_grant_log():
    store, *_ = _scattered_store()
    mts = MultiTenantServer(
        store, threads=False,
        quotas={"a": TenantQuota(wave_share=2.0, max_wave=2),
                "b": TenantQuota(wave_share=1.0, max_wave=2)})
    for v in range(12):
        mts.submit("a", v % 12)
        mts.submit("b", (v + 5) % 12)
    mts.pump()
    assert mts.grant_log == ["a", "a", "b"] * 3 + ["b"] * 3
    mts.close()
    _assert_balanced(mts, store)


def test_drr_equal_share_bounded_wait():
    store, *_ = _scattered_store()
    ids = ("a", "b", "c")
    mts = MultiTenantServer(
        store, threads=False,
        quotas={t: TenantQuota(max_wave=1) for t in ids})
    for v in range(4):
        for t in ids:
            mts.submit(t, v)
    mts.pump()
    assert mts.grant_log == list(ids) * 4
    for t in ids:
        idx = [i for i, g in enumerate(mts.grant_log) if g == t]
        assert max(b - a for a, b in zip(idx, idx[1:])) <= len(ids)
    mts.close()
    assert jain_index([mts.stats(t).delivered for t in ids]) == 1.0


def test_idle_tenant_does_not_hoard_deficit():
    store, *_ = _scattered_store()
    mts = MultiTenantServer(
        store, threads=False,
        quotas={"busy": TenantQuota(max_wave=1),
                "idle": TenantQuota(max_wave=1)})
    for v in range(6):
        mts.submit("busy", v)
    mts.pump()
    for v in range(4):
        mts.submit("idle", v)
        mts.submit("busy", v + 6)
    mts.pump()
    tail = mts.grant_log[6:]
    assert tail.count("idle") == 4
    assert max(tail.count("idle") - tail.count("busy"), 0) <= 1
    mts.close()


# ------------------------------------------------------- pinned-byte share --
def test_pinned_share_throttles_to_perpart_bit_identically():
    store, tree, graph, data = _scattered_store()
    store.repartition(np.arange(graph.n_versions) % 4)
    store.superblock_max_bytes = 3 * estimate_superblock_bytes(store) // 4
    hog_vids, norm_vids = [0, 4, 8], [1, 5, 9]         # pids {0} vs {1}
    mts = MultiTenantServer(
        store, threads=False, use_kernel=True,
        quotas={"hog": TenantQuota(pinned_share=0.05, max_wave=4),
                "norm": TenantQuota(max_wave=4)})
    for rnd in range(3):
        th = mts.submit_many("hog", hog_vids)
        tn = mts.submit_many("norm", norm_vids)
        for v, m in zip(hog_vids, mts.results("hog", th)):
            np.testing.assert_array_equal(np.asarray(m),
                                          data[graph.rlist(v)])
        for v, m in zip(norm_vids, mts.results("norm", tn)):
            np.testing.assert_array_equal(np.asarray(m),
                                          data[graph.rlist(v)])
    assert mts.stats("hog").pin_throttled_waves >= 1
    assert mts.stats("norm").pin_throttled_waves == 0
    acct = mts.accounting()
    assert acct["owned_pin_bytes"] <= acct["pinned_bytes"]
    mts.close()
    _assert_balanced(mts, store)


# ----------------------------------------------------------- threaded mode --
def test_threaded_four_tenants_bit_identical_and_balanced():
    """4 tenants on worker threads over one store: every delivered array
    matches the checkout oracle and the ``threads=False`` run, and the
    books balance after close()."""
    ids = ("a", "b", "c", "d")
    vids = {t: [(i + 3 * k) % 12 for i in range(9)]
            for k, t in enumerate(ids)}
    runs = {}
    for threads in (True, False):
        store, tree, graph, data = _scattered_store()
        store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
        mts = MultiTenantServer(
            store, threads=threads,
            quotas={t: TenantQuota(max_wave=3) for t in ids})
        tks = {t: mts.submit_many(t, vids[t]) for t in ids}
        runs[threads] = {t: [np.asarray(m) for m in
                             mts.results(t, tks[t], timeout=120)]
                         for t in ids}
        assert mts.drain(timeout=60)
        mts.close()
        for t in ids:
            assert mts.stats(t).delivered == 9
            for v, m in zip(vids[t], runs[threads][t]):
                np.testing.assert_array_equal(m, data[graph.rlist(v)])
        assert jain_index([mts.stats(t).delivered for t in ids]) == 1.0
        _assert_balanced(mts, store)
    for t in ids:
        for a, b in zip(runs[True][t], runs[False][t]):
            np.testing.assert_array_equal(a, b)


def test_threaded_stress_short_switch_interval_balances():
    """More tenant threads than cores, the interpreter switching threads
    every 10 µs: every ticket delivers exactly once, right, and the books
    (backlog, inflight, leases, the guarded in-flight counter) balance —
    a lost update under ``_lock``/``_store_lock`` would break one."""
    store, tree, graph, data = _scattered_store()
    store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    ids = [f"t{k}" for k in range(max(8, 2 * (os.cpu_count() or 1)))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        mts = MultiTenantServer(
            store, threads=True, max_backlog=16 * len(ids),
            quotas={t: TenantQuota(max_wave=2) for t in ids})
        vids = {t: [(3 * k + i) % 12 for i in range(8)]
                for k, t in enumerate(ids)}
        tks = {t: mts.submit_many(t, vids[t]) for t in ids}
        for t in ids:
            for v, m in zip(vids[t], mts.results(t, tks[t], timeout=120)):
                np.testing.assert_array_equal(np.asarray(m),
                                              data[graph.rlist(v)])
        assert mts.drain(timeout=60)
        mts.close()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(mts.grant_log) == sorted(
        t for t in ids for _ in range(4))
    for t in ids:
        s = mts.stats(t)
        assert (s.submitted, s.delivered, s.failed) == (8, 8, 0)
    assert mts.scheduler_errors == 0
    _assert_balanced(mts, store)
    assert read_leases(store, create=False).acquired == \
        read_leases(store, create=False).released


def test_threaded_migration_under_contention_drains_leases():
    store, tree, graph, data = _scattered_store()
    trig = RepartitionTrigger(store, tree, min_waves=2, use_kernel=False,
                              drain_timeout_s=5.0)
    mts = MultiTenantServer(
        store, threads=True, trigger=trig, use_kernel=False,
        quotas={"a": TenantQuota(max_wave=4),
                "b": TenantQuota(max_wave=4)})
    for rnd in range(10):
        ta = mts.submit_many("a", [0, 3, 7, 11])
        tb = mts.submit_many("b", [1, 4, 8, 2])
        for v, m in zip([0, 3, 7, 11], mts.results("a", ta, timeout=120)):
            np.testing.assert_array_equal(np.asarray(m),
                                          data[graph.rlist(v)])
        for v, m in zip([1, 4, 8, 2], mts.results("b", tb, timeout=120)):
            np.testing.assert_array_equal(np.asarray(m),
                                          data[graph.rlist(v)])
        if mts.repartitions:
            break
    assert mts.repartitions >= 1 and store.epoch >= 1
    reg = read_leases(store, create=False)
    assert reg.drains >= 1
    mts.close()
    _assert_balanced(mts, store)


def test_close_errors_undelivered_tickets_and_balances():
    store, *_ = _scattered_store()
    mts = MultiTenantServer(store, threads=False, quotas={"a": None})
    tks = mts.submit_many("a", [0, 1, 2])
    mts.close(drain=False)
    for tk in tks:
        with pytest.raises(RuntimeError, match="closed"):
            mts.result("a", tk)
    assert mts.stats("a").failed == 3
    _assert_balanced(mts, store)
    mts.close()                        # idempotent


# ------------------------------------------------- single-fault recovery --
@pytest.mark.parametrize("site", SITES)
def test_single_fault_stream_bit_identical_per_tenant(site, serial_oracle):
    """Any single injected fault at any catalogued site under 3-tenant
    contention leaves every tenant's delivered stream bit-identical to its
    fault-free SERIAL run, the shed set unchanged, and every counter
    balanced after close()."""
    plan = FaultPlan.single(site)
    mts, store, delivered, sheds = _run_tenant_stream(
        plan=plan, retry=RetryPolicy(sleep=lambda s: None))
    assert sheds == EXPECT_SHEDS
    for tid, outs in delivered.items():
        want = serial_oracle[tid]
        assert len(outs) == len(want)
        for g, w in zip(outs, want):
            np.testing.assert_array_equal(g, w)
    _assert_balanced(mts, store)
    if site in NEW_SITES:
        assert [r.site for r in plan.fired] == [site]
        assert (mts.absorbed_faults + mts.trigger_failures) > 0


# --------------------------------------------------------- journaled writes --
def _write_wave(graph, parents):
    return [{"rlist": graph.rlist(p), "parent": p} for p in parents]


def test_journaled_write_waves_one_fsync_each(tmp_path):
    """Write waves granted through the coordinator land as ONE
    ``commit.batch`` record under ONE fsync each; a ``journal.fsync`` fault
    fails that wave to its tenant with no trace in the store or the
    journal, and the next waves land."""
    store, tree, graph, data = _scattered_store()
    dur = StoreDurability(str(tmp_path / "d"))
    mts = MultiTenantServer(store, threads=False,
                            quotas={"w": TenantQuota(max_wave=4),
                                    "r": TenantQuota(max_wave=4)})
    dur.snapshot(store, servers=mts)
    j = dur.journal
    synced = j.synced
    tks = mts.submit_commit("w", _write_wave(graph, [1, 2, 3]))
    assert [mts.result("w", t) for t in tks] == [12, 13, 14]
    assert j.synced == synced + 1
    n, epoch = store.graph.n_versions, store.epoch
    tks = mts.submit_commit("w", _write_wave(graph, [4, 5]))
    with FaultPlan.single("journal.fsync").armed():
        mts.pump()
    for t in tks:
        with pytest.raises(InjectedFault):
            mts.result("w", t)
    assert (store.graph.n_versions, store.epoch) == (n, epoch)
    assert j.repairs == 1 and j.synced == synced + 1
    tks = mts.submit_commit("w", _write_wave(graph, [4, 5]))
    assert [mts.result("w", t) for t in tks] == [15, 16]
    assert j.synced == synced + 2
    rt = mts.submit_many("r", [12, 16])
    for v, m in zip([12, 16], mts.results("r", rt)):
        np.testing.assert_array_equal(np.asarray(m),
                                      data[store.graph.rlist(v)])
    mts.close()
    recs, bad = read_records(j.path)
    assert bad is None
    assert [r.kind for r in recs if r.kind != "ticket"] == \
        ["commit.batch", "commit.batch"]
    rs = StoreDurability(str(tmp_path / "d")).restore(device="cpu")
    assert rs.store.graph.n_versions == 17
    _assert_balanced(mts, store)


# ------------------------------------------------------- the two packages --
def test_grant_log_and_tickets_agree_with_the_jax_package():
    """The same contention stream through both packages'
    ``MultiTenantServer(threads=False)``: the same grant log, sheds,
    per-tenant stats and, ticket for ticket, the same rows."""
    mts, store, delivered, sheds = _run_tenant_stream(use_kernel=False)
    rls, data = _arrays()
    graph = rgraph.BipartiteGraph.from_rlists(rls, n_records=len(data))
    rstore = rpart.PartitionedCVD(graph, data, np.zeros(len(rls), np.int64))
    rstore.superblock_max_bytes = store.superblock_max_bytes
    _, tree, _, _ = _scattered_store()
    rtree = RefTree(parent=tree.parent, n_records=tree.n_records,
                    edge_w=tree.edge_w)
    trig = RefTrigger(rstore, rtree, min_waves=2, use_kernel=False,
                      drain_timeout_s=5.0)
    quotas = {t: rtenancy.TenantQuota(
        max_inflight=q.max_inflight, wave_share=q.wave_share,
        max_wave=q.max_wave) for t, q in TENANTS.items()}
    rmts = rtenancy.MultiTenantServer(
        rstore, threads=False, quotas=quotas, max_backlog=MAX_BACKLOG,
        trigger=trig, use_kernel=False)
    rdelivered, rsheds = _drive(
        rmts, (rtenancy.QuotaExceeded, rtenancy.Overloaded))
    assert rmts.grant_log == mts.grant_log
    assert rsheds == sheds == EXPECT_SHEDS
    assert rmts.repartitions == mts.repartitions
    for t in TENANTS:
        assert vars(rmts.stats(t)) == vars(mts.stats(t))
        assert len(rdelivered[t]) == len(delivered[t])
        for a, b in zip(delivered[t], rdelivered[t]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ property suite --
N_VERSIONS = 10
N_RECORDS = 256


def _store(seed=5):
    rng = np.random.default_rng(seed)
    rls = [np.sort(rng.choice(N_RECORDS, 20,
                              replace=False)).astype(np.int64)
           for _ in range(N_VERSIONS)]
    graph = BipartiteGraph.from_rlists(rls, n_records=N_RECORDS)
    data = rng.integers(0, 1 << 20, (N_RECORDS, 6)).astype(np.int32)
    store = PartitionedCVD(graph, data, np.zeros(N_VERSIONS, np.int64),
                           device="cpu")
    return store, graph, data


quotas = st.builds(
    TenantQuota,
    max_inflight=st.integers(1, 8),
    wave_share=st.sampled_from([0.5, 1.0, 2.0]),
    max_wave=st.integers(1, 4))

streams = st.lists(
    st.lists(st.integers(0, N_VERSIONS - 1), min_size=0, max_size=10),
    min_size=1, max_size=3)


def _run(stream, tenant_quotas, max_backlog):
    store, graph, data = _store()
    ids = [f"t{i}" for i in range(len(stream))]
    mts = MultiTenantServer(
        store, threads=False, max_backlog=max_backlog,
        quotas={t: q for t, q in zip(ids, tenant_quotas)})
    admitted = {t: [] for t in ids}
    sheds = []
    for k in range(max(len(s) for s in stream)):
        for t, vids in zip(ids, stream):
            if k >= len(vids):
                continue
            try:
                admitted[t].append((mts.submit(t, vids[k]), vids[k]))
            except (QuotaExceeded, Overloaded) as e:
                sheds.append((t, k, type(e).__name__))
    delivered = {}
    for t in ids:
        delivered[t] = [(v, np.asarray(mts.result(t, tk)))
                        for tk, v in admitted[t]]
    mts.close()
    return delivered, sheds, list(mts.grant_log), mts.accounting(), store


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(stream=streams, data_st=st.data())
def test_random_mix_bit_identical_deterministic_balanced(stream, data_st):
    tenant_quotas = [data_st.draw(quotas) for _ in stream]
    max_backlog = data_st.draw(st.integers(2, 24))
    delivered, sheds, grants, acct, store = _run(
        stream, tenant_quotas, max_backlog)
    _, graph, data = _store()
    for t, pairs in delivered.items():
        for v, m in pairs:
            np.testing.assert_array_equal(m, data[graph.rlist(v)])
    delivered2, sheds2, grants2, _, _ = _run(
        stream, tenant_quotas, max_backlog)
    assert sheds2 == sheds
    assert grants2 == grants
    for t in delivered:
        assert [v for v, _ in delivered2[t]] == [v for v, _ in delivered[t]]
    assert acct["backlog"] == 0 and acct["leases_held"] == 0
    assert acct["peak_backlog"] <= max_backlog
    for t, row in acct["tenants"].items():
        assert row["queued"] == row["inflight"] == row["reserved"] == 0
        s = row["stats"]
        assert s.delivered + s.failed == s.submitted
    cnt = getattr(store, "_inflight_waves", None)
    assert int(cnt or 0) == 0
    if isinstance(cnt, GuardedCounter):
        assert cnt.underflows == 0
    reg = read_leases(store, create=False)
    assert reg is not None and reg.held() == 0
    assert reg.acquired == reg.released


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(counts=st.lists(st.integers(1, 8), min_size=2, max_size=4))
def test_equal_share_wait_bounded_by_tenant_count(counts):
    store, graph, data = _store()
    ids = [f"t{i}" for i in range(len(counts))]
    mts = MultiTenantServer(
        store, threads=False,
        quotas={t: TenantQuota(max_wave=1) for t in ids})
    tks = {t: [mts.submit(t, v % N_VERSIONS) for v in range(n)]
           for t, n in zip(ids, counts)}
    mts.pump()
    grants = list(mts.grant_log)
    assert sorted(grants) == sorted(
        t for t, n in zip(ids, counts) for _ in range(n))
    remaining = dict(zip(ids, counts))
    since_last: dict = {t: [] for t in ids}
    for g in grants:
        for t, seen in list(since_last.items()):
            if t == g:
                continue
            assert g not in seen, \
                f"tenant {t} waited through two {g!r} grants: {grants}"
            seen.append(g)
        since_last[g] = []
        remaining[g] -= 1
        if remaining[g] == 0:
            since_last.pop(g)
    for t in ids:
        mts.results(t, tks[t])
    mts.close()
    acct = mts.accounting()
    assert acct["backlog"] == 0
    for row in acct["tenants"].values():
        assert row["queued"] == row["inflight"] == row["reserved"] == 0
