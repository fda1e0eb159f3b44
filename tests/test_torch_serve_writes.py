"""The port's write plane and trigger hook on ``BatchedCheckoutServer``,
held against the JAX package's server: one seeded stream of commit waves,
read waves and density-triggered migrations through both servers gives the
same tickets (rows and vids), the same ``CheckoutStats`` counters, the same
trigger reports and the same final store — on the kernel tier (the port's
plain kernels against the reference in interpret mode) and on the host
tier, pipelined and serial.  Plus the write plane's own paths: a write
ticket forcing its flush, a failed write wave re-queued, a drain timeout
deferring the wave, the trigger's pipeline bubble, and faults a
``RetryPolicy`` absorbs."""
import dataclasses

import numpy as np
import pytest

import jax
import repro.core.checkout as rck
import repro.core.faults as rfaults
import repro.core.online as ronline
import repro.core.partition as rpart
import repro.serve.checkout as rsc
from repro.core import generate
from repro.core.graph import BipartiteGraph as RefGraph
from repro.core.version_graph import to_tree as ref_to_tree
from repro_torch.core.checkout import peek_superblock
from repro_torch.core.faults import FaultPlan, acquire_read_lease, read_leases
from repro_torch.core.online import RepartitionTrigger
from repro_torch.core.partition import store_from_arrays
from repro_torch.core.version_graph import WeightedTree, to_tree
from repro_torch.kernels import segment_append as sa
from repro_torch.kernels import segment_move as sm
from repro_torch.kernels.build import KernelError
from repro_torch.serve.checkout import (BatchedCheckoutServer, CheckoutStats,
                                        RetryPolicy)


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """Drop the reference's Pallas traces when this module ends, so that a
    later test file in the same process that counts fresh traces of the
    same kernels starts cold."""
    yield
    jax.clear_caches()


COUNTERS = [f.name for f in dataclasses.fields(CheckoutStats)
            if f.name not in ("ticket_latency_s", "_lat_cache")]
N_VERSIONS, N0 = 40, 28


def _workload(seed):
    w = generate("SCI", n_versions=N_VERSIONS, inserts=20, n_branches=5,
                 n_attrs=12, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    return w, tree


def _pool(w, v):
    return int(w.graph.indices[:w.graph.indptr[v]].max()) + 1


def _commits(w, tree, lo, hi):
    cur = _pool(w, lo)
    out = []
    for v in range(lo, hi):
        rl = w.graph.rlist(v)
        out.append({"parent": int(tree.parent[v]), "rlist": rl,
                    "new_rows": w.data[rl[rl >= cur]]})
        cur += int((rl >= cur).sum())
    return out


def _port_store(w, n0=N0, parts=4):
    ip = w.graph.indptr[:n0 + 1]
    pool = _pool(w, n0)
    return store_from_arrays(ip, w.graph.indices[:ip[-1]], pool,
                             w.data[:pool], np.arange(n0) % parts,
                             device="cpu")


def _ref_store(w, n0=N0, parts=4):
    ip = w.graph.indptr[:n0 + 1].copy()
    pool = _pool(w, n0)
    return rpart.PartitionedCVD(
        RefGraph(indptr=ip, indices=w.graph.indices[:ip[-1]].copy(),
                 n_records=pool), w.data[:pool].copy(), np.arange(n0) % parts)


def _trees(w, n0=N0):
    tree, _ = to_tree(w.graph, w.vgraph)
    rtree, _ = ref_to_tree(w.graph, w.vgraph)
    cut = lambda t, cls: cls(parent=t.parent[:n0].copy(),
                             n_records=t.n_records[:n0].copy(),
                             edge_w=t.edge_w[:n0].copy())
    return cut(tree, WeightedTree), cut(rtree, type(rtree))


def _stream(srv, w, tree, seed, n_steps):
    """Each step: a read wave of existing versions queued, then a write
    wave, one flush (writes land first, the reads dispatch on the new
    epoch), then a read wave including the versions just committed.
    Returns every ticket's result in ticket order."""
    rng = np.random.default_rng(seed)
    tickets = []
    lo = N0
    for step in range(n_steps):
        hi = min(lo + 3, N_VERSIONS)
        tickets += srv.submit_many(rng.choice(lo, 5).tolist())
        tickets += srv.submit_commit(_commits(w, tree, lo, hi))
        srv.flush()
        tickets += srv.submit_many(
            rng.choice(np.arange(lo, hi), 2).tolist()
            + rng.choice(hi, 4).tolist())
        srv.flush()
        lo = hi
    srv.deliver()
    out = [srv.result(t) for t in tickets]
    srv.close()
    return out


def _same_results(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(r))


def _report(r):
    out = {k: v for k, v in dataclasses.asdict(r).items()
           if k not in ("wall_s", "superblock")}
    sb = r.superblock
    out["superblock"] = None if sb is None else {
        k: v for k, v in dataclasses.asdict(sb).items() if k != "wall_s"}
    return out


def _same_store(port, ref):
    for f in ("indptr", "indices", "n_records"):
        np.testing.assert_array_equal(getattr(port.graph, f),
                                      getattr(ref.graph, f))
    np.testing.assert_array_equal(port.data, ref.data)
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    np.testing.assert_array_equal(port.vid_to_pid, ref.vid_to_pid)
    assert port.epoch == ref.epoch
    for p, q in zip(port.partitions, ref.partitions, strict=True):
        for f in ("vids", "grids", "block", "indptr", "indices"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    sb, rsb = peek_superblock(port), rck.peek_superblock(ref)
    assert (sb is None) == (rsb is None)
    if sb is not None:
        np.testing.assert_array_equal(sb.host, np.asarray(rsb.host))
        assert (sb._device is None) == (rsb._device is None)
        if sb._device is not None:
            np.testing.assert_array_equal(sb._device.numpy(),
                                          np.asarray(rsb._device))


# ------------------------------------------------ stream vs the reference --
@pytest.mark.parametrize("use_kernel,pipeline,n_steps", [
    (True, True, 3), (False, True, 4), (False, False, 4)])
def test_mixed_stream_matches_reference(use_kernel, pipeline, n_steps):
    w, tree = _workload(1)
    port_store, ref_store = _port_store(w), _ref_store(w)
    t, rt = _trees(w)
    kw = {"min_waves": 2, "low_density": 1.0}
    port = BatchedCheckoutServer(
        port_store, use_kernel=use_kernel, pipeline=pipeline,
        trigger=RepartitionTrigger(port_store, t, **kw))
    ref = rsc.BatchedCheckoutServer(
        ref_store, use_kernel=use_kernel, pipeline=pipeline,
        trigger=ronline.RepartitionTrigger(ref_store, rt, **kw))
    port.warmup()
    ref.warmup()
    got = _stream(port, w, tree, 1, n_steps)
    want = _stream(ref, w, tree, 1, n_steps)
    _same_results(got, want)
    assert {k: getattr(port.stats, k) for k in COUNTERS} == \
        {k: getattr(ref.stats, k) for k in COUNTERS}
    assert port.stats.commit_waves == n_steps
    assert port.stats.repartitions >= 1
    assert [_report(r) for r in port.trigger.reports] == \
        [_report(r) for r in ref.trigger.reports]
    _same_store(port_store, ref_store)
    sb = peek_superblock(port_store)
    assert sb is not None and (sb._device is not None) == use_kernel
    assert int(port_store._inflight_waves) == 0
    leases = read_leases(port_store, create=False)
    assert leases.held() == 0 and leases.acquired == leases.released


# --------------------------------------------------- write plane itself --
def test_write_ticket_result_forces_its_flush():
    w, tree = _workload(2)
    store = _port_store(w)
    srv = BatchedCheckoutServer(store)
    t0, t1 = srv.submit_commit(_commits(w, tree, N0, N0 + 2))
    assert srv.submit_commit([]) == []
    assert store.graph.n_versions == N0
    assert srv.result(t1) == N0 + 1           # lands the whole write wave
    assert srv.result(t0) == N0
    assert (srv.stats.commit_waves, srv.stats.commits_ingested) == (1, 2)
    np.testing.assert_array_equal(srv.serve([N0 + 1])[0],
                                  w.data[w.graph.rlist(N0 + 1)])


def test_failed_write_wave_requeues_like_the_reference():
    w, tree = _workload(3)
    bad = _commits(w, tree, N0, N0 + 2) + [{"parent": 999, "rlist": [0]}]
    for srv in (BatchedCheckoutServer(_port_store(w)),
                rsc.BatchedCheckoutServer(_ref_store(w), use_kernel=False)):
        reads = srv.submit_many([1, 2])
        srv.submit_commit(bad)
        with pytest.raises(ValueError, match="parent"):
            srv.flush()
        assert (srv.stats.requeues, srv.stats.commit_waves) == (1, 0)
        assert len(srv._pending_writes) == 3 and srv.store.epoch == 0
        assert [t for t, _, _ in srv._pending] == reads
        srv._pending_writes = srv._pending_writes[:2]   # drop the bad one
        srv.flush()
        assert srv.store.graph.n_versions == N0 + 2
        for t, v in zip(reads, [1, 2]):
            np.testing.assert_array_equal(srv.result(t),
                                          w.data[w.graph.rlist(v)])
        srv.close()


def test_drain_timeout_defers_the_write_wave():
    """An out-of-band lease on the current epoch (another server's wave in
    flight) holds the write wave off: it is deferred, not raced."""
    w, tree = _workload(4)
    store = _port_store(w)
    srv = BatchedCheckoutServer(store, write_drain_timeout_s=0.01,
                                deadline_s=0.0)
    lease = acquire_read_lease(store)
    tickets = srv.submit_commit(_commits(w, tree, N0, N0 + 2))
    assert srv.flush() == []
    assert srv.stats.commit_deferrals == 1 and store.epoch == 0
    assert len(srv._pending_writes) == 2
    assert not srv.poll()                     # deferred: the deadline waits
    lease.release()
    srv.flush()
    assert [srv.result(t) for t in tickets] == [N0, N0 + 1]
    assert srv.stats.commit_waves == 1


def test_trigger_needs_the_wave_engine():
    w, _ = _workload(5)
    store = _port_store(w)
    t, _ = _trees(w)
    with pytest.raises(ValueError, match="engine='wave'"):
        BatchedCheckoutServer(store, engine="perpart",
                              trigger=RepartitionTrigger(store, t))


def test_pending_fire_opens_a_pipeline_bubble():
    """In an unbroken pipelined read stream a wave is always in flight at
    delivery, so observe() would never run; a pending fire delivers the
    in-flight wave first, the migration lands, and the next wave is served
    on the new layout — exactly as the reference does."""
    w, _ = _workload(6)
    outs = []
    for make_store, make_srv, make_trig, tree in (
            (_port_store, BatchedCheckoutServer, RepartitionTrigger,
             _trees(w)[0]),
            (_ref_store, rsc.BatchedCheckoutServer,
             ronline.RepartitionTrigger, _trees(w)[1])):
        store = make_store(w, parts=6)
        srv = make_srv(store, use_kernel=False,
                       trigger=make_trig(store, tree, min_waves=2,
                                         low_density=1.0))
        srv.warmup()
        rng = np.random.default_rng(6)
        delivered = []
        for _ in range(5):
            srv.submit_many(rng.choice(N0, 6).tolist())
            delivered += srv.flush()
        delivered += srv.deliver()
        srv.close()
        outs.append((delivered, srv.stats, store))
    (got, st, store), (want, rst, _) = outs
    _same_results(got, want)
    assert st.repartitions == rst.repartitions == 1
    assert {k: getattr(st, k) for k in COUNTERS} == \
        {k: getattr(rst, k) for k in COUNTERS}
    assert store.epoch == 1


@pytest.mark.parametrize("site", ["ingest.extract", "ingest.commit",
                                  "online.trigger"])
def test_retry_policy_absorbs_write_and_trigger_faults(site):
    """With a RetryPolicy a failed ingest attempt is retried into the
    identical commit, and a failed trigger is counted and retried at the
    next delivered wave; the stream stays bit-identical to the reference
    under the same fault."""
    w, tree = _workload(7)
    results = []
    for make_store, make_srv, make_trig, policy, plan, tr in (
            (_port_store, BatchedCheckoutServer, RepartitionTrigger,
             RetryPolicy, FaultPlan, _trees(w)[0]),
            (_ref_store, rsc.BatchedCheckoutServer,
             ronline.RepartitionTrigger, rsc.RetryPolicy, rfaults.FaultPlan,
             _trees(w)[1])):
        store = make_store(w)
        srv = make_srv(store, use_kernel=False,
                       retry=policy(sleep=lambda s: None),
                       trigger=make_trig(store, tr, min_waves=1,
                                         low_density=1.0))
        fplan = plan.single(site)
        with fplan.armed():
            out = _stream(srv, w, tree, 7, 2)
        assert [r.site for r in fplan.fired] == [site]
        results.append((out, srv.stats, store))
    (got, st, store), (want, rst, ref_store) = results
    _same_results(got, want)
    assert {k: getattr(st, k) for k in COUNTERS} == \
        {k: getattr(rst, k) for k in COUNTERS}
    if site == "online.trigger":
        assert st.trigger_failures == 1 and st.repartitions >= 1
    else:
        assert st.retries == 1 and st.requeues == 0
    _same_store(store, ref_store)


@pytest.mark.parametrize("where", ["commit", "trigger"])
def test_retry_policy_does_not_retry_a_kernel_fault(monkeypatch, where):
    """A KernelError (a kernel that did not build, launch or take its plan)
    is not a transient fault.  With a RetryPolicy, a write wave whose
    superblock extension failed in ``segment_append`` is neither retried
    nor re-queued, since its commit landed and a retry would commit the
    versions twice: its tickets get their vids and the error propagates.  A
    migration whose ``segment_move`` failed propagates too, instead of
    counting as a trigger failure to retry."""
    w, tree = _workload(8)
    store = _port_store(w, parts=6)
    trigger = (RepartitionTrigger(store, _trees(w)[0], min_waves=1,
                                  low_density=1.0)
               if where == "trigger" else None)
    srv = BatchedCheckoutServer(store, retry=RetryPolicy(sleep=lambda s: None),
                                trigger=trigger)
    srv.warmup()

    def launch(*args, **kwargs):
        raise KernelError("segment launch failed: cudaError 700")

    with monkeypatch.context() as m:
        if where == "commit":
            m.setattr(sa, "segment_append_plain", launch)
            tickets = srv.submit_commit(_commits(w, tree, N0, N0 + 3))
            vids = list(range(N0, N0 + 3))
        else:
            m.setattr(sm, "segment_move_plain", launch)
            vids = [0, 5, 9, 20]
            tickets = srv.submit_many(vids)
        with pytest.raises(KernelError, match="cudaError 700"):
            srv.flush()
            srv.deliver()
    st = srv.stats
    assert (st.retries, st.requeues, st.trigger_failures) == (0, 0, 0)
    assert not srv._pending_writes and not srv._pending
    assert store.epoch == 1                  # the commit / migration landed
    if where == "commit":
        assert store.graph.n_versions == N0 + 3 and st.commit_waves == 1
        assert [int(srv.result(t)) for t in tickets] == vids
    else:
        assert st.repartitions == 0 and len(trigger.reports) == 0
        for t, v in zip(tickets, vids):
            np.testing.assert_array_equal(srv.result(t),
                                          w.data[w.graph.rlist(v)])
    for got, v in zip(srv.serve(vids), vids):
        np.testing.assert_array_equal(got, w.data[w.graph.rlist(v)])
    srv.close()
