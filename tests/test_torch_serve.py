"""The port's ``BatchedCheckoutServer`` held against the JAX package's: one
seeded ticket stream through both servers (pipelined and serial) gives the
same per-ticket rows and the same ``CheckoutStats`` counters — kernel tier
against the reference kernel tier in interpret mode for a few waves at a
tiny size, host tier against host tier for a longer stream — and a
single-fault sweep over the serve and wave sites stays bit-identical with
balanced lease and in-flight accounting."""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.faults as rfaults
import repro.serve.checkout as rsc
from repro.core import generate
from repro.core.partition import PartitionedCVD as RefStore
from repro_torch.core.checkout import (estimate_superblock_bytes,
                                       get_superblock_groups,
                                       peek_superblock)
from repro_torch.core.faults import (FaultPlan, GuardedCounter,
                                     InjectedFault, read_leases)
from repro_torch.core.partition import store_from_arrays
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference kernel tier's Pallas traces are cached process-wide;
    drop them when this module ends, so that a later test file in the same
    process that counts fresh traces of the same kernel starts cold."""
    yield
    jax.clear_caches()
from repro_torch.serve.checkout import (BatchedCheckoutServer,
                                        CheckoutStats, RetryPolicy,
                                        TierBreaker)

COUNTERS = [f.name for f in dataclasses.fields(CheckoutStats)
            if f.name not in ("ticket_latency_s", "_lat_cache")]


def _workload(seed=0, n_versions=36, n_partitions=5):
    w = generate("SCI", n_versions=n_versions, inserts=40, n_branches=5,
                 n_attrs=12, seed=seed)
    rng = np.random.default_rng(seed)
    assignment = rng.permutation(np.arange(w.n_versions) % n_partitions)
    return w, assignment


def _port_store(w, assignment, budget=None):
    store = store_from_arrays(w.graph.indptr, w.graph.indices,
                              w.graph.n_records, w.data, assignment,
                              device="cpu")
    if budget == "third":
        store.superblock_max_bytes = estimate_superblock_bytes(store) // 3
    return store


def _ticket_stream(seed, n_waves, n_versions, per_wave=10, uniq=4):
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        u = rng.choice(n_versions, uniq, replace=False)
        waves.append(np.concatenate(
            [u, rng.choice(u, per_wave - uniq)]).tolist())
    return waves


def _drive(srv, waves):
    """submit_many + flush per wave, then deliver the last one; returns
    every delivered wave's per-ticket rows in delivery order."""
    delivered = []
    for vids in waves:
        srv.submit_many(vids)
        out = srv.flush()
        if out:
            delivered.append(out)
    out = srv.deliver()
    if out:
        delivered.append(out)
    srv.close()
    return delivered


def _same_stream(got, want):
    assert len(got) == len(want)
    for gw, ww in zip(got, want):
        assert len(gw) == len(ww)
        for g, w_ in zip(gw, ww):
            assert g.dtype == w_.dtype
            np.testing.assert_array_equal(g, np.asarray(w_))


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


# ------------------------------------------------ stream vs the reference --
@pytest.mark.parametrize("pipeline", [True, False])
def test_kernel_tier_stream_matches_reference_interpret(pipeline):
    w, assignment = _workload(1, n_versions=20, n_partitions=3)
    waves = _ticket_stream(1, 3, w.n_versions)
    port = BatchedCheckoutServer(_port_store(w, assignment),
                                 use_kernel=True, pipeline=pipeline)
    ref = rsc.BatchedCheckoutServer(RefStore(w.graph, w.data, assignment),
                                    use_kernel=True, pipeline=pipeline)
    port.warmup()
    ref.warmup()
    _same_stream(_drive(port, waves), _drive(ref, waves))
    assert _counters(port.stats) == _counters(ref.stats)
    assert peek_superblock(port.store).uploads == 1


@pytest.mark.parametrize("budget", [None, "third"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_host_tier_stream_matches_reference(pipeline, budget):
    w, assignment = _workload(2)
    waves = _ticket_stream(2, 12, w.n_versions)
    port_store = _port_store(w, assignment, budget)
    ref_store = RefStore(w.graph, w.data, assignment)
    ref_store.superblock_max_bytes = port_store.superblock_max_bytes
    port = BatchedCheckoutServer(port_store, use_kernel=False,
                                 pipeline=pipeline)
    ref = rsc.BatchedCheckoutServer(ref_store, use_kernel=False,
                                    pipeline=pipeline)
    _same_stream(_drive(port, waves), _drive(ref, waves))
    assert _counters(port.stats) == _counters(ref.stats)


def test_kernel_tier_long_stream_matches_reference_host_tier():
    """The port's kernel tier (plain torch on the CPU) over a longer stream,
    held row for row against the reference's host tier."""
    w, assignment = _workload(3)
    waves = _ticket_stream(3, 12, w.n_versions)
    port = BatchedCheckoutServer(_port_store(w, assignment))
    ref = rsc.BatchedCheckoutServer(RefStore(w.graph, w.data, assignment),
                                    use_kernel=False)
    port.warmup()
    _same_stream(_drive(port, waves), _drive(ref, waves))
    assert port.stats.rows_served == ref.stats.rows_served


def test_dispatch_ladder_matches_reference_under_the_same_faults():
    """Same fault schedule on both sides: the ladder degrades, the breaker
    trips and re-arms identically, and the rows agree."""
    w, assignment = _workload(4)
    port = BatchedCheckoutServer(
        _port_store(w, assignment), use_kernel=False,
        retry=RetryPolicy(attempts=2, backoff_s=0.0, breaker_threshold=2,
                          sleep=lambda s: None))
    ref = rsc.BatchedCheckoutServer(
        RefStore(w.graph, w.data, assignment), use_kernel=False,
        retry=rsc.RetryPolicy(attempts=2, backoff_s=0.0,
                              breaker_threshold=2, sleep=lambda s: None))
    for srv, plan in ((port, FaultPlan), (ref, rfaults.FaultPlan)):
        with plan({"serve.dispatch": [0, 1]}, max_faults=2).armed():
            srv.serve([1, 2])
        srv.serve([3])
        srv.store.epoch += 1
        srv.serve([4, 4])
    assert _counters(port.stats) == _counters(ref.stats)
    assert port.stats.degraded_waves == 2 and port.stats.retries == 2


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_ladder_has_a_host_rung_off_the_card_only(device, monkeypatch):
    """Every kernel-tier launch fails.  On a CPU store the ladder ends in
    the host gather and serves the wave degraded; on a store on the card it
    holds only the on-card rungs, so the wave fails and re-queues rather
    than move to the CPU."""
    w, assignment = _workload(10)
    store = _port_store(w, assignment)
    store.device = torch.device(device)       # before any superblock exists

    def launch_fails(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ops, "checkout_wave", launch_fails)
    monkeypatch.setattr(ops, "checkout_batched", launch_fails)
    srv = BatchedCheckoutServer(
        store, retry=RetryPolicy(attempts=1, sleep=lambda s: None))
    vids = [1, 2, 3, 9]
    tickets = srv.submit_many(vids)
    if device == "cpu":
        srv.flush()
        for t, v in zip(tickets, vids):
            np.testing.assert_array_equal(srv.result(t),
                                          w.data[w.graph.rlist(v)])
        assert (srv.stats.degraded_waves, srv.stats.requeues) == (1, 0)
    else:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            srv.flush()
        assert (srv.stats.degraded_waves, srv.stats.requeues,
                srv.stats.waves) == (0, 1, 0)
        assert len(srv._pending) == len(vids)
    assert srv.stats.retries == 2              # the two on-card rungs
    assert int(store._inflight_waves) == 0


# --------------------------------------------------- single-fault sweep --
SWEEP_WAVES = ([0, 3, 7, 11, 3], [1, 4, 8], [2, 5, 9, 11], [0, 6, 10, 6],
               [3, 7, 1])


def _fault_run(budget, plan=None):
    w, assignment = _workload(5, n_versions=24, n_partitions=6)
    store = _port_store(w, assignment, budget)
    srv = BatchedCheckoutServer(store,
                                retry=RetryPolicy(sleep=lambda s: None))
    outs = []
    with plan.armed() if plan is not None else contextlib.nullcontext():
        for vids in SWEEP_WAVES:
            outs.append(srv.serve(vids))
        srv.close()
    return srv, store, w, outs


@pytest.mark.parametrize("budget", [None, "third"])
@pytest.mark.parametrize("site", ["serve.dispatch", "serve.delivery",
                                  "serve.transfer", "superblock.upload",
                                  "wave.launch"])
def test_single_fault_stream_bit_identical_and_balanced(site, budget):
    _, _, _, oracle = _fault_run(budget)
    plan = FaultPlan.single(site)
    srv, store, w, outs = _fault_run(budget, plan)
    assert [r.site for r in plan.fired] == [site]
    for got, want, vids in zip(outs, oracle, SWEEP_WAVES):
        for g, o, v in zip(got, want, vids):
            np.testing.assert_array_equal(g, o)
            np.testing.assert_array_equal(g, w.data[w.graph.rlist(v)])
    assert srv.stats.retries >= 1 and srv.stats.requeues == 0
    counter = store._inflight_waves
    assert isinstance(counter, GuardedCounter)
    assert int(counter) == 0 and counter.underflows == 0
    leases = read_leases(store, create=False)
    assert leases.held() == 0 and leases.acquired == leases.released
    assert srv._reserved == set()
    mgr = get_superblock_groups(store)
    if budget is not None:
        assert mgr.pins - mgr.evictions == len(mgr.groups)
        assert mgr.pinned_bytes <= mgr.budget
    else:
        assert mgr is None


def test_fault_without_retry_requeues_and_recovers():
    w, assignment = _workload(6)
    srv = BatchedCheckoutServer(_port_store(w, assignment))
    srv.warmup()                           # superblock cached: wave path
    t = srv.submit(5)
    with FaultPlan.single("wave.launch").armed():
        with pytest.raises(InjectedFault):
            srv.flush()
    assert srv.stats.requeues == 1 and srv.stats.waves == 0
    assert int(srv.store._inflight_waves) == 0
    srv.flush()
    np.testing.assert_array_equal(srv.result(t),
                                  w.data[w.graph.rlist(5)])


# ----------------------------------------------------- serve plane itself --
def test_poll_delivers_ready_wave_and_deadline_flushes():
    w, assignment = _workload(7)
    now = [0.0]
    srv = BatchedCheckoutServer(_port_store(w, assignment), deadline_s=0.5,
                                clock=lambda: now[0])
    t = srv.submit(2)
    assert not srv.poll()                 # young request: nothing flushes
    now[0] = 1.0
    assert srv.poll()                     # deadline flush, wave in flight
    assert srv._inflight is not None
    srv.poll()                            # ready on the CPU: delivered
    assert srv._inflight is None and srv.stats.waves_delivered == 1
    np.testing.assert_array_equal(srv.result(t), w.data[w.graph.rlist(2)])
    srv.close()
    srv.close()                           # idempotent
    assert not srv.poll()
    with pytest.raises(RuntimeError):
        srv.submit(1)


def test_max_wave_flushes_and_close_without_delivery_requeues():
    w, assignment = _workload(8)
    srv = BatchedCheckoutServer(_port_store(w, assignment), max_wave=3)
    srv.submit_many([1, 2])
    assert srv.stats.waves == 0
    srv.submit(3)                          # size-triggered flush
    assert srv.stats.waves == 1 and srv._inflight is not None
    srv.close(deliver=False)
    assert srv.stats.waves == 0 and srv.stats.requeues == 1
    assert int(srv.store._inflight_waves) == 0


def test_unported_planes_raise():
    """The write plane and the trigger hook are ported now (ROADMAP A.5,
    A.6); what raises is what the reference refuses too: a trigger on the
    perpart engine, a commit naming a parent that does not exist (at
    flush, re-queued), an unknown version."""
    w, assignment = _workload(9)
    store = _port_store(w, assignment)
    with pytest.raises(ValueError, match="engine='wave'"):
        BatchedCheckoutServer(store, engine="perpart", trigger=object())
    srv = BatchedCheckoutServer(store)
    srv.submit_commit([{"rlist": [0, 1], "parent": w.n_versions}])
    with pytest.raises(ValueError, match="parent"):
        srv.flush()
    assert srv.stats.requeues == 1 and store.graph.n_versions == w.n_versions
    with pytest.raises(ValueError):
        srv.submit(w.n_versions)


def test_tier_breaker_matches_reference():
    for cls in (TierBreaker, rsc.TierBreaker):
        b = cls(threshold=2)
        b.record_failure("kernel", 0)
        b.record_failure("kernel", 0)
        assert b.tripped("kernel", 0) and not b.tripped("perpart", 0)
        assert not b.tripped("kernel", 1)
