"""Serve-side batched checkout: coalesce concurrent version requests into
fused multi-version gathers, PIPELINED across waves.

Request flow (the serve half of the checkout data-flow map in
``core/checkout.py``)::

    clients ── submit(vid) ──┐                       ticket per request
    clients ── submit(vid) ──┤   pending wave (dedup by vid at flush)
    clients ── submit(vid) ──┘
                │ flush()            — explicit,
                │                    — size-triggered   (>= max_wave pending),
                │                    — deadline-triggered (oldest pending
                │                      waited >= deadline_s; checked by poll())
                ├─ DISPATCH          — plan + launch the fused
                │    ``core.checkout.checkout_wave`` (device_out=True): ONE
                │    cross-partition kernel launch for the whole wave over
                │    the store's epoch-cached device-resident superblock,
                │    left IN FLIGHT behind a ``WaveResult`` handle (stream
                │    launches are asynchronous; host/perpart tiers ride the
                │    same handle pre-materialized)
                └─ DELIVER           — device→host copy + per-ticket split +
                     latency stamping of the PREVIOUS wave, run after the
                     freshly launched kernel was queued: wave N's host split
                     overlaps wave N+1's device time.  ``poll()`` drives
                     delivery opportunistically (only when the wave's CUDA
                     event has completed); ``result(ticket)`` and ``flush()``
                     force it.  ``pipeline=False`` restores the strictly
                     serial dispatch-then-deliver-own-wave loop.

Every dispatched wave holds a per-epoch ``core.faults.ReadLease`` for its
whole dispatch→deliver life (mirrored onto ``store._inflight_waves``).

Failure paths: a failed dispatch OR delivery re-queues the whole coalesced
wave (tickets stay serviceable) and rolls back its dispatch accounting; a
re-queued wave is gated off the deadline flusher until the next submit or
explicit ``flush()``; ``serve()`` releases its eviction-exempt reservations
whenever it raises.  Pass a ``RetryPolicy`` as ``retry`` and the failure
paths ABSORB instead: bounded retries with exponential backoff under a
wall-clock deadline, and a dispatch degradation ladder (configured tier ->
perpart -> host gather) whose repeatedly failing tiers a per-epoch circuit
breaker skips.  On a kernel-tier server over a CUDA store the ladder holds
only the on-card rungs: once they are spent the wave fails and re-queues,
it never moves to the CPU's host gather.  Failure sites (``core.faults``): ``serve.dispatch``,
``serve.delivery``, ``serve.transfer``.

Not yet ported: the write plane (``submit_commit``, ROADMAP A.5) and the
density-triggered repartitioning hook (``trigger``, ROADMAP A.6).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.checkout import (_validate_vids, checkout_partitioned,
                             get_superblock, get_superblock_groups)
from ..core.faults import acquire_read_lease, fault_point

logger = logging.getLogger(__name__)

LATENCY_WINDOW = 65536     # per-ticket latencies kept for the percentiles
RETAIN_RESULTS = 256       # unclaimed ticket results kept before eviction


@dataclasses.dataclass
class RetryPolicy:
    """Bounded-retry configuration for the serve failure paths.

    attempts:   tries PER LADDER TIER before degrading to the next one
                (delivery has no ladder: ``attempts`` total).
    backoff_s:  sleep before the first retry, doubling per retry within a
                tier.
    deadline_s: wall-clock budget for the whole dispatch/delivery cycle —
                once exceeded the pending failure propagates (the wave
                re-queues exactly as with ``retry=None``).  None = no
                deadline, the attempt counts are the only bound.
    breaker_threshold: failures of one ladder tier within one store epoch
                before the circuit breaker skips that tier.
    sleep:      injectable for tests (defaults to ``time.sleep``).
    """
    attempts: int = 3
    backoff_s: float = 0.001
    deadline_s: Optional[float] = None
    breaker_threshold: int = 3
    sleep: Callable[[float], None] = time.sleep


class TierBreaker:
    """Per-epoch circuit breaker over the dispatch degradation ladder: a
    tier that failed ``threshold`` times within the current store epoch is
    skipped until the epoch bumps."""

    def __init__(self, threshold: int = 3):
        self.threshold = int(threshold)
        self._epoch: Optional[int] = None
        self._failures: dict[str, int] = {}

    def _roll(self, epoch: int) -> None:
        if epoch != self._epoch:
            self._epoch = epoch
            self._failures = {}

    def tripped(self, tier: str, epoch: int) -> bool:
        self._roll(epoch)
        return self._failures.get(tier, 0) >= self.threshold

    def record_failure(self, tier: str, epoch: int) -> None:
        self._roll(epoch)
        self._failures[tier] = self._failures.get(tier, 0) + 1


@dataclasses.dataclass
class CheckoutStats:
    """Serve counters; the same fields as the JAX package's, so the two
    compare one to one (the migration and write-plane counters stay 0 until
    those planes are ported)."""
    waves: int = 0             # dispatched (and not rolled-back) waves
    waves_delivered: int = 0   # waves whose results reached the host split
    requests: int = 0
    unique_versions: int = 0
    rows_served: int = 0
    requeues: int = 0          # waves re-queued by a failed dispatch/delivery
    repartitions: int = 0      # density-triggered online repartitions fired
    retries: int = 0           # failed attempts a RetryPolicy absorbed
    degraded_waves: int = 0    # waves served by a lower ladder tier
    trigger_failures: int = 0  # observe() failures absorbed (retried later)
    # partition-group layer, counted when the wave DELIVERS off the delta
    # its dispatch captured
    group_waves: int = 0           # flushes routed through the group layer
    groups_touched: int = 0        # Σ distinct groups touched per group wave
    group_launches: int = 0        # fused kernel launches those waves paid
    group_evictions: int = 0       # LRU evictions the budget forced
    straggler_requests: int = 0    # vids that fell through to perpart
    # write plane (commit ingest waves)
    commit_waves: int = 0
    commits_ingested: int = 0
    commit_deferrals: int = 0
    # sliding window (deque, maxlen); ``requests`` keeps the all-time count.
    # Append via ``record_latency`` (it invalidates the percentile cache).
    ticket_latency_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))
    _lat_cache: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    def record_latency(self, dt: float) -> None:
        self.ticket_latency_s.append(dt)
        self._lat_cache = None

    def record_latencies(self, dts) -> None:
        """Bulk append (one C-level extend)."""
        self.ticket_latency_s.extend(dts)
        self._lat_cache = None

    def _latency_summary(self) -> tuple:
        # cached (p50, max): the properties are read per scrape on a serve
        # hot loop
        if self._lat_cache is None:
            dq = self.ticket_latency_s
            if not dq:
                self._lat_cache = (0.0, 0.0)
            else:
                arr = np.fromiter(dq, np.float64, len(dq))
                self._lat_cache = (float(np.median(arr)), float(arr.max()))
        return self._lat_cache

    @property
    def p50_latency_s(self) -> float:
        return self._latency_summary()[0]

    @property
    def max_latency_s(self) -> float:
        return self._latency_summary()[1]


@dataclasses.dataclass
class _InflightWave:
    """One dispatched wave awaiting delivery."""
    tickets: list                  # (ticket, vid, t_submit) triples
    ticket_ids: frozenset          # for result()'s "rides this wave?" check
    uniq: list                     # sorted unique vids the gather ran over
    handle: object                 # core.checkout.WaveResult
    group_delta: tuple             # group-manager counter delta at dispatch
    lease: object                  # core.faults.ReadLease pinning the epoch
                                   # the wave planned against


_GROUP_COUNTER_ZERO = (0, 0, 0, 0, 0)


class BatchedCheckoutServer:
    """Coalescing front-end over a PartitionedCVD; runs on the store's
    device.

    max_wave:   flush automatically once this many requests are pending.
    deadline_s: flush on ``poll()`` once the OLDEST pending request has
                waited this long.
    engine:     "wave" (default) = one fused cross-partition launch per
                flush; "perpart" = one launch per partition.
    pipeline:   True (default) = two-stage dispatch/deliver pipeline:
                ``flush()`` launches the wave and returns after delivering
                the PREVIOUS one.  False = strictly serial (each flush
                delivers its own wave before returning).
    trigger:    density-triggered repartitioning — not ported yet; must be
                None.
    retry:      optional ``RetryPolicy`` (see the module docstring).  None
                (default) keeps the raise-to-caller failure semantics.
    """

    def __init__(self, store, *, use_kernel: bool = True,
                 engine: str = "wave", max_wave: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 trigger=None, pipeline: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        if trigger is not None:
            raise NotImplementedError(
                "RepartitionTrigger is not ported yet (ROADMAP A.6, online "
                "migration)")
        self.store = store
        self.use_kernel = use_kernel
        self.engine = engine
        self.max_wave = max_wave
        self.deadline_s = deadline_s
        self.pipeline = pipeline
        self.retry = retry
        self._breaker = TierBreaker(retry.breaker_threshold
                                    if retry is not None else 3)
        self._closed = False
        self._clock = clock
        self._pending: list[tuple[int, int, float]] = []  # (ticket, vid, t)
        self._next_ticket = 0
        self._inflight: Optional[_InflightWave] = None
        # a wave re-queued by a failed flush must NOT be re-fired by the
        # deadline flusher on the very next poll(); the next submit, or an
        # explicit flush(), re-arms it
        self._deadline_armed = True
        # unclaimed results, FIFO-evicted beyond RETAIN_RESULTS; reserved
        # tickets (serve()'s in-flight wave) are eviction-exempt
        self._results: collections.OrderedDict[int, np.ndarray] = \
            collections.OrderedDict()
        self._reserved: set[int] = set()
        self.stats = CheckoutStats()

    # -- request plane ---------------------------------------------------------
    def submit(self, vid: int) -> int:
        """Queue a checkout request; returns its ticket.  Tickets are global
        and monotonically increasing (claim the result with
        ``result(ticket)``).  May trigger a size-based flush.  Re-arms the
        deadline flusher for a previously failed (re-queued) wave."""
        self._check_open()
        # validate HERE so a bad vid raises in the offending client's call
        (vid,) = _validate_vids(self.store, [vid])
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, vid, self._clock()))
        self._deadline_armed = True
        if self.max_wave is not None and len(self._pending) >= self.max_wave:
            self.flush()
        return ticket

    def submit_many(self, vids: Sequence[int]) -> list[int]:
        """Bulk ``submit``: one vectorized validation, one timestamp, one
        queue extend.  Validation raises BEFORE any ticket is assigned.  A
        size-triggered flush fires once at the end.  Returns the tickets in
        request order."""
        self._check_open()
        vids = _validate_vids(self.store, vids)
        if not vids:
            return []
        t = self._clock()
        base = self._next_ticket
        self._next_ticket = base + len(vids)
        tickets = list(range(base, self._next_ticket))
        self._pending.extend(zip(tickets, vids, [t] * len(vids)))
        self._deadline_armed = True
        if self.max_wave is not None and len(self._pending) >= self.max_wave:
            self.flush()
        return tickets

    def submit_commit(self, commits: Sequence[dict]) -> list[int]:
        raise NotImplementedError(
            "the write plane is not ported yet (ROADMAP A.5, write path + "
            "segment_append)")

    def poll(self) -> bool:
        """Event-loop hook: deliver the in-flight wave if its device result
        is ready (never blocks on the device), then deadline-flush iff the
        oldest pending request has waited ``deadline_s``.  Returns whether
        a wave was flushed.  A closed server polls False."""
        if self._closed:
            return False
        if self._inflight is not None and self._inflight.handle.ready():
            self.deliver()
        if (self._pending and self.deadline_s is not None
                and self._deadline_armed
                and self._clock() - self._pending[0][2] >= self.deadline_s):
            self.flush()
            return True
        return False

    def flush(self) -> list[np.ndarray]:
        """DISPATCH every pending request as one fused wave (duplicate vids
        share one gather), then DELIVER the previously in-flight wave.

        Returns the per-ticket results (ticket order) of the wave this call
        DELIVERED: the previous wave in pipelined mode (``[]`` when none was
        in flight), the just-dispatched wave itself when ``pipeline=False``.
        Every result is also retained for ``result(ticket)``."""
        self._check_open()
        wave = self._pending
        self._pending = []
        dispatched = None
        if wave:
            uniq = sorted({v for _, v, _ in wave})
            g0 = self._group_counters()
            # the lease is taken BEFORE planning: it pins the epoch the
            # plan will be built against; a failed dispatch releases it
            lease = acquire_read_lease(self.store)
            try:
                handle = self._dispatch(uniq)
            except BaseException:
                # re-queue every request so the tickets stay serviceable,
                # and gate the deadline retry (see _deadline_armed)
                lease.release()
                self._pending = wave + self._pending
                self._deadline_armed = False
                self.stats.requeues += 1
                raise
            g1 = self._group_counters()
            dispatched = _InflightWave(
                tickets=wave,
                ticket_ids=frozenset(t for t, _, _ in wave),
                uniq=uniq, handle=handle, lease=lease,
                group_delta=tuple(b - a for a, b in zip(g0, g1)))
            self.stats.waves += 1
            self.stats.requests += len(wave)
            self.stats.unique_versions += len(uniq)
        prev, self._inflight = self._inflight, dispatched
        out = self._deliver_wave(prev) if prev is not None else []
        if not self.pipeline and self._inflight is not None:
            out = self.deliver()
        return out

    def deliver(self) -> list[np.ndarray]:
        """Force delivery of the in-flight wave (device→host copy +
        per-ticket split + latency stamping); ``[]`` when nothing is in
        flight."""
        wave, self._inflight = self._inflight, None
        if wave is None:
            return []
        return self._deliver_wave(wave)

    def result(self, ticket: int) -> np.ndarray:
        """Claim (and drop) a flushed ticket's materialized version,
        forcing delivery first when the ticket rides the in-flight wave.
        An unreserved ticket older than the RETAIN_RESULTS most recent
        unclaimed ones has been evicted and raises KeyError; a still-pending
        ticket also raises and KEEPS its eviction-exempt reservation."""
        if (ticket not in self._results and self._inflight is not None
                and ticket in self._inflight.ticket_ids):
            self.deliver()
        out = self._results.pop(ticket)
        self._reserved.discard(ticket)
        return out

    # -- shutdown --------------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("server is closed")

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, *, deliver: bool = True) -> None:
        """Drain and shut down.  IDEMPOTENT; the in-flight wave's read
        lease is released exactly once.

        ``deliver=True`` (default) joins the in-flight wave and delivers
        its results (claimable via ``result`` even after close); a delivery
        failure is absorbed (``_deliver_wave`` already re-queued the
        tickets).  ``deliver=False`` re-queues the wave without joining it.
        Either way every reservation is released and submit/flush raise
        ``RuntimeError`` afterwards (``poll()`` returns False)."""
        if self._closed:
            return
        wave, self._inflight = self._inflight, None
        if wave is not None:
            if deliver:
                try:
                    self._deliver_wave(wave)
                except Exception:
                    logger.warning("delivery during close failed; wave "
                                   "re-queued undelivered", exc_info=True)
            else:
                self._pending = wave.tickets + self._pending
                self.stats.waves -= 1
                self.stats.requests -= len(wave.tickets)
                self.stats.unique_versions -= len(wave.uniq)
                self.stats.requeues += 1
                wave.lease.release()
        self._reserved.clear()
        self._closed = True

    def __enter__(self) -> "BatchedCheckoutServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch plane --------------------------------------------------------
    def _dispatch(self, uniq: list):
        """One wave dispatch.  With ``retry=None`` a single
        ``checkout_partitioned`` call (plus the ``serve.dispatch`` fault
        point) — a failure propagates and ``flush()`` re-queues.  With a
        policy it walks the degradation ladder: the configured tier first,
        then the perpart engine, then (off the card only) the host gather;
        each tier gets ``attempts`` tries with doubling backoff, a per-epoch
        breaker skips tiers that keep failing, and the deadline bounds the
        whole cycle."""
        def attempt(engine, use_kernel):
            fault_point("serve.dispatch", self.store)
            return checkout_partitioned(
                self.store, uniq, use_kernel=use_kernel,
                engine=engine, device_out=True)

        if self.retry is None:
            return attempt(self.engine, self.use_kernel)
        rungs = [("kernel", self.engine, self.use_kernel),
                 ("perpart", "perpart", self.use_kernel)]
        if not (self.use_kernel and self.store.device.type == "cuda"):
            # the host gather runs on the CPU: a rung only for a CPU store
            # or a host-tier server, never a way off the card
            rungs.append(("host", "perpart", False))
        tiers: list[tuple[str, str, bool]] = []
        seen: set[tuple] = set()
        for name, engine, uk in rungs:
            if (engine, uk) not in seen:
                seen.add((engine, uk))
                tiers.append((name, engine, uk))
        epoch = int(getattr(self.store, "epoch", 0))
        deadline = (None if self.retry.deadline_s is None
                    else self._clock() + self.retry.deadline_s)
        last_exc: Optional[BaseException] = None
        for rank, (name, engine, uk) in enumerate(tiers):
            if self._breaker.tripped(name, epoch):
                continue
            backoff = self.retry.backoff_s
            for k in range(max(1, self.retry.attempts)):
                try:
                    handle = attempt(engine, uk)
                except Exception as exc:
                    last_exc = exc
                    self._breaker.record_failure(name, epoch)
                    self.stats.retries += 1
                    if deadline is not None and self._clock() >= deadline:
                        raise
                    logger.warning("dispatch attempt %d on tier %r failed; "
                                   "backing off %.3gs", k, name, backoff,
                                   exc_info=True)
                    self.retry.sleep(backoff)
                    backoff *= 2
                    continue
                if rank > 0:
                    self.stats.degraded_waves += 1
                return handle
        raise last_exc if last_exc is not None else RuntimeError(
            "all dispatch tiers circuit-broken")

    # -- delivery plane --------------------------------------------------------
    def _materialize(self, wave: _InflightWave):
        """The delivery join (device→host copy + split), retried under the
        policy — the injected failures fire BEFORE the handle consumes its
        device result, so a retry yields the bit-identical wave."""
        if self.retry is None:
            fault_point("serve.delivery", self.store)
            return wave.handle.materialize()
        backoff = self.retry.backoff_s
        deadline = (None if self.retry.deadline_s is None
                    else self._clock() + self.retry.deadline_s)
        for k in range(max(1, self.retry.attempts)):
            try:
                fault_point("serve.delivery", self.store)
                return wave.handle.materialize()
            except Exception:
                self.stats.retries += 1
                if (k + 1 >= max(1, self.retry.attempts)
                        or (deadline is not None
                            and self._clock() >= deadline)):
                    raise
                logger.warning("delivery attempt %d failed; backing off "
                               "%.3gs", k, backoff, exc_info=True)
                self.retry.sleep(backoff)
                backoff *= 2
        raise AssertionError("unreachable")  # pragma: no cover

    def _deliver_wave(self, wave: _InflightWave) -> list[np.ndarray]:
        """The deliver stage for one (already detached) wave.  A delivery
        failure re-queues the wave's tickets and rolls back its dispatch
        accounting, exactly like a dispatch failure."""
        try:
            mats = self._materialize(wave)
        except BaseException:
            self._pending = wave.tickets + self._pending
            self._deadline_armed = False
            self.stats.waves -= 1
            self.stats.requests -= len(wave.tickets)
            self.stats.unique_versions -= len(wave.uniq)
            self.stats.requeues += 1
            raise
        finally:
            # only NOW is the wave's kernel no longer in flight (joined or
            # dead)
            wave.lease.release()
        done = self._clock()
        slot = {v: i for i, v in enumerate(wave.uniq)}
        out = [mats[slot[v]] for _, v, _ in wave.tickets]
        self._results.update(zip((t for t, _, _ in wave.tickets), out))
        self.stats.record_latencies([done - t0 for _, _, t0 in wave.tickets])
        if len(self._results) > RETAIN_RESULTS:
            for t in list(self._results):
                if len(self._results) <= RETAIN_RESULTS:
                    break
                if t not in self._reserved:
                    del self._results[t]
        self.stats.waves_delivered += 1
        self.stats.rows_served += sum(len(m) for m in out)
        # group-layer accounting lands at DELIVERY, off the delta this
        # wave's dispatch captured
        self._apply_group_delta(wave.group_delta)
        return out

    def _group_counters(self) -> tuple:
        mgr = get_superblock_groups(self.store)
        if mgr is None:
            return _GROUP_COUNTER_ZERO
        return (mgr.waves, mgr.groups_touched, mgr.launches,
                mgr.evictions, mgr.straggler_requests)

    def _apply_group_delta(self, d: tuple) -> None:
        self.stats.group_waves += d[0]
        self.stats.groups_touched += d[1]
        self.stats.group_launches += d[2]
        self.stats.group_evictions += d[3]
        self.stats.straggler_requests += d[4]

    # -- convenience -----------------------------------------------------------
    def warmup(self) -> None:
        """Opt this server into the superblock ahead of the first wave.

        Builds the host superblock and, for kernel-tier servers, uploads
        the device copy so the first request doesn't pay the host→device
        transfer.  A store whose ``superblock_max_bytes`` budget refuses
        the whole-store copy warms the PARTITION-GROUP layer instead."""
        budget = getattr(self.store, "superblock_max_bytes", None)
        sb, _ = get_superblock(self.store, max_bytes=budget)
        if sb is not None:
            if self.use_kernel:
                sb.device()
            return
        if budget is not None:
            mgr = get_superblock_groups(self.store, budget=budget,
                                        create=True)
            if mgr is not None:
                mgr.warm(device=bool(self.use_kernel))

    def serve(self, vids: Sequence[int]) -> list[np.ndarray]:
        """submit+flush+claim in one call — results in request order, fully
        delivered on return.  Tickets are reserved before submission so a
        wave larger than RETAIN_RESULTS cannot evict its own results; ANY
        failure releases every reservation this call made."""
        reserved: list[int] = []
        try:
            tickets = []
            for v in vids:
                # submit() assigns exactly this id — track the reservation
                # BEFORE the call, so a failure inside submit still
                # releases it
                nxt = self._next_ticket
                self._reserved.add(nxt)
                reserved.append(nxt)
                tickets.append(self.submit(v))
            self.flush()
            return [self.result(t) for t in tickets]
        except BaseException:
            for t in reserved:
                self._reserved.discard(t)
            raise
