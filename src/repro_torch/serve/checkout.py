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

Pass a ``core.online.RepartitionTrigger`` as ``trigger`` and the server
closes the paper's online-maintenance loop: every dispatched wave records
run density, and BETWEEN DELIVERED waves — never while a wave is in flight,
so a migration can never race a launched kernel — the trigger re-clusters
with LYRESPLIT + incremental migration (``apply_migration`` +
``migrate_superblock``, ONE ``segment_move`` launch on the card).  Every
dispatched wave holds a per-epoch ``core.faults.ReadLease`` for its whole
dispatch→deliver life (mirrored onto ``store._inflight_waves``), so the
trigger's own guard holds even for out-of-band ``observe()`` calls.

The WRITE plane rides the same schedule: ``submit_commit(commits)`` mints
WRITE TICKETS in the checkout ticket namespace, and ``flush()`` lands every
pending write as ONE ``PartitionedCVD.commit_many`` ingest wave BEFORE
dispatching the read wave — so the reads just coalesced observe the
versions just committed.  A commit bumps the store epoch and retires the
old device superblock (extended in place by ONE ``segment_append``
launch), so a write wave first JOINS the in-flight read wave and then
enters the lease registry's ``draining()`` window: out-of-band leases
deliver against the epoch they planned on before the ingest.  A drain
timeout DEFERS the write wave (re-queued, retried at the next flush).
``result(write_ticket)`` yields the assigned vid.

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
it never moves to the CPU's host gather.  A failed write wave re-queues
like a failed read dispatch, and with a policy a failed trigger
``observe()`` is logged and retried at the next delivered wave.  A
``KernelError`` (a kernel that did not build, launch or take its plan) is
never retried: after a landed commit its tickets get their vids and the
error propagates.  Failure
sites (``core.faults``): ``serve.dispatch``, ``serve.delivery``,
``serve.transfer``.
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
from ..core.faults import acquire_read_lease, fault_point, read_leases
from ..core.journal import get_journal
from ..kernels.build import KernelError

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
    compare one to one."""
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
    # write plane (commit ingest waves — PartitionedCVD.commit_many)
    commit_waves: int = 0          # landed write waves (ONE epoch bump each)
    commits_ingested: int = 0      # commits those waves carried
    commit_deferrals: int = 0      # write waves a lease-drain timeout
                                   # deferred (re-queued, retried at the
                                   # next flush)
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
    trigger:    optional ``core.online.RepartitionTrigger`` — its
                ``observe()`` runs after a wave DELIVERS and only while no
                other wave is in flight; a PENDING fire (``should_fire()``)
                opens a one-wave pipeline bubble at the next flush so an
                unbroken stream cannot starve the migration; fired
                repartitions are counted in ``stats.repartitions``.
    retry:      optional ``RetryPolicy`` (see the module docstring).  None
                (default) keeps the raise-to-caller failure semantics.
    tenant:     the ticket namespace (None = the anonymous one): global
                ticket identity is (tenant, ticket), and
                ``core.durability`` persists and journals each tenant's
                watermark under it.
    write_drain_timeout_s: how long a write wave waits in the lease
                registry's drain window for out-of-band epoch leases before
                DEFERRING the commit to the next flush.  None (default)
                waits until the epoch drains.
    """

    def __init__(self, store, *, use_kernel: bool = True,
                 engine: str = "wave", max_wave: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 trigger=None, pipeline: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 tenant: Optional[str] = None,
                 write_drain_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if trigger is not None and engine != "wave":
            # density is only recorded by the wave engine; a trigger on the
            # perpart engine would silently never fire
            raise ValueError(
                f"RepartitionTrigger requires engine='wave', got {engine!r}")
        self.store = store
        self.use_kernel = use_kernel
        self.engine = engine
        self.max_wave = max_wave
        self.deadline_s = deadline_s
        self.trigger = trigger
        self.pipeline = pipeline
        self.retry = retry
        self.tenant = tenant
        self._breaker = TierBreaker(retry.breaker_threshold
                                    if retry is not None else 3)
        self._closed = False
        self._clock = clock
        self.write_drain_timeout_s = write_drain_timeout_s
        self._pending: list[tuple[int, int, float]] = []  # (ticket, vid, t)
        # the write plane's queue: (ticket, commit dict, t_submit); landed
        # as ONE commit_many ingest wave at the next flush boundary
        self._pending_writes: list[tuple[int, dict, float]] = []
        self._next_ticket = 0
        self._journaled_ticket = 0   # watermark last recorded in the journal
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
        """Queue a write wave: one WRITE TICKET per commit dict (the
        ``PartitionedCVD.commit_many`` forms — ``rlist``/``new_rows`` or
        ``table``, plus ``parent``/``pid``), minted from the same namespace
        as checkout tickets.  The whole pending write queue lands as ONE
        ingest wave at the next ``flush()`` — before that flush's read
        dispatch, so coalesced reads observe the new versions — and
        ``result(ticket)`` then yields the assigned vid.  Same-wave parent
        chaining works across submits.  Deep validation happens at flush
        time inside ``commit_many`` (before any state changes), so a
        malformed commit fails — and re-queues — the whole write wave.  May
        trigger a size-based flush, exactly like ``submit``."""
        self._check_open()
        commits = [dict(c) for c in commits]
        if not commits:
            return []
        t = self._clock()
        base = self._next_ticket
        self._next_ticket = base + len(commits)
        tickets = list(range(base, self._next_ticket))
        self._pending_writes.extend(zip(tickets, commits,
                                        [t] * len(commits)))
        self._deadline_armed = True
        if (self.max_wave is not None
                and len(self._pending_writes) >= self.max_wave):
            self.flush()
        return tickets

    def _journal_watermark(self) -> None:
        """Advisory ``ticket`` record of this tenant's watermark, appended
        when it has advanced since the last record.  Buffered and
        failure-absorbed (``append_advisory``): the serve path must never
        fail on telemetry, and a lost tail only widens the restored
        watermark gap — never a ticket collision, since restore takes the
        max of the snapshot and journal records."""
        j = get_journal(self.store)
        if j is None or self._next_ticket <= self._journaled_ticket:
            return
        if j.append_advisory("ticket", {
                "tenant": "" if self.tenant is None else str(self.tenant),
                "watermark": int(self._next_ticket)}):
            self._journaled_ticket = self._next_ticket

    def poll(self) -> bool:
        """Event-loop hook: deliver the in-flight wave if its device result
        is ready (never blocks on the device), then deadline-flush iff the
        oldest pending request has waited ``deadline_s``.  Returns whether
        a wave was flushed.  A closed server polls False."""
        if self._closed:
            return False
        if self._inflight is not None and self._inflight.handle.ready():
            self.deliver()
        oldest = min([t for _, _, t in self._pending[:1]]
                     + [t for _, _, t in self._pending_writes[:1]],
                     default=None)
        if (oldest is not None and self.deadline_s is not None
                and self._deadline_armed
                and self._clock() - oldest >= self.deadline_s):
            self.flush()
            return True
        return False

    def flush(self) -> list[np.ndarray]:
        """DISPATCH every pending request as one fused wave (duplicate vids
        share one gather), then DELIVER the previously in-flight wave.

        Returns the per-ticket results (ticket order) of the wave this call
        DELIVERED: the previous wave in pipelined mode (``[]`` when none was
        in flight), the just-dispatched wave itself when ``pipeline=False``.
        Every result is also retained for ``result(ticket)``.  Pending
        writes land first, as one ingest wave (``_flush_writes``)."""
        self._check_open()
        self._journal_watermark()
        # land the write wave FIRST: the read wave detached below then
        # plans against (and serves) the post-commit epoch.  A failed or
        # deferred write wave leaves the pending reads untouched.
        self._flush_writes()
        wave = self._pending
        self._pending = []
        dispatched = None
        bubbled: list[np.ndarray] = []
        if wave:
            # a PENDING trigger fire opens a one-wave pipeline bubble: an
            # unbroken flush-driven stream otherwise always has a successor
            # in flight at delivery time, and the migration would starve.
            # Draining here lets observe() run (nothing in flight) and the
            # dispatch below ride the NEW layout.
            fire = getattr(self.trigger, "should_fire", None)
            if (fire is not None and self._inflight is not None
                    and fire()):
                try:
                    bubbled = self.deliver()
                except BaseException:
                    # the bubble's delivery failure re-queued only the
                    # in-flight wave — restore THIS flush's detached wave
                    # too (global ticket order restored by sorting)
                    self._pending = sorted(self._pending + wave)
                    raise
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
        out = self._deliver_wave(prev) if prev is not None else bubbled
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
        if (ticket not in self._results
                and any(t == ticket for t, _, _ in self._pending_writes)):
            self.flush()      # a queued write ticket: land its wave now
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
        self._journal_watermark()    # final watermark record (advisory)
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

    # -- write plane -----------------------------------------------------------
    def _flush_writes(self) -> list[int]:
        """Land every queued write ticket as ONE ``commit_many`` ingest
        wave, mirroring the migration protocol: join the in-flight read
        wave (a commit retires the device superblock its kernel may still
        be reading), then enter the lease registry's ``draining()`` window
        so out-of-band leases deliver against the epoch they planned on
        before the ingest.  A drain timeout DEFERS the wave (re-queued,
        ``stats.commit_deferrals``); a commit failure re-queues and raises
        exactly like a failed read dispatch (deadline-gated retry).
        Returns the assigned vids ([] when deferred or nothing queued)."""
        if not self._pending_writes:
            return []
        batch, self._pending_writes = self._pending_writes, []
        if self._inflight is not None:
            self.deliver()
        reg = read_leases(self.store)
        try:
            if reg is None:     # attribute-less store: no leases to drain
                vids = self._commit([c for _, c, _ in batch])
            else:
                with reg.draining(self.store,
                                  self.write_drain_timeout_s) as drained:
                    if not drained:
                        self._pending_writes = batch + self._pending_writes
                        self._deadline_armed = False
                        self.stats.commit_deferrals += 1
                        return []
                    vids = self._commit([c for _, c, _ in batch])
        except KernelError as exc:
            # the commit landed before the kernel failed: deliver its vids
            # and do not re-queue (a retry would commit the versions twice)
            self._land_writes(batch, exc.committed_vids)
            raise
        except BaseException:
            self._pending_writes = batch + self._pending_writes
            self._deadline_armed = False
            self.stats.requeues += 1
            raise
        self._land_writes(batch, vids)
        return vids

    def _land_writes(self, batch: list, vids: list[int]) -> None:
        """Record a landed write wave: each ticket's vid and latency."""
        done = self._clock()
        self._results.update(zip((t for t, _, _ in batch),
                                 (np.int64(v) for v in vids)))
        self.stats.record_latencies([done - t0 for _, _, t0 in batch])
        self._evict_results()
        self.stats.commit_waves += 1
        self.stats.commits_ingested += len(batch)

    def _commit(self, commits: list) -> list[int]:
        """The ``commit_many`` call, retried under the policy.  The ingest
        fault sites (``ingest.extract``/``ingest.commit``) fire BEFORE any
        store mutation, so a retry replays into the identical commit;
        ``ingest.append`` is absorbed inside ``commit_many`` itself (a
        failed superblock extension evicts only that superblock).  A
        ``KernelError`` comes after the commit landed and is never
        retried."""
        if self.retry is None:
            return self.store.commit_many(commits)
        backoff = self.retry.backoff_s
        deadline = (None if self.retry.deadline_s is None
                    else self._clock() + self.retry.deadline_s)
        for k in range(max(1, self.retry.attempts)):
            try:
                return self.store.commit_many(commits)
            except KernelError:
                raise
            except Exception:
                self.stats.retries += 1
                if (k + 1 >= max(1, self.retry.attempts)
                        or (deadline is not None
                            and self._clock() >= deadline)):
                    raise
                logger.warning("commit attempt %d failed; backing off "
                               "%.3gs", k, backoff, exc_info=True)
                self.retry.sleep(backoff)
                backoff *= 2
        raise AssertionError("unreachable")  # pragma: no cover

    def _evict_results(self) -> None:
        """FIFO-evict unreserved results beyond ``RETAIN_RESULTS``."""
        if len(self._results) > RETAIN_RESULTS:
            for t in list(self._results):
                if len(self._results) <= RETAIN_RESULTS:
                    break
                if t not in self._reserved:
                    del self._results[t]

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
        self._evict_results()
        self.stats.waves_delivered += 1
        self.stats.rows_served += sum(len(m) for m in out)
        # group-layer accounting lands at DELIVERY, off the delta this
        # wave's dispatch captured
        self._apply_group_delta(wave.group_delta)
        # the density trigger runs BETWEEN DELIVERED waves only: when
        # flush() already put the next wave in flight, migrating now would
        # race its launched kernel — observe() runs at THAT wave's
        # delivery instead.  Migration evictions/pins a fired trigger
        # causes belong to this delivery's delta.
        if self.trigger is not None and self._inflight is None:
            g0 = self._group_counters()
            try:
                fired = self.trigger.observe() is not None
            except Exception as exc:
                # with a policy, a failed trigger must not poison an
                # already-delivered wave: the density streak survives the
                # failure (observe() raises before stats.reset()), so the
                # NEXT delivered wave simply retries the migration; a
                # kernel fault is not retried
                if self.retry is None or isinstance(exc, KernelError):
                    raise
                self.stats.trigger_failures += 1
                logger.warning("repartition trigger failed; will retry at "
                               "next delivered wave", exc_info=True)
                fired = False
            if fired:
                self.stats.repartitions += 1
            g1 = self._group_counters()
            self._apply_group_delta(tuple(b - a for a, b in zip(g0, g1)))
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
