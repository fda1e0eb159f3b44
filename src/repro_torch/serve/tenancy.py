"""Multi-tenant serve: N concurrent ``BatchedCheckoutServer``s over ONE
store, with admission control, quotas, fair scheduling and
epoch-consistent reads.

One ``BatchedCheckoutServer`` per store is a concurrency ceiling; the
``MultiTenantServer`` coordinator owns one thread-backed server PER TENANT
and threads four mechanisms between them:

  * ADMISSION CONTROL — ``submit(tenant, vid)`` is gated by the tenant's
    ``max_inflight`` ticket quota and a GLOBAL bounded backlog.  Breaching
    either SHEDS explicitly: ``QuotaExceeded``/``Overloaded`` surface to
    the caller instead of the queue growing unboundedly (the DataHub
    many-client hub workload dies by convoy without this).  Shed
    decisions are deterministic functions of admission state, so a
    fault-injected run sheds exactly what its fault-free oracle sheds.
  * FAIR SCHEDULING — a deficit-round-robin scheduler: each round, every
    backlogged tenant earns ``wave_share`` deficit and spends it in
    granted waves (one wave = up to ``max_wave`` tickets coalesced into
    one fused flush).  A 10:1 burst tenant gets its backlog through at
    its share, not at the other tenants' expense; ``grant_log`` is the
    auditable fairness record the tests and the Jain-index benchmark
    read.
  * CONCURRENT WAVES — per-tenant worker threads execute grants.  The
    dispatch half of every wave (plan + launch, group pin/evict, heat
    telemetry) is serialized under ONE store lock; the delivery join
    (device→host transfer + per-ticket split) runs OUTSIDE it, so tenant
    A's host split overlaps tenant B's dispatch — the cross-tenant
    analogue of the single-server dispatch/deliver pipeline.
    ``threads=False`` runs the same scheduler inline (``pump()``), which
    is what the deterministic tests and the serial oracles use.
  * EPOCH-CONSISTENT READS — every dispatched wave holds a per-epoch
    ``core.faults.ReadLease``; the coordinator's ``RepartitionTrigger``
    runs with ``drain_timeout_s`` set, so a migration DRAINS the current
    epoch's leases (new waves block briefly, in-flight waves deliver
    against the epoch they planned on) instead of racing them.
  * WRITE WAVES — ``submit_commit(tenant, commits)`` admits commits
    under the SAME backlog/quota gates and the DRR scheduler grants them
    as whole write waves (one deficit unit each, granted before the
    tenant's reads so a mixed backlog reads its own writes).  A granted
    write wave lands as ONE ``PartitionedCVD.commit_many`` ingest wave
    under the store lock; the tenant server's write plane drains the
    epoch's read leases first — other tenants' in-flight waves deliver
    on their worker threads OUTSIDE the store lock, so the drain makes
    progress — mirroring the migration protocol.

Pinned-byte shares: a tenant whose ``pinned_share`` of the group-layer
budget is exhausted (ownership attributed wave-by-wave: a pinned group is
charged to the tenant whose wave last touched it) dispatches through the
PERPART engine until its charge decays — results stay bit-identical (the
engines are result-equivalent by the engine-invariance tests); the tenant
just stops evicting other tenants' pinned groups to make room for its
own.  Combined with the heat-driven auto-regroup
(``core.checkout.SuperblockGroups.maybe_regroup``) this keeps one
tenant's hot set from permanently pinning another's out of budget.

Failure sites (``core.faults``): ``serve.admit`` fires before any
admission state changes, ``serve.shed`` before a shed is recorded,
``tenant.preempt`` when the scheduler ends a backlogged tenant's turn,
``lease.expire`` at drain entry — each is retried under the coordinator's
``RetryPolicy`` and leaves every tenant's delivered stream bit-identical
to its fault-free serial run (the tenancy fault sweep asserts this per
site, per tenant).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.checkout import _validate_vids, get_superblock_groups
from ..core.faults import fault_point, read_leases
from ..kernels.ops import resolve_device
from .checkout import BatchedCheckoutServer, RetryPolicy

logger = logging.getLogger(__name__)

# how many grants may sit queued per tenant worker before the scheduler
# stops crediting it: bounds how far grant order can run ahead of
# execution (fairness stays responsive to completions) without ever
# idling a worker between waves
GRANT_DEPTH = 2

_STOP = object()


class QuotaExceeded(RuntimeError):
    """A tenant breached its own ``max_inflight`` ticket quota — the
    request was shed before queueing anything.  Per-tenant: other tenants
    are unaffected."""

    def __init__(self, tenant: str, inflight: int, max_inflight: int):
        super().__init__(
            f"tenant {tenant!r} quota exceeded: {inflight} tickets "
            f"in flight >= max_inflight={max_inflight}")
        self.tenant = tenant
        self.inflight = inflight
        self.max_inflight = max_inflight


class Overloaded(RuntimeError):
    """The GLOBAL backlog bound was hit — the store is saturated and the
    request was shed.  Backpressure, not a bug: retry later."""

    def __init__(self, backlog: int, max_backlog: int):
        super().__init__(
            f"server overloaded: {backlog} queued tickets >= "
            f"max_backlog={max_backlog}")
        self.backlog = backlog
        self.max_backlog = max_backlog


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's resource envelope.

    max_inflight:  admitted-but-undelivered ticket cap (admission shed
                   above it: ``QuotaExceeded``).
    wave_share:    DRR weight — deficit earned per scheduler round while
                   backlogged; relative shares set the delivered-wave
                   ratio under contention.
    pinned_share:  fraction of the group-layer byte budget this tenant's
                   waves may hold pinned before they degrade to the
                   perpart engine (1.0 = unthrottled).
    max_wave:      tickets coalesced per granted wave (one fused flush).
    """
    max_inflight: int = 64
    wave_share: float = 1.0
    pinned_share: float = 1.0
    max_wave: int = 16

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1 ({self.max_inflight})")
        if not self.wave_share > 0:
            raise ValueError(f"wave_share must be > 0 ({self.wave_share})")
        if not 0 < self.pinned_share <= 1.0:
            raise ValueError(
                f"pinned_share must be in (0, 1] ({self.pinned_share})")
        if self.max_wave < 1:
            raise ValueError(f"max_wave must be >= 1 ({self.max_wave})")


@dataclasses.dataclass
class TenantStats:
    submitted: int = 0             # tickets admitted past both gates
    delivered: int = 0             # tickets whose result reached its future
    failed: int = 0                # tickets errored by a failed wave
    shed_overload: int = 0         # submits shed by the global backlog bound
    shed_quota: int = 0            # submits shed by max_inflight
    waves: int = 0                 # granted waves executed
    preempts: int = 0              # scheduler turns ended with backlog left
    pin_throttled_waves: int = 0   # waves degraded to perpart by pinned_share
    max_queue_depth: int = 0       # peak admitted-not-granted queue depth


@dataclasses.dataclass
class _Request:
    """One admitted ticket awaiting its result (a minimal future).

    ``event`` is LAZY: the admission path never pays for a
    ``threading.Event`` — ``result()`` creates one under the coordinator
    lock only when it has to block on an undelivered ticket, and the
    completion paths set it only if a waiter materialized one."""
    ticket: int
    vid: int                       # -1 for a write request (vid unknown
                                   # until its commit wave lands)
    done: bool = False
    event: Optional[threading.Event] = None
    value: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    server_ticket: Optional[int] = None
    commit: Optional[dict] = None  # the commit_many dict (write requests)


class _Tenant:
    """Coordinator-side per-tenant state (the server, the admission queue,
    the DRR deficit, the worker)."""

    def __init__(self, tenant_id: str, quota: TenantQuota,
                 server: BatchedCheckoutServer):
        self.id = tenant_id
        self.quota = quota
        self.server = server
        self.queue: collections.deque[_Request] = collections.deque()
        self.write_queue: collections.deque[_Request] = collections.deque()
        self.requests: dict[int, _Request] = {}
        self.next_ticket = 0
        self.inflight = 0          # admitted - (delivered + failed)
        self.deficit = 0.0
        self.stats = TenantStats()
        self.grants: "queue.Queue" = queue.Queue()
        self.worker: Optional[threading.Thread] = None


class MultiTenantServer:
    """N concurrent tenant servers over one store — see module docstring.

    quotas:    {tenant_id: TenantQuota} registered up front; ``register``
               adds more until the first submit.
    max_backlog: GLOBAL bound on admitted-not-yet-granted tickets across
               all tenants (the bounded-queue invariant: breach sheds
               ``Overloaded``).
    threads:   True = per-tenant worker threads + a scheduler thread
               (started lazily at the first submit, or explicitly via
               ``start()``).  False = inline mode: ``pump()`` (or
               ``result()``) runs the same DRR rounds on the calling
               thread — deterministic, what the tests and oracles use.
    retry:     coordinator-level ``RetryPolicy``, also passed to every
               tenant server — absorbs transient faults at the new
               concurrency sites exactly like the single-server ladder.
    trigger:   optional ``core.online.RepartitionTrigger`` owned by the
               COORDINATOR (tenant servers get trigger=None): it runs
               between scheduler rounds under the store lock, and should
               be constructed with ``drain_timeout_s`` set so migrations
               drain epoch leases instead of refusing forever under an
               unbroken cross-tenant stream.
    """

    def __init__(self, store, *, quotas: Optional[dict] = None,
                 max_backlog: int = 256, threads: bool = True,
                 use_kernel: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 trigger=None,
                 write_drain_timeout_s: Optional[float] = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_backlog < 1:
            raise ValueError(f"max_backlog must be >= 1 ({max_backlog})")
        # the tenants' waves run on the store's device: a store on the
        # card raises here when there is none, before any thread starts
        resolve_device(store.device)
        self.store = store
        self.max_backlog = int(max_backlog)
        self.threads = bool(threads)
        self.use_kernel = use_kernel
        self.retry = retry
        self.trigger = trigger
        # BOUNDED drain for tenant write waves (unlike the single-server
        # default of None): another tenant's in-flight wave delivers on
        # its own worker thread, but a wedged one must defer the commit,
        # not deadlock the scheduler
        self.write_drain_timeout_s = write_drain_timeout_s
        self._clock = clock
        self._tenants: dict[str, _Tenant] = {}
        # _lock guards admission state (queues, backlog, inflight counts);
        # _store_lock serializes every wave DISPATCH (and the migration
        # window) against the shared store — delivery joins run outside it
        self._lock = threading.Lock()
        self._store_lock = threading.Lock()
        # leaf lock for bare stat counters bumped from both planes; never
        # held across any other acquisition
        self._stats_lock = threading.Lock()
        self._backlog = 0
        self.peak_backlog = 0          # the bounded-queue invariant witness
        self.repartitions = 0
        self.trigger_failures = 0
        self.absorbed_faults = 0       # faults the retry guard absorbed
        self.scheduler_errors = 0      # _round failures absorbed on the
                                       # scheduler thread (retry=None only)
        self.grant_log: list[str] = []     # tenant id per granted wave
        self._pin_owner: dict[tuple, str] = {}
        self._closed = False
        self._started = False
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._scheduler: Optional[threading.Thread] = None
        # make the lease registry exist up front: every wave leases, and
        # the trigger's drain mode needs the registry attached
        read_leases(store)
        for tenant_id, quota in (quotas or {}).items():
            self.register(tenant_id, quota)

    # -- tenant registry -------------------------------------------------------
    def register(self, tenant_id: str,
                 quota: Optional[TenantQuota] = None) -> None:
        """Add a tenant (idempotent quota upgrade is NOT supported — a
        registered id raises)."""
        self._check_open()
        tenant_id = str(tenant_id)
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(f"tenant {tenant_id!r} already registered")
            srv = BatchedCheckoutServer(
                self.store, use_kernel=self.use_kernel, engine="wave",
                pipeline=True, retry=self.retry, tenant=tenant_id,
                write_drain_timeout_s=self.write_drain_timeout_s,
                clock=self._clock)
            t = _Tenant(tenant_id, quota or TenantQuota(), srv)
            self._tenants[tenant_id] = t
        if self._started and not t.worker:
            self._start_worker(t)

    def _tenant(self, tenant_id: str) -> _Tenant:
        t = self._tenants.get(str(tenant_id))
        if t is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return t

    def tenant_servers(self) -> dict:
        """``{tenant_id: BatchedCheckoutServer}`` — what lets
        ``core.durability.StoreDurability.snapshot(servers=...)`` take a
        ``MultiTenantServer`` directly and persist every tenant's ticket
        watermark.  Each server's counter is folded forward to cover the
        coordinator's ADMISSION counter too (tickets admitted but not yet
        granted never reached the server, but clients hold them — a
        restored server must not re-mint them).  Folding forward is safe:
        the counter only ever mints fresh ids."""
        with self._lock:
            for t in self._tenants.values():
                t.server._next_ticket = max(t.server._next_ticket,
                                            t.next_ticket)
            return {t.id: t.server for t in self._tenants.values()}

    # -- admission plane -------------------------------------------------------
    def submit(self, tenant_id: str, vid: int) -> int:
        """Admit one checkout request for ``tenant_id``; returns its
        per-tenant ticket (global identity: (tenant, ticket)).  Sheds with
        ``Overloaded``/``QuotaExceeded`` BEFORE queueing anything when the
        global backlog or the tenant quota is breached — both decisions
        read only admission state, so they replay identically in a
        fault-injected run."""
        self._check_open()
        t = self._tenant(tenant_id)
        (vid,) = _validate_vids(self.store, [vid])
        # fires before any admission state changes: an absorbed fault here
        # retries into the identical decision
        self._guard("serve.admit")
        with self._lock:
            if self._backlog >= self.max_backlog:
                self._shed_locked(t, quota=False)
            if t.inflight >= t.quota.max_inflight:
                self._shed_locked(t, quota=True)
            ticket = t.next_ticket
            t.next_ticket += 1
            req = _Request(ticket=ticket, vid=int(vid))
            t.queue.append(req)
            t.requests[ticket] = req
            t.inflight += 1
            t.stats.submitted += 1
            t.stats.max_queue_depth = max(t.stats.max_queue_depth,
                                          len(t.queue))
            self._backlog += 1
            self.peak_backlog = max(self.peak_backlog, self._backlog)
        self._kick()
        return ticket

    def submit_many(self, tenant_id: str, vids: Sequence[int]) -> list[int]:
        """Bulk admission — stops at the first shed (the already-admitted
        prefix stays queued and serviceable).  Unlike a ``submit`` loop,
        the batch is ONE admission event: vids validate vectorized, the
        ``serve.admit`` fault window opens once, and the queue fills
        under a single lock acquisition — the per-ticket shed decisions
        are unchanged."""
        self._check_open()
        t = self._tenant(tenant_id)
        if len(vids) == 0:
            return []
        arr = _validate_vids(self.store, vids)
        self._guard("serve.admit")
        tickets: list[int] = []
        shed_quota: Optional[bool] = None
        with self._lock:
            for v in arr:
                if self._backlog >= self.max_backlog:
                    shed_quota = False
                    break
                if t.inflight >= t.quota.max_inflight:
                    shed_quota = True
                    break
                ticket = t.next_ticket
                t.next_ticket += 1
                req = _Request(ticket=ticket, vid=int(v))
                t.queue.append(req)
                t.requests[ticket] = req
                t.inflight += 1
                t.stats.submitted += 1
                self._backlog += 1
                tickets.append(ticket)
            t.stats.max_queue_depth = max(t.stats.max_queue_depth,
                                          len(t.queue))
            self.peak_backlog = max(self.peak_backlog, self._backlog)
        if tickets:
            self._kick()
        if shed_quota is not None:
            with self._lock:
                self._shed_locked(t, quota=shed_quota)
        return tickets

    def submit_commit(self, tenant_id: str,
                      commits: Sequence[dict]) -> list[int]:
        """Admit a WRITE batch for ``tenant_id`` under the same gates as
        reads: each commit dict (the ``PartitionedCVD.commit_many``
        forms) costs one ticket against the global backlog bound and the
        tenant's ``max_inflight`` quota, shedding at the first breach
        (the admitted prefix stays queued and serviceable).  The DRR
        scheduler grants the queue as whole write waves — one deficit
        unit each, granted BEFORE the tenant's pending reads so a mixed
        backlog reads its own writes — and ``result(tenant, ticket)``
        yields the assigned vid once the wave lands."""
        self._check_open()
        t = self._tenant(tenant_id)
        commits = [dict(c) for c in commits]
        if not commits:
            return []
        self._guard("serve.admit")
        tickets: list[int] = []
        shed_quota: Optional[bool] = None
        with self._lock:
            for c in commits:
                if self._backlog >= self.max_backlog:
                    shed_quota = False
                    break
                if t.inflight >= t.quota.max_inflight:
                    shed_quota = True
                    break
                ticket = t.next_ticket
                t.next_ticket += 1
                req = _Request(ticket=ticket, vid=-1, commit=c)
                t.write_queue.append(req)
                t.requests[ticket] = req
                t.inflight += 1
                t.stats.submitted += 1
                self._backlog += 1
                tickets.append(ticket)
            t.stats.max_queue_depth = max(
                t.stats.max_queue_depth,
                len(t.queue) + len(t.write_queue))
            self.peak_backlog = max(self.peak_backlog, self._backlog)
        if tickets:
            self._kick()
        if shed_quota is not None:
            with self._lock:
                self._shed_locked(t, quota=shed_quota)
        return tickets

    def _shed_locked(self, t: _Tenant, *, quota: bool) -> None:
        # the serve.shed fault fires BEFORE the shed is recorded: an
        # absorbed fault retries into the same (deterministic) shed
        self._guard("serve.shed")
        if quota:
            t.stats.shed_quota += 1
            raise QuotaExceeded(t.id, t.inflight, t.quota.max_inflight)
        t.stats.shed_overload += 1
        raise Overloaded(self._backlog, self.max_backlog)

    def _guard(self, site: str) -> None:
        """A coordinator fault point: with a retry policy, transient
        injected faults are absorbed with bounded backoff (mirroring the
        single-server ladder); without one they propagate to the caller."""
        if self.retry is None:
            fault_point(site, self.store)
            return
        backoff = self.retry.backoff_s
        for k in range(max(1, self.retry.attempts)):
            try:
                fault_point(site, self.store)
                return
            except Exception:
                with self._stats_lock:
                    self.absorbed_faults += 1
                if k + 1 >= max(1, self.retry.attempts):
                    raise
                logger.warning("fault at %s absorbed (attempt %d); backing "
                               "off %.3gs", site, k, backoff, exc_info=True)
                self.retry.sleep(backoff)
                backoff *= 2

    # -- results plane ---------------------------------------------------------
    def result(self, tenant_id: str, ticket: int,
               timeout: Optional[float] = None) -> np.ndarray:
        """Claim (and drop) one admitted ticket's materialized version.
        Inline mode pumps the scheduler until the ticket resolves;
        threaded mode blocks up to ``timeout``.  A ticket whose wave
        failed re-raises that wave's error."""
        t = self._tenant(tenant_id)
        with self._lock:
            req = t.requests.get(int(ticket))
        if req is None:
            raise KeyError(f"unknown ticket {ticket} for tenant "
                           f"{tenant_id!r}")
        if not req.done:
            if self.threads and self._started:
                # materialize the lazy event under the lock (the
                # completion paths mark done + read the event under the
                # same lock, so the wake cannot be missed)
                with self._lock:
                    ev = None
                    if not req.done:
                        if req.event is None:
                            req.event = threading.Event()
                        ev = req.event
                if ev is not None and not ev.wait(timeout):
                    raise TimeoutError(
                        f"ticket {ticket} of tenant {tenant_id!r} not "
                        f"delivered within {timeout}s")
            else:
                self.pump()
                if not req.done:
                    raise RuntimeError(
                        f"pump() made no progress on ticket {ticket} of "
                        f"tenant {tenant_id!r}")
        with self._lock:
            t.requests.pop(int(ticket), None)
        if req.error is not None:
            raise req.error
        return req.value

    def results(self, tenant_id: str, tickets: Sequence[int],
                timeout: Optional[float] = None) -> list[np.ndarray]:
        """Batch ``result`` — one lock pass to look up and one to claim
        the whole list (``timeout`` is a shared deadline, not
        per-ticket).  The first failed ticket's error re-raises after the
        batch is claimed."""
        t = self._tenant(tenant_id)
        tickets = [int(tk) for tk in tickets]
        threaded = self.threads and self._started
        with self._lock:
            reqs = []
            for tk in tickets:
                req = t.requests.get(tk)
                if req is None:
                    raise KeyError(f"unknown ticket {tk} for tenant "
                                   f"{tenant_id!r}")
                reqs.append(req)
            pending = [r for r in reqs if not r.done]
            if threaded:
                for r in pending:
                    if r.event is None:
                        r.event = threading.Event()
        if pending:
            if threaded:
                deadline = (None if timeout is None
                            else self._clock() + timeout)
                for r in pending:
                    left = (None if deadline is None
                            else max(0.0, deadline - self._clock()))
                    if not r.event.wait(left):
                        raise TimeoutError(
                            f"ticket {r.ticket} of tenant {tenant_id!r} "
                            f"not delivered within {timeout}s")
            else:
                self.pump()
                if any(not r.done for r in pending):
                    raise RuntimeError(
                        f"pump() made no progress on tickets of tenant "
                        f"{tenant_id!r}")
        with self._lock:
            for tk in tickets:
                t.requests.pop(tk, None)
        out = []
        for r in reqs:
            if r.error is not None:
                raise r.error
            out.append(r.value)
        return out

    # -- scheduler -------------------------------------------------------------
    def pump(self, max_rounds: Optional[int] = None) -> int:
        """Inline scheduling: run DRR rounds on the calling thread until
        the backlog drains (or ``max_rounds``).  Returns granted waves.
        The deterministic twin of the scheduler thread — also the drain
        loop ``close()`` uses."""
        total = 0
        rounds = 0
        while True:
            granted = self._round(inline=True)
            total += granted
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
            with self._lock:
                empty = self._backlog == 0
            if empty and not granted:
                break
        return total

    def _take_batch(self, t: _Tenant) -> list[_Request]:
        with self._lock:
            n = min(len(t.queue), t.quota.max_wave)
            batch = [t.queue.popleft() for _ in range(n)]
            self._backlog -= n
        return batch

    def _take_write_batch(self, t: _Tenant) -> list[_Request]:
        with self._lock:
            n = min(len(t.write_queue), t.quota.max_wave)
            batch = [t.write_queue.popleft() for _ in range(n)]
            self._backlog -= n
        return batch

    def _round(self, *, inline: bool) -> int:
        """ONE deficit-round-robin round: every backlogged tenant earns
        its share and spends whole units as granted waves; then the
        migration window.  Registration order fixes the intra-round tenant
        order (deterministic)."""
        granted = 0
        for t in list(self._tenants.values()):
            with self._lock:
                backlog = len(t.queue) + len(t.write_queue)
            if backlog == 0:
                # DRR without credit hoarding: an idle tenant must not
                # bank deficit and burst past everyone when it returns
                t.deficit = 0.0
                continue
            if not inline and t.grants.qsize() >= GRANT_DEPTH:
                continue            # worker saturated: credit postponed
            t.deficit += t.quota.wave_share
            while t.deficit >= 1.0:
                # writes first: a mixed backlog reads its own commits
                batch = self._take_write_batch(t) or self._take_batch(t)
                if not batch:
                    break
                t.deficit -= 1.0
                self.grant_log.append(t.id)
                granted += 1
                if inline:
                    self._execute_wave(t, batch)
                else:
                    t.grants.put(batch)
                    if t.grants.qsize() >= GRANT_DEPTH:
                        break
            with self._lock:
                leftover = len(t.queue) + len(t.write_queue)
            if leftover:
                # deficit spent, backlog remains: this turn is preempted
                # until the next round — accounting only, nothing granted
                # is affected
                self._guard("tenant.preempt")
                t.stats.preempts += 1
        self._maybe_migrate()
        return granted

    def _engine_for_locked(self, t: _Tenant) -> str:
        """Pinned-share throttle (store lock held): a tenant past its
        share of the group budget dispatches perpart — no new pins, no
        evicting other tenants' groups, results unchanged."""
        if t.quota.pinned_share >= 1.0:
            return "wave"
        mgr = get_superblock_groups(self.store)
        if mgr is None:
            return "wave"
        charge = self._pin_charge_locked(t.id)
        if charge > t.quota.pinned_share * mgr.budget:
            t.stats.pin_throttled_waves += 1
            return "perpart"
        return "wave"

    def _pin_charge_locked(self, tenant_id: str) -> int:
        """Bytes of pinned groups charged to ``tenant_id`` (owner = tenant
        whose wave last touched the group).  Evicted groups drop off the
        ownership map here, so ownership never outlives the pin.  Store
        lock held: pruning here races with nothing that pins."""
        mgr = get_superblock_groups(self.store)
        if mgr is None:
            return 0
        self._pin_owner = {k: v for k, v in self._pin_owner.items()
                           if k in mgr.groups}
        return sum(int(mgr.groups[k].host.nbytes)
                   for k, v in self._pin_owner.items() if v == tenant_id)

    def _pin_charge_view(self, tenant_id: str) -> int:
        """Read-only pin charge for accounting: same figure as
        ``_pin_charge_locked`` but without pruning, so it is safe under
        ``_lock`` while a wave on the store plane reassigns ownership."""
        mgr = get_superblock_groups(self.store)
        if mgr is None:
            return 0
        owners = dict(self._pin_owner)
        return sum(int(mgr.groups[k].host.nbytes)
                   for k, v in owners.items()
                   if v == tenant_id and k in mgr.groups)

    def _charge_pins_locked(self, t: _Tenant,
                            batch: Sequence[_Request]) -> None:
        mgr = get_superblock_groups(self.store)
        if mgr is None:
            return
        for r in batch:
            pid = int(self.store.vid_to_pid[int(r.vid)])
            key = mgr.pid_to_group.get(pid)
            if key is not None and key in mgr.groups:
                self._pin_owner[key] = t.id

    def _execute_wave(self, t: _Tenant, batch: list[_Request]) -> None:
        """One granted wave end to end: dispatch under the store lock,
        deliver (join + split + fulfill) outside it.  A failed wave errors
        its batch's futures and rolls the admission accounting — it never
        kills the worker or the scheduler."""
        if batch and batch[0].commit is not None:
            # granted batches are homogeneous: a write wave comes whole
            # from _take_write_batch
            return self._execute_commit_wave(t, batch)
        vids = [r.vid for r in batch]
        try:
            with self._store_lock:
                engine = self._engine_for_locked(t)
                prev_engine = t.server.engine
                t.server.engine = engine
                try:
                    tickets = t.server.submit_many(vids)
                    for r, tk in zip(batch, tickets):
                        r.server_ticket = tk
                        t.server._reserved.add(tk)
                    t.server.flush()     # dispatch; lease held until joined
                finally:
                    t.server.engine = prev_engine
                self._charge_pins_locked(t, batch)
            t.server.deliver()           # join OUTSIDE the store lock
            for r in batch:
                r.value = t.server.result(r.server_ticket)
            self._complete_batch(t, batch, delivered=True)
        except BaseException as exc:
            self._fail_batch(t, batch, exc)

    def _execute_commit_wave(self, t: _Tenant,
                             batch: list[_Request]) -> None:
        """One granted WRITE wave: the tenant server lands the whole
        batch as ONE ``commit_many`` ingest wave under the store lock.
        Its write plane first drains the epoch's read leases (bounded by
        ``write_drain_timeout_s``) — other tenants' in-flight waves
        deliver on their own worker threads OUTSIDE the store lock, so
        the drain makes progress — and a drain that still times out
        surfaces as a failed wave (the coordinator owns retries).
        Futures resolve to the assigned vids."""
        try:
            with self._store_lock:
                tickets = t.server.submit_commit(
                    [r.commit for r in batch])
                for r, tk in zip(batch, tickets):
                    r.server_ticket = tk
                    t.server._reserved.add(tk)
                t.server.flush()
                if t.server._pending_writes:
                    raise RuntimeError(
                        "commit wave deferred: epoch read leases did "
                        "not drain within write_drain_timeout_s")
            for r in batch:
                r.value = t.server.result(r.server_ticket)
            self._complete_batch(t, batch, delivered=True)
        except BaseException as exc:
            self._fail_batch(t, batch, exc)

    def _fail_batch(self, t: _Tenant, batch: Sequence[_Request],
                    exc: BaseException) -> None:
        """Error out one failed wave: the tenant server re-queued the
        tickets internally, but the coordinator owns retries — drop the
        server-side requeue, release the reservations, and surface the
        error through every future."""
        t.server._pending.clear()
        t.server._pending_writes.clear()
        for r in batch:
            if r.server_ticket is not None:
                t.server._reserved.discard(r.server_ticket)
            r.error = exc
        self._complete_batch(t, batch, delivered=False)
        logger.warning("wave of %d tickets failed for tenant %r",
                       len(batch), t.id, exc_info=exc)

    def _complete_batch(self, t: _Tenant, batch: Sequence[_Request],
                        *, delivered: bool) -> None:
        """Mark a wave's futures done and roll the books (one lock pass);
        wake only the waiters that actually materialized an event."""
        with self._lock:
            events = []
            for r in batch:
                r.done = True
                if r.event is not None:
                    events.append(r.event)
            t.inflight -= len(batch)
            if delivered:
                t.stats.delivered += len(batch)
                t.stats.waves += 1
            else:
                t.stats.failed += len(batch)
        for ev in events:
            ev.set()

    def _maybe_migrate(self) -> None:
        """The migration window, between rounds: the coordinator-owned
        trigger observes under the store lock (no new dispatches) and —
        constructed with ``drain_timeout_s`` — drains the epoch's read
        leases before landing.  Failures are absorbed under the retry
        policy (streak survives; next round retries)."""
        trig = self.trigger
        if trig is None:
            return
        should = getattr(trig, "should_fire", None)
        if should is not None and not should():
            return
        try:
            with self._store_lock:
                fired = trig.observe() is not None
        except Exception:
            if self.retry is None:
                raise
            self.trigger_failures += 1
            logger.warning("coordinator trigger failed; retrying next "
                           "round", exc_info=True)
            return
        if fired:
            self.repartitions += 1

    # -- threads ---------------------------------------------------------------
    def start(self) -> None:
        """Start the scheduler + one worker per registered tenant
        (``threads=True`` only; submit() calls this lazily)."""
        if not self.threads or self._started:
            return
        self._check_open()
        self._started = True
        for t in self._tenants.values():
            self._start_worker(t)
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="tenancy-scheduler",
            daemon=True)
        self._scheduler.start()

    def _start_worker(self, t: _Tenant) -> None:
        t.worker = threading.Thread(
            target=self._worker_loop, args=(t,),
            name=f"tenant-{t.id}", daemon=True)
        t.worker.start()

    def _kick(self) -> None:
        if self.threads:
            self.start()
            self._wake.set()

    def _scheduler_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                granted = self._round(inline=False)
            except Exception:
                # retry=None faults land here on the scheduler thread —
                # absorb and count (there is no caller to raise to); the
                # affected turn simply retries next round
                self.scheduler_errors += 1
                logger.warning("scheduler round failed", exc_info=True)
                granted = 0
            if not granted:
                self._wake.wait(0.002)
                self._wake.clear()

    def _worker_loop(self, t: _Tenant) -> None:
        while True:
            grant = t.grants.get()
            try:
                if grant is _STOP:
                    return
                self._execute_wave(t, grant)
            finally:
                t.grants.task_done()

    # -- shutdown --------------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("MultiTenantServer is closed")

    @property
    def closed(self) -> bool:
        return self._closed

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted ticket is delivered or failed (the
        backlog AND the grant queues are empty).  Inline mode pumps;
        threaded mode waits on the scheduler/workers.  False on
        timeout."""
        if not (self.threads and self._started):
            self.pump()
            return True
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            with self._lock:
                backlog = self._backlog
                inflight = sum(t.inflight for t in self._tenants.values())
            if backlog == 0 and inflight == 0:
                return True
            if deadline is not None and self._clock() >= deadline:
                return False
            self._wake.set()
            time.sleep(0.001)

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Shut down: optionally drain, stop the threads, close every
        tenant server, and error out any ticket that will never deliver.
        Idempotent.  After close the accounting MUST balance:
        zero backlog, zero inflight tickets, zero held leases, zero
        reservations — ``accounting()`` is the auditable record."""
        if self._closed:
            return
        if drain:
            self.drain(timeout)
        self._closed = True
        if self._started:
            self._stop_evt.set()
            self._wake.set()
            if self._scheduler is not None:
                self._scheduler.join(timeout=5.0)
            for t in self._tenants.values():
                t.grants.put(_STOP)
            for t in self._tenants.values():
                if t.worker is not None:
                    t.worker.join(timeout=5.0)
        # error out whatever never got granted/delivered, roll the books
        closed_exc = RuntimeError("MultiTenantServer closed")
        with self._lock:
            for t in self._tenants.values():
                for q in (t.queue, t.write_queue):
                    while q:
                        req = q.popleft()
                        self._backlog -= 1
                        t.inflight -= 1
                        t.stats.failed += 1
                        req.error = closed_exc
                        req.done = True
                        if req.event is not None:
                            req.event.set()
        for t in self._tenants.values():
            t.server.close()

    def __enter__(self) -> "MultiTenantServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ---------------------------------------------------------
    def warmup(self) -> None:
        """Pre-pin the store's superblock/group layer once (any tenant's
        server — the layer is shared)."""
        if not self._tenants:
            return
        with self._store_lock:
            next(iter(self._tenants.values())).server.warmup()

    def stats(self, tenant_id: str) -> TenantStats:
        return self._tenant(tenant_id).stats

    def accounting(self) -> dict:
        """The balance sheet the tests audit: per-tenant queue/inflight/
        reservation counts, pinned-byte charges, global backlog and lease
        state.  After ``close()`` every balance is zero."""
        reg = read_leases(self.store, create=False)
        mgr = get_superblock_groups(self.store)
        with self._lock:
            tenants = {}
            for t in self._tenants.values():
                tenants[t.id] = {
                    "queued": len(t.queue) + len(t.write_queue),
                    "inflight": t.inflight,
                    "reserved": len(t.server._reserved),
                    "deficit": t.deficit,
                    "pin_bytes": self._pin_charge_view(t.id),
                    "stats": t.stats,
                }
            owned = sum(v["pin_bytes"] for v in tenants.values())
            return {
                "backlog": self._backlog,
                "peak_backlog": self.peak_backlog,
                "leases_held": 0 if reg is None else reg.held(),
                "pinned_bytes": 0 if mgr is None else mgr.pinned_bytes,
                "owned_pin_bytes": owned,
                "tenants": tenants,
            }


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant delivered counts: 1.0 =
    perfectly even, 1/n = one tenant took everything."""
    v = np.asarray(list(values), np.float64)
    if v.size == 0 or not np.any(v):
        return 1.0
    return float(v.sum() ** 2 / (v.size * (v ** 2).sum()))
