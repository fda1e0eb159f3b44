"""Deterministic fault injection + runtime guards for the serve/migration
pipeline.

The wave engine's stateful failure sites (superblock upload, wave launch,
group pin/evict, incremental migration, serve dispatch/delivery/transfer,
trigger fire, migration commit) were each hardened ad hoc as bugs surfaced.
This module makes the failure surface explicit and exercisable:

  * ``SITES`` is the catalogue of named failure points threaded through
    ``core.checkout``, ``core.partition``, ``core.online``,
    ``core.journal`` and ``serve.checkout`` via ``fault_point(site)`` — a
    no-op (one module global read) unless a plan is armed;
  * ``FaultPlan`` is a DETERMINISTIC schedule of which hit of which site
    raises ``InjectedFault``: an explicit ``{site: [hit indices]}`` map
    (``FaultPlan.single`` for the one-fault case the recovery tests sweep),
    or a seeded pseudo-random schedule (``FaultPlan.seeded`` — same seed,
    same faults, every run; the CI fault matrix sweeps ``REPRO_FAULT_SEED``);
  * ``GuardedCounter`` replaces bare-int shared counters (the store's
    ``_inflight_waves``): decrementing below zero clamps at 0, counts the
    underflow and warns (``strict=True`` raises instead) — a silent
    negative count would disarm the migration trigger's in-flight gate
    forever.  All mutations run under a ``threading.Lock``: N concurrent
    servers flush against the same counter;
  * ``EpochReadLeases`` generalizes that counter into per-EPOCH read
    leases — the snapshot-consistency contract of the multi-tenant serve
    layer.  Every dispatched wave holds a ``ReadLease`` pinned to the
    store epoch it planned against; a migration DRAINS the current
    epoch's leases (``draining``) instead of racing them, and the lease
    layer keeps ``store._inflight_waves`` (the total) mirrored so every
    legacy bare-int gate keeps working unchanged.

A plan is armed either process-wide (``with plan.armed(): ...`` — what the
tests and the CI fault matrix use) or per store (``install(store, plan)``)
for sites that have the store in hand.  ``InjectedFault`` subclasses
``RuntimeError``: by contract it models a TRANSIENT failure (a flaky DMA,
an allocator hiccup, a preempted transfer), so the serve layer's bounded
retry / degradation ladder is expected to absorb it — the recovery suite
asserts delivered results stay bit-identical to a fault-free run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# The failure-site catalogue.  Names are stable test/CI surface — add, don't
# rename.  Each site is documented at its fault_point() call site; the
# data-flow view lives in core/checkout.py's module docstring.
SITES = (
    "superblock.upload",    # Superblock.device(): host->device transfer
    "wave.launch",          # checkout_wave pallas_call launch
    "group.pin",            # SuperblockGroups.pin: group superblock build+pin
    "group.evict",          # SuperblockGroups._evict: LRU/device release
    "migrate.superblock",   # migrate_superblock: incremental device rebuild
    "serve.dispatch",       # BatchedCheckoutServer.flush dispatch stage
    "serve.delivery",       # BatchedCheckoutServer._deliver_wave entry
    "serve.transfer",       # _WavePart.split: device->host transfer + split
    "online.trigger",       # RepartitionTrigger.observe: pre-migration work
    "migration.commit",     # PartitionedCVD.apply_migration: stage->commit
    # multi-tenant concurrency sites (serve/tenancy.py + the lease layer)
    "serve.admit",          # MultiTenantServer.submit: admission control
    "serve.shed",           # MultiTenantServer.submit: backpressure shed
    "tenant.preempt",       # DRR scheduler ending a backlogged tenant's turn
    "lease.expire",         # EpochReadLeases.draining: pre-drain entry
    # write-ahead journal + disk-integrity sites (core/journal.py)
    "journal.append",       # Journal.append: before any bytes are written
    "journal.fsync",        # Journal.append: after the buffered write,
                            # before the fsync (bytes repaired by truncate)
    "journal.replay",       # journal.replay_into entry: before any record
                            # is applied to the restored store
    "disk.torn_write",      # Journal._write_frame: a HALF frame hits disk
                            # first — the repair/reader truncation cleans it
    "disk.bitflip",         # Journal._write_frame: a corrupted frame hits
                            # disk first — crc catches it on read
    # commit ingestion-wave sites (PartitionedCVD.commit_many + the
    # in-place superblock append in core/checkout.py)
    "ingest.extract",       # commit_many: staging/delta-extraction entry,
                            # before anything durable — store untouched
    "ingest.append",        # extend_group_superblocks: in-place device
                            # append — failure degrades to group eviction
    "ingest.commit",        # commit_version/commit_many: stage->journal
                            # boundary — store AND journal still untouched
)


class InjectedFault(RuntimeError):
    """A deterministic, by-contract TRANSIENT failure raised by an armed
    ``FaultPlan`` — retrying the failed operation is expected to succeed
    (the plan fires each scheduled (site, hit) pair exactly once)."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at {site!r} (hit #{hit})")
        self.site = site
        self.hit = hit


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One fault a plan actually fired."""
    site: str
    hit: int


class FaultPlan:
    """A deterministic schedule of injected failures.

    ``schedule`` maps a site name to the 0-based HIT indices that raise:
    ``{"wave.launch": [0, 2]}`` fails the first and third wave launch the
    process attempts after arming.  Per-site hit counters live on the plan,
    so the same plan object replayed over the same code path fires the same
    faults — and a fired (site, hit) pair never fires twice.  ``max_faults``
    bounds the TOTAL faults fired (``single``/``seeded`` default to 1: the
    single-fault recovery contract).
    """

    def __init__(self, schedule: Optional[dict] = None, *,
                 max_faults: Optional[int] = None):
        sched: dict[str, frozenset[int]] = {}
        for site, hits in (schedule or {}).items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} "
                                 f"(catalogue: {', '.join(SITES)})")
            sched[site] = frozenset(int(h) for h in hits)
        self.schedule = sched
        self.max_faults = max_faults
        self.hits: dict[str, int] = {}
        self.fired: list[FaultRecord] = []
        # N tenant workers hit the same armed plan concurrently: hit
        # counting must stay exact or the "fires exactly once" contract
        # (and the single-fault sweep built on it) silently breaks
        self._lock = threading.Lock()

    @classmethod
    def single(cls, site: str, nth: int = 0) -> "FaultPlan":
        """Fail exactly the ``nth`` hit of ``site`` — the unit the recovery
        sweep exercises per catalogued site."""
        return cls({site: [nth]}, max_faults=1)

    @classmethod
    def seeded(cls, seed: int, *, sites: Optional[Sequence[str]] = None,
               rate: float = 0.25, horizon: int = 32,
               max_faults: Optional[int] = 1) -> "FaultPlan":
        """A pseudo-random but fully deterministic schedule: for each site,
        every hit index below ``horizon`` fails with probability ``rate``
        under a generator derived from (seed, site) — the same seed
        produces the same schedule on every run and platform, which is what
        lets CI sweep ``REPRO_FAULT_SEED`` reproducibly."""
        sched: dict[str, list[int]] = {}
        for site in (tuple(sites) if sites is not None else SITES):
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}")
            # derive a per-site stream from (seed, site) so adding a site
            # never shifts another site's schedule
            rng = np.random.default_rng(
                [int(seed)] + [ord(c) for c in site])
            idx = np.flatnonzero(rng.random(int(horizon)) < rate)
            if len(idx):
                sched[site] = idx.tolist()
        return cls(sched, max_faults=max_faults)

    def check(self, site: str) -> None:
        """Count one hit of ``site``; raise iff the schedule says so (and
        the total-fault bound is not exhausted).  Thread-safe: the count/
        fire decision is atomic under the plan lock."""
        with self._lock:
            n = self.hits.get(site, 0)
            self.hits[site] = n + 1
            if (self.max_faults is not None
                    and len(self.fired) >= self.max_faults):
                return
            if n not in self.schedule.get(site, ()):
                return
            rec = FaultRecord(site, n)
            self.fired.append(rec)
        logger.debug("firing %s", rec)
        raise InjectedFault(site, n)

    @contextlib.contextmanager
    def armed(self):
        """Arm this plan process-wide for the dynamic extent of the block."""
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlan(schedule={dict(sorted(self.schedule.items()))}, "
                f"fired={self.fired})")


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def install(store, plan: Optional[FaultPlan]) -> None:
    """Attach (or with None, detach) a plan to one store — per-store
    injection for sites that carry the store; a process-wide armed plan
    takes precedence."""
    store._fault_plan = plan


def fault_point(site: str, owner=None) -> None:
    """The injection hook threaded through the pipeline.  Free when no plan
    is armed; with one armed, counts the hit and raises when scheduled."""
    plan = _ACTIVE
    if plan is None and owner is not None:
        plan = getattr(owner, "_fault_plan", None)
    if plan is not None:
        plan.check(site)


# ----------------------------------------------------------- guarded counter --

class GuardedCounter:
    """A non-negative shared counter that refuses to go silently negative.

    The store-level ``_inflight_waves`` count gates migrations (a negative
    value reads as "nothing in flight" FOREVER after one double-release,
    silently re-opening the migrate-under-a-running-kernel race the
    in-flight gate exists to close).  ``decr`` below zero clamps at 0,
    bumps ``underflows`` and warns; ``strict=True`` raises instead (what
    the regression tests pin).
    Reads interoperate with bare-int call sites: ``int()``, ``bool()`` and
    ``==`` against ints all work, so ``int(getattr(store,
    "_inflight_waves", 0) or 0)`` sees the same values it always did.
    Mutations are atomic under a per-counter ``threading.Lock`` — N
    concurrent servers incrementing the shared count with bare ``+=``
    would lose updates (the load/add/store interleaves)."""

    __slots__ = ("value", "name", "strict", "underflows", "_lock")

    def __init__(self, value: int = 0, *, name: str = "inflight_waves",
                 strict: bool = False):
        if value < 0:
            raise ValueError(f"{name} cannot start negative ({value})")
        self.value = int(value)
        self.name = name
        self.strict = strict
        self.underflows = 0
        self._lock = threading.Lock()

    def incr(self, n: int = 1) -> int:
        with self._lock:
            self.value += int(n)
            return self.value

    def decr(self, n: int = 1) -> int:
        with self._lock:
            nxt = self.value - int(n)
            if nxt < 0:
                self.underflows += 1
                if self.strict:
                    raise RuntimeError(
                        f"{self.name} underflow: {self.value} - {int(n)} < 0 "
                        "(double release)")
                logger.warning("%s underflow clamped: %d - %d < 0 "
                               "(double release?)", self.name, self.value,
                               int(n))
                nxt = 0
            self.value = nxt
            return self.value

    def adjust(self, delta: int) -> int:
        return self.incr(delta) if delta >= 0 else self.decr(-delta)

    def __int__(self) -> int:
        return self.value

    __index__ = __int__

    def __bool__(self) -> bool:
        return self.value > 0

    def __eq__(self, other) -> bool:
        if isinstance(other, GuardedCounter):
            return self.value == other.value
        if isinstance(other, (int, np.integer)):
            return self.value == int(other)
        return NotImplemented

    __hash__ = None  # mutable: not hashable

    def __repr__(self) -> str:
        return (f"GuardedCounter({self.value}, name={self.name!r}, "
                f"underflows={self.underflows})")


def inflight_counter(store) -> Optional[GuardedCounter]:
    """The store's ``_inflight_waves`` as a ``GuardedCounter``, upgrading a
    legacy bare int in place (tests and older callers assign plain ints).
    None when the store forbids attributes."""
    cur = getattr(store, "_inflight_waves", None)
    if isinstance(cur, GuardedCounter):
        return cur
    counter = GuardedCounter(int(cur or 0))
    try:
        store._inflight_waves = counter
    except AttributeError:
        return None
    return counter


# --------------------------------------------------------- epoch read leases --

# How long acquire() politely waits for an in-progress drain before
# proceeding anyway.  Waiting forever would let a wedged migration deadlock
# the serve plane; proceeding re-arms the in-flight gate, so the migration
# simply retries at the next quiet point — availability over a stall.
ACQUIRE_DRAIN_WAIT_S = 5.0


class ReadLease:
    """One wave's claim on the store epoch it planned against.  Created by
    ``EpochReadLeases.acquire`` (or the degenerate counter-only fallback);
    ``release()`` is IDEMPOTENT — the serve layer's close/deliver paths may
    both run, and a double release must not underflow the shared count."""

    __slots__ = ("epoch", "_registry", "_counter", "_released")

    def __init__(self, epoch: int, registry: "Optional[EpochReadLeases]",
                 counter: Optional[GuardedCounter]):
        self.epoch = int(epoch)
        self._registry = registry
        self._counter = counter
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._registry is not None:
            self._registry._release(self)
        elif self._counter is not None:
            self._counter.decr()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "released" if self._released else "held"
        return f"ReadLease(epoch={self.epoch}, {state})"


class EpochReadLeases:
    """Per-epoch read leases over one store: the snapshot-consistency half
    of the multi-tenant serve layer.

    Every dispatched wave ``acquire()``s a lease pinned to the epoch its
    plan was built against; the lease mirrors itself onto the store's
    ``_inflight_waves`` ``GuardedCounter`` (the TOTAL across epochs), so
    every pre-existing bare-int gate — ``RepartitionTrigger.observe()``'s
    refusal, the trigger tests' plain-int assignments — keeps holding
    without change.  A migration coordinator enters ``draining()``: new
    acquisitions at the CURRENT epoch block, the per-epoch count drains to
    zero (every admitted wave delivers against the layout it planned on),
    and only then does the migration land.  A drain that cannot complete
    within its timeout yields False — the migration defers to the next
    quiet point instead of racing a straggler kernel."""

    def __init__(self):
        self._cv = threading.Condition()
        self.per_epoch: dict[int, int] = {}
        self._draining: Optional[int] = None
        # all-time accounting (the tenancy tests balance these)
        self.acquired = 0
        self.released = 0
        self.drains = 0
        self.drain_timeouts = 0

    def held(self, epoch: Optional[int] = None) -> int:
        with self._cv:
            if epoch is None:
                return sum(self.per_epoch.values())
            return self.per_epoch.get(int(epoch), 0)

    def acquire(self, store) -> ReadLease:
        """A lease on the store's CURRENT epoch.  While that exact epoch is
        being drained the acquisition waits (bounded — see
        ``ACQUIRE_DRAIN_WAIT_S``) so a landing migration wins the race; a
        migration that already bumped the epoch unblocks immediately (the
        new wave plans against the NEW layout)."""
        counter = inflight_counter(store)
        with self._cv:
            deadline = time.monotonic() + ACQUIRE_DRAIN_WAIT_S
            while (self._draining is not None
                   and int(getattr(store, "epoch", 0)) == self._draining):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logger.warning(
                        "read-lease acquire proceeding past a wedged drain "
                        "of epoch %d", self._draining)
                    break
                self._cv.wait(remaining)
            epoch = int(getattr(store, "epoch", 0))
            self.per_epoch[epoch] = self.per_epoch.get(epoch, 0) + 1
            self.acquired += 1
        if counter is not None:
            counter.incr()
        return ReadLease(epoch, self, counter)

    def _release(self, lease: ReadLease) -> None:
        with self._cv:
            n = self.per_epoch.get(lease.epoch, 0) - 1
            if n > 0:
                self.per_epoch[lease.epoch] = n
            else:
                self.per_epoch.pop(lease.epoch, None)
            self.released += 1
            self._cv.notify_all()
        if lease._counter is not None:
            lease._counter.decr()

    @contextlib.contextmanager
    def draining(self, store, timeout_s: Optional[float]):
        """Migration-side drain window.  Yields True once every lease on
        the store's current epoch is released (new acquisitions at that
        epoch are blocked for the dynamic extent); yields False when the
        drain timed out — the caller must defer the migration.  The
        ``lease.expire`` fault point fires at entry: an injected failure
        here models the drain machinery itself hiccuping, and must leave
        leases and gates untouched (nothing has been blocked yet)."""
        fault_point("lease.expire", store)
        with self._cv:
            epoch = int(getattr(store, "epoch", 0))
            self._draining = epoch
        ok = False
        try:
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            with self._cv:
                while self.per_epoch.get(epoch, 0) > 0:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    self._cv.wait(0.1 if remaining is None else remaining)
                ok = self.per_epoch.get(epoch, 0) == 0
            if ok:
                self.drains += 1
            else:
                self.drain_timeouts += 1
            yield ok
        finally:
            with self._cv:
                self._draining = None
                self._cv.notify_all()


def read_leases(store, *, create: bool = True
                ) -> Optional[EpochReadLeases]:
    """The store's lease registry (attached like ``_inflight_waves``; None
    when absent and ``create`` is False, or the store forbids attributes)."""
    reg = getattr(store, "_read_leases", None)
    if reg is None and create:
        reg = EpochReadLeases()
        try:
            store._read_leases = reg
        except AttributeError:
            return None
    return reg


def acquire_read_lease(store) -> ReadLease:
    """A read lease on the store's current epoch — the registry-backed kind
    normally; a counter-only lease (total count, no epoch tracking, no
    drain) when the store forbids attributes entirely."""
    reg = read_leases(store)
    if reg is not None:
        return reg.acquire(store)
    counter = inflight_counter(store)
    if counter is not None:
        counter.incr()
    return ReadLease(int(getattr(store, "epoch", 0)), None, counter)
