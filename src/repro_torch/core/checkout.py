"""Batched checkout engine — the default multi-version retrieval path.

Data-flow map (kernels -> core -> query/serve)::

    request: vids = [v0, v1, ... v_{K-1}]          (query layer, serve layer)
      └─ superblock                                core.checkout (this module)
      │    get_superblock concatenates every partition's block into ONE
      │    (ΣR_p, D) array (segments BN-aligned, D padded to the lane tile),
      │    cached on the store keyed by ``store.epoch``; ``device()`` uploads
      │    it once to the store's device and keeps the tensor for the
      │    superblock's life
      └─ plan_wave                                 [host, vectorized numpy]
      │    rebases each version's LOCAL rlist by its partition's row offset,
      │    so one flat adaptive (starts, mode) tile plan (plan_batched)
      │    covers versions from DIFFERENT partitions back to back; emits a
      │    per-tile ``hi`` bound (partition segment end) that lets
      │    consecutive tail chunks promote to run copies
      └─ one fused gather for the WHOLE wave
      │    kernel tier:  kernels.ops.checkout_wave — ONE launch no matter how
      │                  many partitions the wave touches: the CUDA kernel on
      │                  a CUDA store, its plain torch version on a CPU store
      │    host tier:    one np.take over the rebased concatenation when a
      │                  superblock is already cached; per-partition np.takes
      │                  otherwise
      └─ reassemble per-version blocks in request order
           ``device_out=True`` DEFERS this last hop: the wave comes back as
           a ``WaveResult`` handle holding the device-resident packed
           gather, a CUDA event recorded after its launch, and its split
           plan — ``materialize()`` performs the device→host copy (through a
           pinned buffer) and the per-version split later, so the serve
           layer can dispatch wave N+1 while wave N is in flight
           (``serve.checkout.BatchedCheckoutServer``)

A store whose superblock would exceed ``superblock_max_bytes`` refuses the
whole-store copy and serves through PARTITION-GROUP superblocks
(``SuperblockGroups``): groups packed hot-first (``core.online.HotSetPolicy``)
under the byte budget, pinned on demand with LRU eviction, ONE fused launch
per touched pinned group, the per-partition engine only for unpinned
stragglers.

Failure-site catalogue: every stateful step above carries a named
``fault_point`` (a no-op until a deterministic ``FaultPlan`` is armed), so
the recovery tests can exercise each failure mode on purpose.  22
catalogued fault sites (``core.faults.SITES``; the count is checked
against the catalogue by ``tools.analyze`` rule REPRO001).

The failure sites of this module (``core.faults``): ``superblock.upload``
fires in ``Superblock.device()`` before the transfer; ``wave.launch`` after
planning and upload, before the launch; ``group.pin``/``group.evict`` before
any pin/evict work; ``serve.transfer`` in ``_WavePart.split`` before the
device→host copy; ``ingest.append`` and ``migrate.superblock`` before any
superblock extension or migration work.  Each leaves the state a retry
needs intact.

The superblock outlives mutations instead of being re-uploaded: a commit
wave extends it in place (``refresh_superblocks_after_commit`` →
``extend_superblock_after_commit`` → ONE ``segment_append`` launch), and a
migration morphs it in place (``migrate_superblock``/``migrate_groups`` →
ONE ``segment_move`` launch).  Both reuse the old device copy tile by tile
and upload only the changed BN-row tiles; the host mirror is rebuilt in
full beside it.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import ops as K
from ..kernels.build import KernelError
from ..kernels.checkout_batched import plan_batched
from ..kernels.checkout_gather import DEFAULT_BD, DEFAULT_BN
from .faults import fault_point
from .graph import BipartiteGraph
from .journal import journal_regroup

logger = logging.getLogger(__name__)


def _fused_host_gather(data: np.ndarray, rlists: Sequence[np.ndarray]
                       ) -> list[np.ndarray]:
    """One gather for the whole wave: concatenate rlists, single np.take,
    split back by offsets (zero-copy views)."""
    if not rlists:
        return []
    offs = np.cumsum([0] + [len(rl) for rl in rlists])
    if offs[-1] == 0:
        return [data[:0] for _ in rlists]
    packed = data.take(np.concatenate(rlists), axis=0)
    return [packed[offs[i]:offs[i + 1]] for i in range(len(rlists))]


def checkout_rlists(data, rlists: Sequence[np.ndarray], *,
                    use_kernel: bool = True,
                    device=None) -> list[np.ndarray]:
    """Materialize K rlists from one data block in a single fused pass.

    use_kernel: True -> ``checkout_batched`` (ONE launch on ``device``,
    resolved as by ``kernels.ops.resolve_device``), False -> fused host
    gather."""
    if not use_kernel:
        return _fused_host_gather(np.asarray(data), rlists)
    outs, _ = K.checkout_batched(data, rlists, device=device)
    return outs


def checkout_versions(graph: BipartiteGraph, data, vids: Sequence[int], *,
                      use_kernel: bool = True,
                      device=None) -> list[np.ndarray]:
    """Batched checkout straight off a BipartiteGraph (unpartitioned CVD)."""
    return checkout_rlists(data, [graph.rlist(int(v)) for v in vids],
                           use_kernel=use_kernel, device=device)


# ------------------------------------------------------ density telemetry --

@dataclasses.dataclass
class DensityStats:
    """Per-store accumulator of wave gather-mode telemetry.

    Every planned wave records, per requested vid, the measured run density
    (fraction of BN-row chunks whose rids are consecutive — the fraction of
    the wave the kernel can serve with run copies instead of BN row copies).
    ``low_streak`` counts CONSECUTIVE waves whose aggregate density fell
    below ``low_threshold`` (the repartition signal of the migration slice).
    """
    low_threshold: float = 0.5
    ewma_alpha: float = 0.5
    waves: int = 0                 # all-time planned waves
    tiles: int = 0                 # all-time tiles planned
    run_tiles: float = 0.0         # all-time density-weighted tiles
    low_streak: int = 0            # consecutive row-copy-dominated waves
    last_wave_density: float = 1.0
    per_vid: dict = dataclasses.field(default_factory=dict)  # vid -> EWMA

    def record(self, vids: Sequence[int], densities: np.ndarray,
               tiles_per_vid: np.ndarray) -> None:
        densities = np.asarray(densities, np.float64)
        tiles_per_vid = np.asarray(tiles_per_vid, np.int64)
        t = int(tiles_per_vid.sum())
        self.waves += 1
        if t == 0:
            return          # no gather happened: no evidence either way —
                            # an all-empty wave must not break a streak
        runs = float((densities * tiles_per_vid).sum())
        self.tiles += t
        self.run_tiles += runs
        wave_d = runs / t
        self.last_wave_density = wave_d
        if wave_d < self.low_threshold:
            self.low_streak += 1
        else:
            self.low_streak = 0
        a = self.ewma_alpha
        for v, d in zip(vids, densities):
            prev = self.per_vid.get(int(v))
            self.per_vid[int(v)] = float(d) if prev is None \
                else (1.0 - a) * prev + a * float(d)

    @property
    def mean_density(self) -> float:
        return self.run_tiles / self.tiles if self.tiles else 1.0

    def reset(self) -> None:
        """Post-repartition: the streak and the per-vid EWMAs describe the
        OLD layout.  All-time counters survive."""
        self.low_streak = 0
        self.last_wave_density = 1.0
        self.per_vid.clear()


def get_density_stats(store, *, create: bool = False
                      ) -> Optional[DensityStats]:
    """The store's DensityStats accumulator (None when absent and ``create``
    is False or the store forbids attributes)."""
    stats = getattr(store, "_density_stats", None)
    if stats is None and create:
        stats = DensityStats()
        try:
            store._density_stats = stats
        except AttributeError:
            return None
    return stats


def measure_density(rlists: Sequence[np.ndarray], block_n: int, *,
                    density_threshold: float = 0.05
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(density, tiles) per rlist — the fraction of BN-row tiles the wave
    engine would serve with a run copy, without building a plan (host-path
    telemetry).  Mirrors the planner end to end: ``plan_batched``'s run
    classification and below-threshold demotion first, then ``plan_wave``'s
    tail promotion."""
    dens = np.ones(len(rlists), np.float64)
    tiles = np.zeros(len(rlists), np.int64)
    for k, rl in enumerate(rlists):
        rl = np.asarray(rl, np.int64)
        n = len(rl)
        t = -(-n // block_n) if n else 0
        tiles[k] = t
        if not t or block_n <= 1:
            continue
        pad = t * block_n - n
        padded = np.concatenate([rl, np.full(pad, rl[-1], np.int64)]) if pad \
            else rl
        chunks = padded.reshape(t, block_n)
        runs = np.all(np.diff(chunks, axis=1) == 1, axis=1)
        if runs.mean() < density_threshold:
            runs = np.zeros(t, bool)
        tail = rl[(t - 1) * block_n:]
        if len(tail) < block_n and (len(tail) <= 1
                                    or np.all(np.diff(tail) == 1)):
            runs[-1] = True
        dens[k] = float(runs.mean())
    return dens, tiles


def _plan_mode_density(plan) -> tuple[np.ndarray, np.ndarray]:
    """(density, tiles) per version off a PLANNED wave: the fraction of its
    tiles actually going out as run copies (mode 1)."""
    tiles = np.diff(plan.tile_offsets)
    dens = np.ones(len(tiles), np.float64)
    for k in range(len(tiles)):
        if tiles[k]:
            t0, t1 = int(plan.tile_offsets[k]), int(plan.tile_offsets[k + 1])
            dens[k] = float(plan.mode[t0:t1].mean())
    return dens, tiles


# ------------------------------------------------------------- wave results --

@dataclasses.dataclass
class _WavePart:
    """One contiguous gather of a wave: either a device-resident packed
    tensor plus its per-vid split plan, or pre-materialized host blocks
    (host tier, per-partition stragglers).  ``idxs`` are the wave positions
    the part's blocks land in."""
    idxs: Sequence[int]
    mats: Optional[list] = None         # pre-materialized per-idx blocks
    packed: Optional[torch.Tensor] = None   # packed gather on the device
    event: object = None                # torch.cuda.Event after the launch
    stream: object = None               # the stream the launch went on
    segments: Optional[list] = None     # per-idx row slices of ``packed``
    d: int = 0                          # valid feature width of ``packed``

    def split(self) -> list:
        """Force this part to host blocks: ONE device→host copy of the
        packed gather (through a pinned buffer on the card), then per-vid
        zero-copy views."""
        if self.mats is None:
            # fires BEFORE the copy consumes anything: the device tensor
            # survives an injected failure, so a delivery retry succeeds
            fault_point("serve.transfer")
            packed = self.packed
            if packed.is_cuda:
                # the copy queues on the stream the wave launched on,
                # whichever thread delivers it (tenant workers launch and
                # deliver concurrently): launch, event and copy stay in
                # stream order
                stream = self.stream
                host = torch.empty(packed.shape, dtype=packed.dtype,
                                   pin_memory=True)
                with torch.cuda.stream(stream):
                    host.copy_(packed, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()
            else:
                host = packed
            arr = host.numpy()[:, :self.d]
            self.mats = [arr[seg] for seg in self.segments]
            self.packed = None          # release the device tensor
            self.event = None
            self.stream = None
            self.segments = None
        return self.mats


@dataclasses.dataclass
class WaveResult:
    """Handle to one wave's per-vid results, possibly still in flight.

    The kernel tier's ``checkout_wave(..., device_out=True)`` returns right
    after the launch (stream launches are asynchronous); ``materialize()``
    later performs the device→host copy and the per-vid split — the deliver
    half of the serve pipeline.  Host/perpart tiers return pre-materialized
    blocks through the same handle (``ready()`` is immediately True).
    ``materialize()`` is idempotent and caches its result; it is
    bit-identical to the eager (``device_out=False``) path."""
    n: int                              # wave length (vids requested)
    parts: list                         # _WavePart covering positions 0..n-1
    _mats: Optional[list] = dataclasses.field(default=None, repr=False)

    @classmethod
    def from_mats(cls, mats: Sequence) -> "WaveResult":
        wr = cls(n=len(mats), parts=[])
        wr._mats = list(mats)
        return wr

    @property
    def delivered(self) -> bool:
        return self._mats is not None

    def ready(self) -> bool:
        """True when ``materialize()`` would not wait on the device: every
        launch's CUDA event has completed (host-resident and CPU parts are
        always ready)."""
        if self._mats is not None:
            return True
        return all(p.event is None or p.event.query() for p in self.parts)

    def materialize(self) -> list:
        """Per-vid blocks in request order (device→host + split on first
        call, cached after)."""
        if self._mats is None:
            out: list = [None] * self.n
            for p in self.parts:
                for i, m in zip(p.idxs, p.split()):
                    out[i] = m
            self._mats = out
        return self._mats


# --------------------------------------------------------------- superblock --

@dataclasses.dataclass
class Superblock:
    """Every partition's block concatenated into one gatherable array.

    Layout: partition p owns rows [row_offsets[p], row_offsets[p] + R_p) of
    ``host``; each segment is padded to a BLOCK_N multiple (``bounds[p]`` is
    the aligned exclusive end — the safe upper limit for a run copy landing
    in p), and D is padded to the lane-tile multiple so the kernel consumes
    the array as-is.  ``device()`` uploads once to ``target`` and keeps the
    tensor; the epoch captured at build keys cache invalidation.

    A whole-store superblock covers every partition (``pids`` is None and
    segment i belongs to partition i); a PARTITION-GROUP superblock covers
    the subset ``pids`` — segment i belongs to partition ``pids[i]`` and
    ``slot`` maps a pid back to its segment.
    """
    host: np.ndarray          # (R_pad, D_pad) zero-padded concatenation
    row_offsets: np.ndarray   # (P,) int64 — first superblock row of segment p
    bounds: np.ndarray        # (P,) int64 — aligned exclusive end of segment p
    d: int                    # original feature width (pre-padding)
    bd: int                   # lane-tile width the feature axis is padded to
    block_n: int              # row alignment of the partition segments
    epoch: int                # store.epoch at build time
    target: torch.device      # where device() uploads (the store's device)
    _device: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    uploads: int = 0          # host→device transfers performed
    cache_key: object = None  # the get_superblock args this is cached under
    pids: Optional[np.ndarray] = None   # group members (None = all partitions)
    _slot_of: Optional[dict] = dataclasses.field(default=None, repr=False)
    # wave-plan memo (see plan_wave_cached): keyed by the requested vid
    # tuple; safe because a superblock is immutable and epoch-bound
    _plan_cache: Optional["collections.OrderedDict"] = \
        dataclasses.field(default=None, repr=False)

    @property
    def n_rows(self) -> int:
        return self.host.shape[0]

    def slot(self, pid: int) -> int:
        """Segment index of partition ``pid`` in this superblock — the pid
        itself for a whole-store superblock, the group-local position for a
        partition-group one, -1 when the partition is not covered."""
        if self.pids is None:
            return pid if 0 <= pid < len(self.row_offsets) else -1
        if self._slot_of is None:
            self._slot_of = {int(p): i for i, p in enumerate(self.pids)}
        return self._slot_of.get(int(pid), -1)

    def device(self) -> torch.Tensor:
        """The device-resident copy — uploaded on first use, then kept."""
        if self._device is None:
            fault_point("superblock.upload")
            self._device = torch.from_numpy(self.host).to(self.target)
            self.uploads += 1
        return self._device


def _superblock_layout(parts, block_n: Optional[int], block_d: Optional[int]):
    """The (row_offsets, bounds, d, bd, d_pad, total_rows, dtype) layout a
    superblock over ``parts`` would have — shared by ``build_superblock``
    and ``estimate_superblock_bytes`` so both agree byte-for-byte."""
    bn = DEFAULT_BN if block_n is None else block_n
    blk_d = DEFAULT_BD if block_d is None else block_d
    d = max((p.block.shape[1] for p in parts), default=0)
    bd = min(blk_d, max(128, d)) if d else blk_d
    d_pad = -(-max(d, 1) // bd) * bd
    seg = np.array([-(-p.block.shape[0] // bn) * bn for p in parts], np.int64)
    row_offsets = np.concatenate([[0], np.cumsum(seg)[:-1]]).astype(np.int64) \
        if len(parts) else np.zeros(0, np.int64)
    bounds = row_offsets + seg
    total = max(int(seg.sum()), bn)
    dtype = parts[0].block.dtype if parts else np.dtype(np.int32)
    return bn, row_offsets, bounds, d, bd, d_pad, total, dtype


def _select_parts(store, pids):
    if pids is None:
        return store.partitions
    return [store.partitions[int(q)] for q in pids]


def estimate_superblock_bytes(store, *, block_n: Optional[int] = None,
                              block_d: Optional[int] = None,
                              pids: Optional[Sequence[int]] = None) -> int:
    """Host bytes a ``build_superblock`` call would allocate (the device
    copy pins the same amount), WITHOUT building it.  ``pids`` restricts the
    estimate to a partition group."""
    _, _, _, _, _, d_pad, total, dtype = _superblock_layout(
        _select_parts(store, pids), block_n, block_d)
    return total * d_pad * np.dtype(dtype).itemsize


def _cached_superblock_need(store) -> int:
    """``estimate_superblock_bytes`` under the DEFAULT tiling, memoized per
    epoch on the store (the over-budget wave path consults it on every
    kernel wave)."""
    epoch = int(getattr(store, "epoch", 0))
    cached = getattr(store, "_superblock_need", None)
    if cached is not None and cached[0] == epoch:
        return cached[1]
    need = estimate_superblock_bytes(store)
    try:
        store._superblock_need = (epoch, need)
    except AttributeError:
        pass
    return need


def partition_segment_bytes(store, *, block_n: Optional[int] = None,
                            block_d: Optional[int] = None) -> np.ndarray:
    """Per-partition BN-aligned segment bytes under the superblock layout —
    the additive unit the group former packs against the budget."""
    _, row_offsets, bounds, _, _, d_pad, _, dtype = _superblock_layout(
        store.partitions, block_n, block_d)
    return (bounds - row_offsets) * d_pad * np.dtype(dtype).itemsize


def _store_device(store) -> torch.device:
    dev = getattr(store, "device", None)
    return K.resolve_device(dev)


def build_superblock(store, *, block_n: Optional[int] = None,
                     block_d: Optional[int] = None,
                     pids: Optional[Sequence[int]] = None) -> Superblock:
    """Concatenate ``store.partitions`` blocks (padded to a common D) into
    one Superblock — all of them, or the partition group ``pids``.  The plan
    arrays are int32, so a superblock must hold fewer than 2**31 rows."""
    parts = _select_parts(store, pids)
    bn, row_offsets, bounds, d, bd, d_pad, total, dtype = _superblock_layout(
        parts, block_n, block_d)
    if total >= 2 ** 31:
        raise ValueError(f"superblock of {total} rows exceeds the int32 plan "
                         "range (2**31 rows)")
    host = np.zeros((total, d_pad), dtype=dtype)
    for p, off in zip(parts, row_offsets):
        r, pd = p.block.shape
        host[off:off + r, :pd] = p.block
    return Superblock(host=host, row_offsets=row_offsets, bounds=bounds,
                      d=d, bd=bd, block_n=bn,
                      epoch=int(getattr(store, "epoch", 0)),
                      target=_store_device(store),
                      pids=None if pids is None
                      else np.asarray(list(pids), np.int64))


def get_superblock(store, *, block_n: Optional[int] = None,
                   block_d: Optional[int] = None,
                   max_bytes: Optional[int] = None
                   ) -> tuple[Optional[Superblock], bool]:
    """Epoch-keyed superblock cache, attached to the store.

    Returns (superblock, cache_hit).  A hit reuses the host AND any
    device-resident copy verbatim.  Bumping ``store.epoch`` invalidates
    every cached shape.  ``max_bytes`` is the memory budget: when no
    epoch-current copy is cached and the would-be superblock exceeds it,
    the call REFUSES to build one and returns (None, False)."""
    cache = getattr(store, "_superblock_cache", None)
    if cache is None:
        cache = {}
        try:
            store._superblock_cache = cache
        except AttributeError:          # store forbids attributes: no cache
            cache = None
    key = (block_n, block_d)
    epoch = int(getattr(store, "epoch", 0))
    if cache is not None:
        sb = cache.get(key)
        if sb is not None and sb.epoch == epoch:
            return sb, True
    if max_bytes is not None:
        need = estimate_superblock_bytes(store, block_n=block_n,
                                         block_d=block_d)
        if need > max_bytes:
            _log_budget_refusal(store, need, max_bytes, epoch)
            return None, False
    sb = build_superblock(store, block_n=block_n, block_d=block_d)
    sb.cache_key = key
    if cache is not None:
        cache[key] = sb
    # the whole-store copy supersedes the partial-fusion layer: release any
    # pinned partition-group superblocks so the two never double-pin
    mgr = getattr(store, "_superblock_groups", None)
    if mgr is not None:
        mgr.evict_all()
    return sb, False


def _log_budget_refusal(store, need: int, max_bytes: int, epoch: int) -> None:
    """Log a whole-store superblock budget refusal ONCE per (epoch, budget)
    state of the store."""
    state = (int(epoch), int(max_bytes))
    if getattr(store, "_superblock_budget_logged", None) == state:
        return
    try:
        store._superblock_budget_logged = state
    except AttributeError:
        pass
    logger.warning(
        "superblock needs %d bytes > max_bytes=%d: refusing to pin the "
        "whole store; waves route through partition-group superblocks "
        "(per-partition engine for unpinned stragglers)", need, max_bytes)


def evict_superblocks(store) -> int:
    """Eagerly drop EVERY cached superblock, device copy included (pinned
    partition-group superblocks too).  Returns the eviction count; the
    all-time count accumulates on ``store._superblock_evictions``."""
    mgr = getattr(store, "_superblock_groups", None)
    if mgr is not None:
        mgr.evict_all()
    cache = getattr(store, "_superblock_cache", None)
    if not cache:
        return 0
    n = len(cache)
    for sb in cache.values():
        sb._device = None       # hard-release even if a caller kept a ref
    cache.clear()
    try:
        store._superblock_evictions = \
            getattr(store, "_superblock_evictions", 0) + n
    except AttributeError:
        pass
    return n


def take_superblock(store) -> Optional[Superblock]:
    """Remove and return an epoch-current cached superblock, device copy
    INTACT.  Stale entries encountered on the way are evicted (counted);
    returns None when nothing current is cached."""
    cache = getattr(store, "_superblock_cache", None)
    if not cache:
        return None
    epoch = int(getattr(store, "epoch", 0))
    taken = None
    stale = 0
    for k in list(cache):
        if taken is None and cache[k].epoch == epoch:
            taken = cache.pop(k)
        elif cache[k].epoch != epoch:
            cache.pop(k)._device = None
            stale += 1
    if stale:
        try:
            store._superblock_evictions = \
                getattr(store, "_superblock_evictions", 0) + stale
        except AttributeError:
            pass
    return taken


def reinstall_superblock(store, sb: Optional[Superblock]) -> bool:
    """Rollback of ``take_superblock``: put a detached, still epoch-current
    superblock back into the store's cache (device copy intact).  A stale
    superblock is released instead.  Returns True iff the copy was kept."""
    if sb is None:
        return False
    if sb.epoch != int(getattr(store, "epoch", 0)):
        sb._device = None
        return False
    cache = getattr(store, "_superblock_cache", None)
    if cache is None:
        cache = {}
        try:
            store._superblock_cache = cache
        except AttributeError:
            sb._device = None
            return False
    cache[sb.cache_key if sb.cache_key is not None else (None, None)] = sb
    return True


def peek_superblock(store) -> Optional[Superblock]:
    """A cached, epoch-current superblock — or None, WITHOUT building one.
    The host gather path uses this so pure-host processes never pay the
    superblock's memory copy."""
    cache = getattr(store, "_superblock_cache", None)
    if not cache:
        return None
    epoch = int(getattr(store, "epoch", 0))
    for sb in cache.values():
        if sb.epoch == epoch:
            return sb
    return None


# ----------------------------------------------- partition-group superblocks --

GROUP_FANOUT = 4   # soft co-residency target: per-group cap = budget/FANOUT,
                   # so ~FANOUT hot groups can stay pinned simultaneously


@dataclasses.dataclass
class GroupWaveReport:
    """Accounting for ONE wave routed through the group layer."""
    groups_touched: int = 0    # distinct groups the wave's vids map to
    launches: int = 0          # fused kernel launches (== pinned groups that
                               # actually gathered tiles)
    pinned: int = 0            # groups (re)pinned by this wave
    evictions: int = 0         # LRU evictions this wave forced
    straggler_vids: int = 0    # vids routed through the per-partition engine


class SuperblockGroups:
    """Budget-aware partition-group superblock cache: the partial-fusion
    layer for stores whose whole-store superblock exceeds ``max_bytes``.

    The partition set is packed into groups, hot partitions first (the
    ``core.online.HotSetPolicy`` ranking when one is attached, partition
    order otherwise); each group's superblock is built and pinned ON DEMAND
    the first time a wave touches it, under the SHARED byte budget —
    pinning a new group LRU-evicts cold ones (never a group the current
    wave still needs).  Partitions bigger than the whole budget are
    permanent stragglers and always route through the per-partition
    engine.

    Invariants: ``pinned_bytes`` equals the sum of the pinned groups' host
    bytes and never exceeds ``budget``; ``pins - evictions == len(groups)``;
    every superblock that leaves the cache has its device copy released."""

    def __init__(self, store, budget: int, *,
                 block_n: Optional[int] = None,
                 block_d: Optional[int] = None):
        self.store = store
        self.budget = int(budget)
        self.block_n = block_n
        self.block_d = block_d
        self.epoch = int(getattr(store, "epoch", 0))
        # pinned group superblocks, LRU order (oldest first)
        self.groups: "collections.OrderedDict[tuple, Superblock]" = \
            collections.OrderedDict()
        self.pid_to_group: dict[int, tuple] = {}
        self.group_bytes: dict[tuple, int] = {}
        self.straggler_pids: set[int] = set()
        self.planned: list[tuple] = []      # group keys, hot order
        self.pinned_bytes = 0
        # all-time counters (the serve stats and the leak tests read these)
        self.pins = 0
        self.evictions = 0
        self.launches = 0
        self.waves = 0
        self.groups_touched = 0
        self.straggler_requests = 0
        self.auto_regroups = 0      # heat-drift regroups maybe_regroup fired
        self.last_wave: Optional[GroupWaveReport] = None
        self._plan_epoch = -1
        # heat-drift auto-regroup knobs (see maybe_regroup)
        self.auto_regroup_every = 32
        self.drift_threshold = 0.5
        self._plan_hot: list[int] = []

    # -- group formation ----------------------------------------------------
    def _hot_order(self, n_partitions: int) -> list[int]:
        pol = getattr(self.store, "_hot_set_policy", None)
        if pol is None:
            return list(range(n_partitions))
        return [int(q) for q in pol.rank(self.store, n_partitions)]

    def plan_groups(self) -> None:
        """(Re)partition the partition set into budget-fitting groups.

        Epoch-current PINNED groups keep their membership; the remaining
        partitions are packed greedily in hot order against the per-group
        cap.  A partition bigger than the whole budget becomes a straggler
        (permanently perpart-routed)."""
        store = self.store
        self.epoch = int(getattr(store, "epoch", 0))
        seg = partition_segment_bytes(store, block_n=self.block_n,
                                      block_d=self.block_d)
        n = len(seg)
        self.pid_to_group.clear()
        self.straggler_pids.clear()
        self.group_bytes.clear()
        self.planned = []
        for key in list(self.groups):
            sb = self.groups[key]
            if sb.epoch != self.epoch or any(q >= n for q in key):
                self._evict(key)
                continue
            self.group_bytes[key] = int(sb.host.nbytes)
            self.planned.append(key)
            for q in key:
                self.pid_to_group[q] = key
        cap = max(self.budget // GROUP_FANOUT, 1)
        cur: list[int] = []
        cur_bytes = 0

        def close() -> None:
            nonlocal cur, cur_bytes
            if cur:
                key = tuple(sorted(cur))
                self.group_bytes[key] = estimate_superblock_bytes(
                    self.store, block_n=self.block_n, block_d=self.block_d,
                    pids=key)
                self.planned.append(key)
                for q in cur:
                    self.pid_to_group[q] = key
            cur, cur_bytes = [], 0

        for q in self._hot_order(n):
            if q in self.pid_to_group:
                continue                    # already kept via a pinned group
            b = int(seg[q])
            if b > self.budget:
                self.straggler_pids.add(q)
                continue
            if cur and cur_bytes + b > cap:
                close()
            cur.append(q)
            cur_bytes += b
        close()
        # the hot prefix this plan packed its co-resident groups around —
        # maybe_regroup measures drift against it
        n_hot = sum(len(k) for k in self.planned[:GROUP_FANOUT])
        self._plan_hot = [q for q in self._hot_order(n)
                          if q not in self.straggler_pids][:n_hot]
        self._plan_epoch = self.epoch

    def ensure_plan(self) -> None:
        if (self._plan_epoch != int(getattr(self.store, "epoch", 0))
                or (not self.pid_to_group and not self.straggler_pids
                    and len(self.store.partitions))):
            self.plan_groups()

    def set_budget(self, budget: int) -> None:
        """Budget changes re-form the groups from scratch (the cap moved);
        counters survive."""
        budget = int(budget)
        if budget == self.budget:
            return
        self.budget = budget
        self.evict_all()
        self._plan_epoch = -1

    def regroup(self) -> None:
        """Drop every pin and re-form the groups from the CURRENT hot
        ranking — the explicit consolidation knob for traffic shifts.  The
        RESULT (not the heat trigger) is journaled as an advisory record
        when a ``core.journal`` journal is attached, so a restored store
        replays the layout directly — heat EWMAs between snapshots are not
        journaled per wave."""
        self.evict_all()
        self._plan_epoch = -1
        self.ensure_plan()
        journal_regroup(self)

    def regroup_drift(self) -> float:
        """How far the LIVE hot ranking has drifted from the prefix the
        current plan packed around, in [0, 1]."""
        if not self._plan_hot:
            return 0.0
        if getattr(self.store, "_hot_set_policy", None) is None:
            return 0.0
        live = [q for q in self._hot_order(len(self.store.partitions))
                if q not in self.straggler_pids][:len(self._plan_hot)]
        if not live:
            return 0.0
        return 1.0 - len(set(live) & set(self._plan_hot)) / len(live)

    def maybe_regroup(self) -> bool:
        """Heat-driven automatic ``regroup()`` once the served hot set has
        drifted past ``drift_threshold``; ``_grouped_wave`` calls this every
        ``auto_regroup_every`` group waves.  Returns whether it fired."""
        drift = self.regroup_drift()
        if drift < self.drift_threshold:
            return False
        self.auto_regroups += 1
        logger.info("hot-set drift %.2f >= %.2f: auto regroup #%d",
                    drift, self.drift_threshold, self.auto_regroups)
        self.regroup()
        return True

    # -- pin / evict ---------------------------------------------------------
    def _evict(self, key: tuple) -> None:
        # fires BEFORE the pop: an injected eviction failure leaves the
        # victim pinned AND accounted (pins - evictions == len(groups))
        fault_point("group.evict", self.store)
        sb = self.groups.pop(key)
        sb._device = None                   # hard-release the device copy
        self.pinned_bytes -= int(sb.host.nbytes)
        self.evictions += 1

    def evict_all(self) -> int:
        n = len(self.groups)
        for key in list(self.groups):
            self._evict(key)
        return n

    def take_all(self) -> list[Superblock]:
        """Detach every pinned group, device copies INTACT (counted as
        evictions: the cache no longer owns the memory)."""
        out = []
        for key in list(self.groups):
            sb = self.groups.pop(key)
            self.pinned_bytes -= int(sb.host.nbytes)
            self.evictions += 1
            out.append(sb)
        return out

    def _make_room(self, need: int, protected: frozenset | set) -> bool:
        """LRU-evict cold (non-``protected``) groups until ``need`` bytes
        fit under the budget; False when they cannot."""
        if need > self.budget:
            return False
        while self.pinned_bytes + need > self.budget:
            victim = next((k for k in self.groups if k not in protected),
                          None)
            if victim is None:
                return False
            self._evict(victim)
        return True

    def peek(self, key: tuple) -> Optional[Superblock]:
        """An already-pinned, epoch-current group superblock — or None,
        WITHOUT building one (the host tier's free-fusion check)."""
        sb = self.groups.get(key)
        if sb is None or sb.epoch != int(getattr(self.store, "epoch", 0)):
            return None
        self.groups.move_to_end(key)
        return sb

    def pin(self, key: tuple, protected: frozenset | set = frozenset()
            ) -> Optional[Superblock]:
        """The group's superblock, pinned — building it (and LRU-evicting
        cold groups to make room) if needed.  ``protected`` groups (the
        current wave's) are never evicted; returns None when the group
        cannot fit without evicting one of them."""
        sb = self.peek(key)
        if sb is not None:
            return sb
        # fires before any build/evict work: an injected pin failure pins no
        # bytes and leaves the LRU state untouched
        fault_point("group.pin", self.store)
        if key in self.groups:              # stale epoch: rebuild below
            self._evict(key)
        need = self.group_bytes.get(key)
        if need is None:
            need = estimate_superblock_bytes(
                self.store, block_n=self.block_n, block_d=self.block_d,
                pids=key)
            self.group_bytes[key] = need
        if not self._make_room(need, protected):
            return None
        sb = build_superblock(self.store, block_n=self.block_n,
                              block_d=self.block_d, pids=key)
        sb.cache_key = key
        self.groups[key] = sb
        self.pinned_bytes += int(sb.host.nbytes)
        self.pins += 1
        return sb

    def install(self, sb: Superblock,
                protected: frozenset | set = frozenset()) -> bool:
        """Pin an externally built group superblock under the budget,
        LRU-evicting cold groups to fit; on False the superblock's device
        copy is released (it could not be kept)."""
        key = tuple(int(q) for q in np.asarray(sb.pids))
        need = int(sb.host.nbytes)
        if not self._make_room(need, protected):
            sb._device = None
            return False
        sb.cache_key = key
        self.groups[key] = sb
        self.group_bytes[key] = need
        for q in key:
            self.pid_to_group[q] = key
        self.pinned_bytes += need
        self.pins += 1
        return True

    def warm(self, *, device: bool) -> int:
        """Pin planned groups, hot order first, until the budget is full —
        the serve-layer warmup analogue of ``Superblock.device()``.  A
        group that cannot fit is SKIPPED (not a stop)."""
        self.ensure_plan()
        n = 0
        for key in list(self.planned):
            sb = self.pin(key, protected=set(self.groups))
            if sb is None:
                continue
            if device:
                sb.device()
            n += 1
        return n


def get_superblock_groups(store, *, budget: Optional[int] = None,
                          create: bool = False
                          ) -> Optional[SuperblockGroups]:
    """The store's group-superblock manager (None when absent and
    ``create`` is False or the store forbids attributes).  A ``budget``
    differing from the manager's re-forms the groups; creation also
    attaches a ``core.online.HotSetPolicy`` so the group former has a hot
    ranking to consume."""
    mgr = getattr(store, "_superblock_groups", None)
    if mgr is None and create:
        if budget is None:
            raise ValueError("creating SuperblockGroups needs a budget")
        mgr = SuperblockGroups(store, budget)
        try:
            store._superblock_groups = mgr
        except AttributeError:
            return None
        from .online import get_hot_set_policy   # lazy: no cycle at import
        get_hot_set_policy(store, create=True)
    elif mgr is not None and budget is not None:
        mgr.set_budget(int(budget))
    return mgr


def take_group_superblocks(store) -> list[Superblock]:
    """Detach every pinned group superblock (device copies intact) ahead of
    a migration — ``migrate_groups`` replays them under the new layout."""
    mgr = getattr(store, "_superblock_groups", None)
    return mgr.take_all() if mgr is not None else []


def migrate_groups(store, plan, taken: Sequence[Superblock], *,
                   use_kernel: Optional[bool] = None) -> int:
    """Per-group epoch-bump migration: re-pin each detached pre-migration
    group superblock under the NEW layout instead of nuking the cache.

    Each old group's partitions map through ``plan.matched_old`` to the new
    partitions that morphed out of them; the group superblock migrates
    incrementally (``migrate_superblock(pids=...)`` — device tiles reused,
    delta-only upload) and re-pins under the budget.  Groups that dissolved
    (no new partition morphed from them), changed tiling, or no longer fit
    are evicted (device released).  Returns the migrated-group count."""
    mgr = getattr(store, "_superblock_groups", None)
    if mgr is None:
        for sb in taken:
            sb._device = None
        return 0
    matched = np.asarray(plan.matched_old, np.int64)
    migrated = 0
    kept: set[tuple] = set()    # groups migrated THIS call are protected:
    # installing a later group must not LRU-evict an earlier one whose
    # segment_move work was just paid (hot-order taken first)
    # Runs POST-COMMIT (store already on the new layout), so a failure here
    # must degrade, never propagate: each group falls back independently to
    # lazy rebuild, and the finally guarantees zero leaked device buffers.
    # A KernelError is the exception: it propagates (the store is already
    # consistent, every detached group is released by the finally).
    try:
        for old_sb in taken:
            old_pids = set(
                int(q) for q in (old_sb.pids if old_sb.pids is not None
                                 else np.arange(len(old_sb.row_offsets))))
            new_pids = sorted(int(i) for i in np.flatnonzero(matched >= 0)
                              if int(matched[i]) in old_pids)
            if not new_pids:
                old_sb._device = None
                continue
            # don't pay segment_move for a group that cannot be kept: every
            # group pinned during this call is protected, so the fit test is
            # exactly "does it fit in the remaining budget"
            est = estimate_superblock_bytes(store, block_n=mgr.block_n,
                                            block_d=mgr.block_d, pids=new_pids)
            if mgr.pinned_bytes + est > mgr.budget:
                old_sb._device = None
                continue
            try:
                new_sb, _ = migrate_superblock(store, old_sb, plan,
                                               pids=new_pids,
                                               use_kernel=use_kernel,
                                               install=False)
            except KernelError:     # the kernel failed: never absorbed
                mgr._plan_epoch = -1    # regroup on the next pin()
                raise
            except ValueError:      # tiling changed: rebuild on next touch
                old_sb._device = None
                continue
            except Exception:       # transient (injected/allocator): this
                old_sb._device = None   # group rebuilds lazily, rest proceed
                logger.warning("group migration failed; falling back to "
                               "lazy rebuild", exc_info=True)
                continue
            old_sb._device = None
            if mgr.install(new_sb, protected=kept):
                kept.add(tuple(int(q) for q in np.asarray(new_sb.pids)))
                migrated += 1
        try:
            mgr.plan_groups()       # regroup leftovers around the survivors
        except Exception:
            mgr._plan_epoch = -1    # replan on next pin()
            logger.warning("post-migration regroup failed; deferring to "
                           "next pin", exc_info=True)
    finally:
        for old_sb in taken:        # no device buffer outlives this call
            old_sb._device = None
    return migrated


# ---------------------------------------------------------------- wave plan --

@dataclasses.dataclass(frozen=True)
class WavePlan:
    """A cross-partition gather plan: one flat tile plan over the superblock.

    ``plan`` is the adaptive (starts, mode) plan from ``plan_batched`` over
    the REBASED rlists (local rid + partition row offset); ``hi`` carries the
    per-tile exclusive row bound the kernel checks before a run copy.
    """
    plan: object              # kernels.checkout_batched.BatchedPlan
    hi: np.ndarray            # (T,) int32 per-tile run-copy bound
    rebased: list             # the rebased rlists (host-path gather input)

    @property
    def n_tiles(self) -> int:
        return self.plan.n_tiles

    def segment(self, k: int, block_n: int) -> slice:
        return self.plan.segment(k, block_n)


def _rebase_wave(store, vids: Sequence[int], sb: Superblock
                 ) -> tuple[list[np.ndarray], list[int]]:
    """Rebase each version's LOCAL rlist into superblock coordinates (local
    rid + the partition SEGMENT's row offset).  Returns (rebased rlists,
    per-vid segment slots)."""
    rebased: list[np.ndarray] = []
    slots: list[int] = []
    for v in vids:
        pid = int(store.vid_to_pid[int(v)])
        s = sb.slot(pid)
        if s < 0:
            raise ValueError(
                f"version {int(v)}'s partition {pid} is not covered by "
                f"this superblock (group {None if sb.pids is None else list(sb.pids)})")
        p = store.partitions[pid]
        rebased.append(np.asarray(p.local_rlist(int(v)), np.int64)
                       + int(sb.row_offsets[s]))
        slots.append(s)
    return rebased, slots


def plan_wave(store, vids: Sequence[int], sb: Superblock, *,
              density_threshold: float = 0.05) -> WavePlan:
    """Plan a multi-partition wave as ONE flat tile plan.

    Each version's local rlist is rebased by its partition's superblock row
    offset, then the whole wave is planned back to back by ``plan_batched``.
    Two wave-only extensions:

      * ``hi[t]`` = the aligned end of tile t's partition segment — the run
        bound the kernel verifies on device;
      * consecutive TAIL chunks are promoted to run copies (mode 1): the
        padding rows a full BN-row read drags in stay inside the partition's
        aligned segment and land in the sliced-off region of the output.
    """
    bn = sb.block_n
    rebased, slots = _rebase_wave(store, vids, sb)
    plan = plan_batched(rebased, block_n=bn,
                        density_threshold=density_threshold)
    t_per = np.diff(plan.tile_offsets)
    hi = np.repeat(np.asarray(sb.bounds)[np.asarray(slots, np.int64)],
                   t_per).astype(np.int32)
    mode = plan.mode.copy()
    if bn > 1 and plan.n_tiles:
        nz = np.flatnonzero(t_per)
        # tail promotion: a ragged final chunk whose VALID rids are
        # consecutive goes out as one run copy (padding repeats the last
        # rid, so only the first tail_len-1 plan diffs must equal 1)
        last_idx = (plan.tile_offsets[1:] - 1)[nz]
        tail_len = plan.n_rows[nz] - (t_per[nz] - 1) * bn
        cand = tail_len < bn
        if cand.any():
            chunks = plan.starts.reshape(-1, bn)[last_idx[cand]] \
                .astype(np.int64)
            consec = np.cumprod(np.diff(chunks, axis=1) == 1, axis=1)
            tl = tail_len[cand]
            ok = (tl <= 1) | consec[np.arange(len(tl)),
                                    np.maximum(tl - 2, 0)].astype(bool)
            mode[last_idx[cand][ok]] = 1
    plan = dataclasses.replace(plan, mode=mode)
    return WavePlan(plan=plan, hi=hi, rebased=rebased)


PLAN_CACHE_MAX = 64     # memoized wave plans kept per superblock (LRU)


def plan_wave_cached(store, vids: Sequence[int], sb: Superblock, *,
                     density_threshold: float = 0.05) -> WavePlan:
    """``plan_wave`` memoized on the superblock, keyed by the requested vid
    tuple.  Correct by construction: a plan is a deterministic function of
    (layout, vids, tiling), and the epoch-bound superblock carrying the
    cache is evicted on every epoch bump.  LRU-bounded at
    ``PLAN_CACHE_MAX`` entries."""
    key = (tuple(int(v) for v in vids), density_threshold)
    cache = sb._plan_cache
    if cache is None:
        cache = sb._plan_cache = collections.OrderedDict()
    wp = cache.get(key)
    if wp is not None:
        cache.move_to_end(key)
        return wp
    wp = plan_wave(store, vids, sb, density_threshold=density_threshold)
    cache[key] = wp
    while len(cache) > PLAN_CACHE_MAX:
        cache.popitem(last=False)
    return wp


def _validate_vids(store, vids: Sequence[int]) -> list[int]:
    if not isinstance(vids, (np.ndarray, list, tuple)):
        vids = list(vids)           # generators/iterators are valid input
    arr = np.asarray(vids, dtype=np.int64)
    if arr.ndim != 1:
        raise TypeError(
            f"vids must be a flat sequence of ints, got shape {arr.shape}")
    n_versions = len(store.vid_to_pid)
    oob = (arr < 0) | (arr >= n_versions)
    if oob.any():
        bad = [int(v) for v in arr[oob]]
        raise ValueError(f"unknown version id(s) {bad}: store has "
                         f"{n_versions} versions (0..{n_versions - 1})")
    return arr.tolist()


def _perpart_fallback(store, vids: Sequence[int],
                      stats: Optional[DensityStats], use_kernel,
                      density_threshold: float) -> list[np.ndarray]:
    """Route a whole wave through the per-partition engine, recording the
    wave's density telemetry off the local rlists first."""
    if stats:
        stats.record(vids, *_local_wave_density(store, vids,
                                                density_threshold))
    return checkout_partitioned_perpart(store, vids, use_kernel=use_kernel)


def _local_wave_density(store, vids: Sequence[int],
                        density_threshold: float):
    """(density, tiles) off the versions' LOCAL rlists (rebasing adds a
    constant per-version offset, so local and rebased densities agree)."""
    rls = [store.partitions[int(store.vid_to_pid[int(v)])].local_rlist(int(v))
           for v in vids]
    return measure_density(rls, DEFAULT_BN,
                           density_threshold=density_threshold)


def checkout_wave(store, vids: Sequence[int], *,
                  use_kernel: bool = True,
                  density_threshold: float = 0.05,
                  max_bytes: Optional[int] = None,
                  record_density: bool = True,
                  device_out: bool = False):
    """Cross-partition fused checkout: the whole wave, ONE kernel launch.

    However many partitions the vids span, the wave executes as a single
    ``checkout_wave`` launch over the store's cached device-resident
    superblock.  The superblock is only built when the fusion can pay for
    it: waves confined to one partition with no superblock cached run as
    one launch through the per-partition engine, the host tier gathers off
    a superblock only when one is already cached, and a store whose
    superblock would exceed ``max_bytes`` (default:
    ``store.superblock_max_bytes``) routes through the PARTITION-GROUP layer
    instead.

    Every planned wave records per-vid run-density telemetry into the
    store's ``DensityStats`` once an accumulator is attached;
    ``record_density=False`` opts a call out.  An attached ``HotSetPolicy``
    observes every wave's touched partitions.

    ``device_out=True`` returns a ``WaveResult`` handle right after the
    launch instead of host blocks; ``materialize()`` later is bit-identical
    to the eager path."""
    res = _wave_result(store, vids, use_kernel=use_kernel,
                       density_threshold=density_threshold,
                       max_bytes=max_bytes, record_density=record_density)
    return res if device_out else res.materialize()


def _wave_result(store, vids: Sequence[int], *,
                 use_kernel: bool,
                 density_threshold: float,
                 max_bytes: Optional[int],
                 record_density: bool) -> WaveResult:
    """``checkout_wave``'s body: route the wave, return a WaveResult."""
    vids = _validate_vids(store, vids)
    if not vids:
        return WaveResult.from_mats([])
    if max_bytes is None:
        max_bytes = getattr(store, "superblock_max_bytes", None)
    stats = get_density_stats(store) if record_density else None
    pol = getattr(store, "_hot_set_policy", None)
    if pol is not None:
        pol.touch([int(store.vid_to_pid[int(v)]) for v in vids])
    sb = peek_superblock(store)
    if not use_kernel:
        # Host tier: reuse an ALREADY-CACHED superblock for the one-take
        # fused gather, but never build one just for numpy
        if sb is None:
            mgr = getattr(store, "_superblock_groups", None)
            if mgr is not None and mgr.groups:
                # free fusion off already-pinned group superblocks
                return _grouped_wave(store, vids, mgr, use_kernel=False,
                                     stats=stats,
                                     density_threshold=density_threshold)
            return WaveResult.from_mats(_perpart_fallback(
                store, vids, stats, False, density_threshold))
        rebased, _ = _rebase_wave(store, vids, sb)
        if stats:
            stats.record(vids, *measure_density(
                rebased, sb.block_n, density_threshold=density_threshold))
        return WaveResult.from_mats(
            _fused_host_gather(sb.host[:, :sb.d], rebased))
    if sb is None and max_bytes is not None:
        need = _cached_superblock_need(store)
        if need > max_bytes:
            # over budget: refuse the whole-store copy, run the wave through
            # the partition-group layer (partial fusion under the budget)
            _log_budget_refusal(store, need, max_bytes,
                                int(getattr(store, "epoch", 0)))
            store_budget = getattr(store, "superblock_max_bytes", None)
            mgr = get_superblock_groups(store)
            if mgr is None:
                # the SHARED manager is sized by the store-level budget; a
                # per-call max_bytes only seeds it when no store-level
                # budget exists at all
                mgr = get_superblock_groups(
                    store, create=True,
                    budget=store_budget if store_budget is not None
                    else max_bytes)
            elif max_bytes == store_budget:
                # a store-level budget change re-forms the shared manager;
                # a per-call override only bounds THIS wave's decision
                mgr.set_budget(max_bytes)
            if mgr is not None:
                return _grouped_wave(store, vids, mgr, use_kernel=True,
                                     stats=stats,
                                     density_threshold=density_threshold)
            # store forbids attributes: no group cache possible
            return WaveResult.from_mats(_perpart_fallback(
                store, vids, stats, use_kernel, density_threshold))
    if sb is None and len({int(store.vid_to_pid[v]) for v in vids}) <= 1:
        # one partition touched = the per-partition engine is already a
        # single launch; don't build+pin a whole-store superblock for it
        return WaveResult.from_mats(_perpart_fallback(
            store, vids, stats, use_kernel, density_threshold))
    if sb is None:
        sb, _ = get_superblock(store, max_bytes=max_bytes)
        if sb is None:          # refused (store forbade caching): perpart
            return WaveResult.from_mats(_perpart_fallback(
                store, vids, stats, use_kernel, density_threshold))
    part, _, dt = _gather_off_superblock(
        store, vids, sb, use_kernel=True,
        density_threshold=density_threshold, want_density=stats is not None)
    if stats:
        stats.record(vids, *dt)
    return WaveResult(n=len(vids), parts=[part])


def _gather_off_superblock(store, gvids: Sequence[int], sb: Superblock, *,
                           use_kernel: bool, density_threshold: float,
                           want_density: bool = False
                           ) -> tuple[_WavePart, bool, Optional[tuple]]:
    """One fused gather for ``gvids`` over ``sb`` (whole-store or group).
    Returns (part, launched, density) — ``part`` is a ``_WavePart`` over
    positions 0..len(gvids)-1 (kernel tier: the device-resident packed
    gather + split plan, the device→host copy deferred to ``split()``;
    host tier: pre-materialized blocks); ``launched`` is True iff a kernel
    launch actually happened (an all-empty wave gathers nothing);
    ``density`` is the per-vid (densities, tiles) telemetry when
    ``want_density``, else None."""
    idxs = list(range(len(gvids)))
    if not use_kernel:
        rebased, _ = _rebase_wave(store, gvids, sb)
        dt = measure_density(rebased, sb.block_n,
                             density_threshold=density_threshold) \
            if want_density else None
        return _WavePart(idxs=idxs, mats=_fused_host_gather(
            sb.host[:, :sb.d], rebased)), False, dt
    wp = plan_wave_cached(store, gvids, sb,
                          density_threshold=density_threshold)
    dt = _plan_mode_density(wp.plan) if want_density else None
    if wp.n_tiles == 0:
        empty = np.zeros((0, sb.d), dtype=sb.host.dtype)
        return _WavePart(idxs=idxs, mats=[empty for _ in gvids]), False, dt
    dev = sb.device()
    # fires after planning + upload, before the launch: a retry finds the
    # plan memo and the device copy intact and just relaunches
    fault_point("wave.launch", store)
    packed = K.checkout_wave(dev, wp.plan.starts, wp.plan.mode, wp.hi,
                             block_n=sb.block_n, block_d=sb.bd)
    event = stream = None
    if packed.is_cuda:
        stream = torch.cuda.current_stream(packed.device)
        event = torch.cuda.Event()
        event.record(stream)
    return _WavePart(idxs=idxs, packed=packed, event=event, stream=stream,
                     segments=[wp.segment(k, sb.block_n)
                               for k in range(len(gvids))],
                     d=sb.d), True, dt


def _grouped_wave(store, vids: Sequence[int], mgr: SuperblockGroups, *,
                  use_kernel: bool, stats: Optional[DensityStats],
                  density_threshold: float) -> WaveResult:
    """Route one wave through the partition-group layer.

    The wave's vids split by group; every touched group that is (or can
    be) pinned runs as ONE fused ``checkout_wave`` launch over its group
    superblock — kernel launches == touched pinned groups, and every
    launched gather stays device-resident inside the returned
    ``WaveResult``.  Groups this wave touches are protected from intra-wave
    LRU eviction; vids whose group cannot co-pin, plus straggler partitions
    bigger than the whole budget, route through the per-partition engine
    in one batch.  The host tier only uses groups that are ALREADY pinned."""
    # heat-driven auto-regroup checkpoint (maybe_regroup)
    if (mgr.auto_regroup_every and mgr.waves
            and mgr.waves % mgr.auto_regroup_every == 0):
        mgr.maybe_regroup()
    mgr.ensure_plan()
    by_group: dict[tuple, list[int]] = {}
    stragglers: list[int] = []
    for i, v in enumerate(vids):
        key = mgr.pid_to_group.get(int(store.vid_to_pid[int(v)]))
        if key is None:
            stragglers.append(i)
        else:
            by_group.setdefault(key, []).append(i)
    # density telemetry rides the per-group plans the gathers need anyway;
    # only straggler vids pay a separate local-rlist measurement
    dens = np.ones(len(vids), np.float64) if stats else None
    tiles = np.zeros(len(vids), np.int64) if stats else None
    report = GroupWaveReport(groups_touched=len(by_group))
    pins0, ev0 = mgr.pins, mgr.evictions
    protected = set(by_group)
    parts: list[_WavePart] = []
    for key, idxs in by_group.items():
        sb = mgr.pin(key, protected=protected) if use_kernel \
            else mgr.peek(key)
        if sb is None:
            stragglers.extend(idxs)
            continue
        gvids = [vids[i] for i in idxs]
        part, launched, dt = _gather_off_superblock(
            store, gvids, sb, use_kernel=use_kernel,
            density_threshold=density_threshold,
            want_density=stats is not None)
        if launched:
            report.launches += 1
            mgr.launches += 1
        parts.append(dataclasses.replace(part, idxs=idxs))
        if dt is not None:
            d_g, t_g = dt
            for j, i in enumerate(idxs):
                dens[i], tiles[i] = d_g[j], t_g[j]
    if stragglers:
        stragglers.sort()
        svids = [vids[i] for i in stragglers]
        mats = checkout_partitioned_perpart(store, svids,
                                            use_kernel=use_kernel)
        parts.append(_WavePart(idxs=list(stragglers), mats=list(mats)))
        if stats:
            d_s, t_s = _local_wave_density(store, svids, density_threshold)
            for j, i in enumerate(stragglers):
                dens[i], tiles[i] = d_s[j], t_s[j]
    if stats:
        stats.record(vids, dens, tiles)
    report.pinned = mgr.pins - pins0
    report.evictions = mgr.evictions - ev0
    report.straggler_vids = len(stragglers)
    mgr.waves += 1
    mgr.groups_touched += report.groups_touched
    mgr.straggler_requests += len(stragglers)
    mgr.last_wave = report
    return WaveResult(n=len(vids), parts=parts)


# ---------------------------------------------------- superblock migration --

@dataclasses.dataclass
class MigrationStats:
    """Accounting for one ``migrate_superblock`` or
    ``extend_superblock_after_commit`` call."""
    n_tiles: int                  # BN-row tiles in the NEW superblock
    reused_tiles: int             # device-to-device copies from the OLD one
    delta_tiles: int              # tiles shipped over the host link
    bytes_uploaded: int           # host->device bytes actually transferred
    bytes_total: int              # what a rebuild-from-scratch would upload
    used_device: bool             # device path taken (old device copy live)
    wall_s: float

    @property
    def reuse_fraction(self) -> float:
        return self.reused_tiles / self.n_tiles if self.n_tiles else 1.0


def _reuse_tiles(sel: np.ndarray, starts: np.ndarray, host: np.ndarray,
                 old_sb: Superblock, src: np.ndarray, r: int, off: int,
                 bn: int) -> np.ndarray:
    """Plan one segment of a new superblock against the old one.

    ``src`` holds, per row of the segment's BN-aligned span, its row in the
    OLD superblock (-1: not there); ``r`` rows carry data.  Tiles whose rows
    sit consecutively inside ONE aligned old segment become reused tiles
    (sel 0, their host mirror rows copied from the old host copy).  Returns
    the segment-local indices of the remaining tiles, which the caller
    sources from the host."""
    t = len(src) // bn
    # tail-pad continuation: the padding rows of the last tile carry no
    # data, so extend the final run — the tile qualifies for a run copy
    # whose trailing reads land in the sliced-off region
    pad = t * bn - r
    if pad and r and src[r - 1] >= 0:
        src[r:] = src[r - 1] + 1 + np.arange(pad)
    chunks = src.reshape(t, bn)
    ok = chunks[:, 0] >= 0
    if bn > 1:
        ok &= np.all(np.diff(chunks, axis=1) == 1, axis=1)
    n_old = len(old_sb.bounds)
    if n_old:
        s0 = chunks[:, 0]
        opid = np.clip(np.searchsorted(old_sb.bounds, s0, side="right"),
                       0, n_old - 1)
        # the whole BN-row run must stay inside ONE aligned old segment
        ok &= s0 + bn <= old_sb.bounds[opid]
    else:
        ok[:] = False
    t_base = off // bn
    ok_idx = np.flatnonzero(ok)
    if len(ok_idx):
        # reused tiles: one vectorized numpy gather (python-level work
        # stays proportional to the caller's delta loop)
        sel[t_base + ok_idx] = 0
        starts[t_base + ok_idx] = chunks[ok_idx, 0]
        src_rows = (chunks[ok_idx, 0][:, None] + np.arange(bn)).reshape(-1)
        dst_rows = (off + ok_idx[:, None] * bn + np.arange(bn)).reshape(-1)
        host[dst_rows] = old_sb.host[src_rows]
    return np.flatnonzero(~ok)


def migrate_superblock(store, old_sb: Superblock, plan, *,
                       use_kernel: Optional[bool] = None,
                       install: bool = True,
                       pids: Optional[Sequence[int]] = None
                       ) -> tuple[Superblock, MigrationStats]:
    """Incremental superblock migration: reuse the OLD device buffer.

    Called AFTER ``store.apply_migration(plan)`` with the PRE-migration
    superblock (grab it with ``take_superblock`` before applying).  Builds
    the post-migration superblock without the naive rebuild's full
    host→device re-upload.  ``pids`` migrates a partition GROUP instead of
    the whole store: the new superblock covers exactly those (new)
    partitions, and rows whose source partition lies outside the old group
    superblock ride the delta (``install`` is ignored for groups — the
    group manager owns their pinning via ``SuperblockGroups.install``):

      * every BN-row tile of the new superblock whose rows sit consecutively
        inside one aligned segment of the OLD superblock is copied
        device-to-device by ``kernels.ops.segment_move`` (ONE launch for the
        whole migration) — these tiles never cross the host link again;
      * only the remaining tiles (rows migration moved across partition
        boundaries, plus genuinely new rows) are packed into a small delta
        block and uploaded.

    The host mirror is still assembled in full (one vectorized O(ΣR×D)
    numpy pass, sourced from the old host copy + delta so it stays
    bit-identical to the device result).  Returns (new_superblock, stats);
    ``install`` slots the result into the store's epoch cache (under the old
    superblock's cache key) so the next wave hits.

    ``use_kernel=None`` resolves to "is the old device buffer live?": if a
    copy is on the device, dropping it for a full re-upload is exactly the
    naive cost this path exists to avoid; if none is, there is nothing to
    reuse and the migration stays host-side."""
    # fires before any assembly: the old superblock (host + device copy) is
    # still whole, so callers can degrade to a lazy rebuild-on-next-touch
    fault_point("migrate.superblock", store)
    t0 = time.perf_counter()
    if use_kernel is None:
        use_kernel = old_sb._device is not None
    parts = _select_parts(store, pids)
    plan_idx = list(range(len(parts))) if pids is None \
        else [int(q) for q in pids]
    bn, row_offsets, bounds, d, bd, d_pad, total, dtype = _superblock_layout(
        parts, old_sb.block_n, old_sb.bd)
    if d != old_sb.d or bd != old_sb.bd or bn != old_sb.block_n:
        raise ValueError(
            f"migration changed the superblock tiling (d {old_sb.d}->{d}, "
            f"bd {old_sb.bd}->{bd}, bn {old_sb.block_n}->{bn}) — rebuild "
            "with build_superblock instead")
    n_tiles = total // bn
    sel = np.ones(n_tiles, np.int32)          # default: delta
    starts = np.zeros(n_tiles, np.int32)
    host = np.zeros((total, d_pad), dtype=dtype)
    delta_rows: list[np.ndarray] = []
    # old pid -> old superblock segment slot (identity for a whole-store
    # superblock; source pids OUTSIDE a group superblock become inserts)
    if old_sb.pids is None:
        old_slot_map = np.arange(len(old_sb.bounds), dtype=np.int64)
    else:
        old_pids = np.asarray(old_sb.pids, np.int64)
        old_slot_map = np.full(int(old_pids.max()) + 1 if len(old_pids)
                               else 0, -1, np.int64)
        old_slot_map[old_pids] = np.arange(len(old_pids))

    for g, (p, off) in enumerate(zip(parts, row_offsets)):
        i = plan_idx[g]
        r = p.block.shape[0]
        t = int((bounds[g] - off) // bn)
        if t == 0:
            continue
        # per-row source position in the OLD superblock (-1 = not there)
        src = np.full(t * bn, -1, np.int64)
        spid = np.asarray(plan.src_pid_rows[i])
        sloc = np.asarray(plan.src_loc_rows[i])
        sslot = np.full(len(spid), -1, np.int64)
        in_map = (spid >= 0) & (spid < len(old_slot_map))
        sslot[in_map] = old_slot_map[spid[in_map]]
        hit = sslot >= 0
        if hit.any():
            src[:r][hit] = old_sb.row_offsets[sslot[hit]] + sloc[hit]
        t_base = int(off) // bn
        for k in _reuse_tiles(sel, starts, host, old_sb, src, r, int(off),
                              bn):
            dst = slice(int(off) + k * bn, int(off) + (k + 1) * bn)
            rows = np.zeros((bn, d_pad), dtype=dtype)
            lo = int(k) * bn
            valid = min(bn, r - lo) if r > lo else 0
            if valid > 0:
                rows[:valid, :d] = p.block[lo:lo + valid]
            starts[t_base + k] = len(delta_rows) * bn
            delta_rows.append(rows)
            host[dst] = rows

    delta = np.concatenate(delta_rows, axis=0) if delta_rows else None
    reused = int((sel == 0).sum())
    new_sb = Superblock(host=host, row_offsets=row_offsets, bounds=bounds,
                        d=d, bd=bd, block_n=bn,
                        epoch=int(getattr(store, "epoch", 0)),
                        target=_store_device(store),
                        pids=None if pids is None
                        else np.asarray(plan_idx, np.int64))
    used_device, bytes_uploaded = _assemble_on_device(
        new_sb, old_sb, delta, sel, starts, use_kernel, K.segment_move)
    if install and pids is None:
        key = getattr(old_sb, "cache_key", None) or (None, None)
        new_sb.cache_key = key
        cache = getattr(store, "_superblock_cache", None)
        if cache is None:
            cache = {}
            try:
                store._superblock_cache = cache
            except AttributeError:
                cache = None
        if cache is not None:
            cache[key] = new_sb
    stats = MigrationStats(
        n_tiles=n_tiles, reused_tiles=reused, delta_tiles=n_tiles - reused,
        bytes_uploaded=bytes_uploaded, bytes_total=int(host.nbytes),
        used_device=used_device, wall_s=time.perf_counter() - t0)
    return new_sb, stats


def _assemble_on_device(new_sb: Superblock, old_sb: Superblock,
                        delta: Optional[np.ndarray], sel: np.ndarray,
                        starts: np.ndarray, use_kernel: bool,
                        kernel) -> tuple[bool, int]:
    """The device half of a migration or commit extension: when the old
    superblock is on the device (and the kernel tier is asked for), ONE
    segment kernel launch assembles the new device copy from the old one
    plus the uploaded delta.  Returns (used_device, bytes_uploaded)."""
    if not (use_kernel and old_sb._device is not None):
        return False, 0
    new_sb._device = kernel(old_sb._device, delta, sel, starts,
                            block_n=new_sb.block_n, block_d=new_sb.bd)
    bytes_uploaded = 0 if delta is None else int(delta.nbytes)
    new_sb.uploads = 1 if bytes_uploaded else 0
    return True, bytes_uploaded


# ------------------------------------- commit ingestion: in-place append --

def extend_superblock_after_commit(store, old_sb: Superblock,
                                   touched_old_grids: dict, *,
                                   pids: Optional[Sequence[int]] = None,
                                   use_kernel: Optional[bool] = None
                                   ) -> tuple[Superblock, MigrationStats]:
    """Grow a superblock IN PLACE after a commit wave: reuse the OLD device
    buffer, upload only the new BN-aligned tiles.

    Called AFTER ``commit_version``/``commit_many`` swapped the store, with
    the PRE-commit superblock and ``touched_old_grids`` — the pre-commit
    ``grids`` array per touched partition SLOT (``store.partitions``
    index).  Commits only GROW partitions (existing rows keep their grids;
    new rids interleave into the sorted grid set), so every post-commit row
    either maps to an old superblock row (searchsorted against the old
    grids) or is new:

      * BN-row tiles whose rows sit consecutively inside one aligned old
        segment are device-to-device copies (``kernels.ops.segment_append``
        sel 0 — untouched partitions reuse ALL their tiles);
      * tiles holding any new/shifted row ride a small host delta (sel 1 —
        the only bytes a commit wave sends over the link);
      * freshly aligned all-pad tiles zero-fill on device (sel 2 — no
        upload, no source read).

    ``pids`` selects a partition GROUP (the new superblock covers those
    slots); None extends a whole-store superblock — a commit that opened a
    brand-new partition appends it as an all-delta segment.  Raises
    ValueError when the commit changed the tiling (d/bd/bn) — callers
    degrade to eviction + lazy rebuild.  Returns (new_sb, stats)."""
    # fires before ANY work — the old superblock (host + device copy) and
    # the group manager's accounting are untouched, so the caller degrades
    # to evicting just this group
    fault_point("ingest.append", store)
    t0 = time.perf_counter()
    parts_idx = (list(range(len(store.partitions))) if pids is None
                 else [int(q) for q in pids])
    parts = [store.partitions[q] for q in parts_idx]
    bn, row_offsets, bounds, d, bd, d_pad, total, dtype = _superblock_layout(
        parts, old_sb.block_n, old_sb.bd)
    if d != old_sb.d or bd != old_sb.bd or bn != old_sb.block_n:
        raise ValueError(
            f"commit changed the superblock tiling (d {old_sb.d}->{d}, "
            f"bd {old_sb.bd}->{bd}, bn {old_sb.block_n}->{bn}) — rebuild "
            "with build_superblock instead")
    n_tiles = total // bn
    sel = np.ones(n_tiles, np.int32)          # default: delta
    starts = np.zeros(n_tiles, np.int32)
    host = np.zeros((total, d_pad), dtype=dtype)
    delta_rows: list[np.ndarray] = []
    n_old_seg = len(old_sb.row_offsets)
    for g, (p, off) in enumerate(zip(parts, row_offsets)):
        q = parts_idx[g]
        r = p.block.shape[0]
        t = int((bounds[g] - off) // bn)
        if t == 0:
            continue
        # per-row source position in the OLD superblock (-1 = new row)
        src = np.full(t * bn, -1, np.int64)
        if g < n_old_seg:
            old_off = int(old_sb.row_offsets[g])
            if q not in touched_old_grids:
                # untouched partition: identical block, identity mapping
                src[:r] = old_off + np.arange(r)
            else:
                og = np.asarray(touched_old_grids[q], np.int64)
                if len(og):
                    pos = np.clip(np.searchsorted(og, p.grids), 0,
                                  len(og) - 1)
                    hit = og[pos] == p.grids
                    src[:r][hit] = old_off + pos[hit]
        t_base = int(off) // bn
        for k in _reuse_tiles(sel, starts, host, old_sb, src, r, int(off),
                              bn):
            lo = int(k) * bn
            valid = min(bn, r - lo) if r > lo else 0
            if valid <= 0:
                sel[t_base + k] = 2     # alignment slack: zero-fill on
                continue                # device, upload nothing
            rows = np.zeros((bn, d_pad), dtype=dtype)
            rows[:valid, :d] = p.block[lo:lo + valid]
            starts[t_base + k] = len(delta_rows) * bn
            delta_rows.append(rows)
            host[int(off) + lo:int(off) + lo + bn] = rows

    delta = np.concatenate(delta_rows, axis=0) if delta_rows else None
    new_sb = Superblock(host=host, row_offsets=row_offsets, bounds=bounds,
                        d=d, bd=bd, block_n=bn,
                        epoch=int(getattr(store, "epoch", 0)),
                        target=_store_device(store),
                        pids=None if pids is None
                        else np.asarray(parts_idx, np.int64))
    used_device, bytes_uploaded = _assemble_on_device(
        new_sb, old_sb, delta, sel, starts,
        True if use_kernel is None else use_kernel, K.segment_append)
    stats = MigrationStats(
        n_tiles=n_tiles, reused_tiles=int((sel == 0).sum()),
        delta_tiles=int((sel == 1).sum()), bytes_uploaded=bytes_uploaded,
        bytes_total=int(host.nbytes), used_device=used_device,
        wall_s=time.perf_counter() - t0)
    return new_sb, stats


def refresh_superblocks_after_commit(store, touched_old_grids: dict, *,
                                     extend: bool = True,
                                     use_kernel: Optional[bool] = None
                                     ) -> dict:
    """Targeted post-commit superblock maintenance — the commit path's
    replacement for ``evict_superblocks``'s nuke-everything.

    ``touched_old_grids`` maps each partition SLOT the commit grew to its
    PRE-commit ``grids``.  Policy, per cached superblock:

      * a pinned group whose partitions the commit did NOT touch is
        revalidated at the new epoch in place — zero work, zero upload
        (commits only grow the receiving partitions; untouched slots keep
        their exact blocks), so cold groups STAY pinned;
      * a touched superblock (group or whole-store) is extended in place
        via ``extend_superblock_after_commit`` — only the new BN-aligned
        tiles cross the host link; on any failure (tiling change, budget,
        injected ``ingest.append`` fault) THAT superblock alone degrades
        to eviction + lazy rebuild — except a ``KernelError`` (the kernel
        did not build, launch or take its plan), which evicts the
        superblock and propagates;
      * genuinely stale entries (pre-dating the commit's epoch) are
        evicted as before.

    Callers (``commit_version``/``commit_many``) wrap it in a
    warn-and-continue guard.  Returns a report dict: revalidated/extended/
    evicted counts plus the wave's bytes_uploaded and delta_tiles."""
    report = {"revalidated": 0, "extended": 0, "evicted": 0,
              "bytes_uploaded": 0, "delta_tiles": 0}
    epoch = int(getattr(store, "epoch", 0))
    touched = set(int(s) for s in touched_old_grids)

    def extended(st: MigrationStats) -> None:
        report["extended"] += 1
        report["bytes_uploaded"] += st.bytes_uploaded
        report["delta_tiles"] += st.delta_tiles

    cache = getattr(store, "_superblock_cache", None)
    evicted = 0
    if cache:
        for ck in list(cache):
            sb = cache[ck]
            if sb.epoch == epoch - 1 and extend:
                try:
                    new_sb, st = extend_superblock_after_commit(
                        store, sb, touched_old_grids,
                        use_kernel=use_kernel)
                except Exception as exc:
                    cache.pop(ck)._device = None
                    if isinstance(exc, KernelError):
                        raise   # a kernel fault is never absorbed
                    evicted += 1
                    logger.warning(
                        "in-place superblock append failed; whole-store "
                        "copy rebuilds lazily", exc_info=True)
                    continue
                new_sb.cache_key = ck
                cache[ck] = new_sb
                sb._device = None
                extended(st)
            else:
                cache.pop(ck)._device = None
                evicted += 1
    if evicted:
        try:
            store._superblock_evictions = \
                getattr(store, "_superblock_evictions", 0) + evicted
        except AttributeError:
            pass
        report["evicted"] += evicted
    mgr = getattr(store, "_superblock_groups", None)
    if mgr is None:
        return report
    kept: set[tuple] = set(
        k for k, sb in mgr.groups.items() if sb.epoch == epoch - 1)
    for key in list(mgr.groups):
        sb = mgr.groups.get(key)
        if sb is None:          # a _make_room below already evicted it
            kept.discard(key)
            continue
        if sb.epoch != epoch - 1:
            mgr._evict(key)
            report["evicted"] += 1
            continue
        if not (set(key) & touched):
            # cold group: no member grew, its bytes are still exact —
            # revalidate at the new epoch, zero work, stays pinned
            sb.epoch = epoch
            report["revalidated"] += 1
            continue
        if not extend:
            kept.discard(key)
            mgr._evict(key)
            report["evicted"] += 1
            continue
        try:
            need = estimate_superblock_bytes(
                store, block_n=mgr.block_n, block_d=mgr.block_d, pids=key)
            grow = need - int(sb.host.nbytes)
            if grow > 0 and not mgr._make_room(grow, protected=kept):
                raise ValueError(
                    f"grown group {key} no longer fits the budget")
            new_sb, st = extend_superblock_after_commit(
                store, sb, touched_old_grids, pids=key,
                use_kernel=use_kernel)
        except Exception as exc:
            kept.discard(key)
            if key in mgr.groups:
                mgr._evict(key)
            if isinstance(exc, KernelError):
                raise           # a kernel fault is never absorbed
            report["evicted"] += 1
            logger.warning("in-place group superblock append failed; "
                           "group rebuilds lazily on next touch",
                           exc_info=True)
            continue
        # swap in place: len(groups) unchanged, so pins - evictions still
        # equals the pinned-group count; LRU position is preserved
        new_sb.cache_key = key
        mgr.groups[key] = new_sb
        mgr.group_bytes[key] = int(new_sb.host.nbytes)
        mgr.pinned_bytes += int(new_sb.host.nbytes) - int(sb.host.nbytes)
        sb._device = None
        extended(st)
    return report


# ------------------------------------------------------------- entry points --

def checkout_partitioned(store, vids: Sequence[int], *,
                         use_kernel: bool = True,
                         engine: str = "wave",
                         device_out: bool = False):
    """Batched checkout over a PartitionedCVD, results in request order.

    engine="wave" (default): ONE fused gather for the whole wave via the
    device-resident superblock.  engine="perpart": one fused gather PER
    PARTITION (kept as oracle and baseline).

    ``device_out=True`` returns a ``WaveResult`` handle (kernel-tier wave
    gathers stay device-resident and in flight; perpart/host results ride
    the handle pre-materialized) — the serve pipeline's dispatch hook.
    """
    if engine == "wave":
        return checkout_wave(store, vids, use_kernel=use_kernel,
                             device_out=device_out)
    if engine == "perpart":
        mats = checkout_partitioned_perpart(store, vids,
                                            use_kernel=use_kernel)
        return WaveResult.from_mats(mats) if device_out else mats
    raise ValueError(f"unknown engine {engine!r} (use 'wave' or 'perpart')")


def checkout_partitioned_perpart(store, vids: Sequence[int], *,
                                 use_kernel: bool = True
                                 ) -> list[np.ndarray]:
    """Per-partition engine: one fused gather (one launch on the store's
    device) per partition touched by the wave."""
    vids = _validate_vids(store, vids)
    by_pid: dict[int, list[int]] = {}
    for i, v in enumerate(vids):
        by_pid.setdefault(int(store.vid_to_pid[v]), []).append(i)
    out: list[Optional[np.ndarray]] = [None] * len(vids)
    device = getattr(store, "device", None)
    for pid, req_idx in by_pid.items():
        p = store.partitions[pid]
        rls = [p.local_rlist(vids[i]) for i in req_idx]
        mats = checkout_rlists(p.block, rls, use_kernel=use_kernel,
                               device=device)
        for i, m in zip(req_idx, mats):
            out[i] = m
    return out  # type: ignore[return-value]


def checkout_versions_loop(graph: BipartiteGraph, data: np.ndarray,
                           vids: Sequence[int]) -> list[np.ndarray]:
    """Seed path: one gather per version — the oracle for the fused engine."""
    return [data[graph.rlist(int(v))] for v in vids]
