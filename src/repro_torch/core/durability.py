"""Crash-safe store durability: epoch-tagged snapshots of everything the
serve/migration pipeline cannot recompute, persisted through the trainer's
content-dedup checkpoint CVD (``train.checkpoint.CheckpointStore``), plus
the write-ahead journal (``core.journal``) that closes the between-
snapshots window to ZERO RPO.

What a ``StoreSnapshot`` captures — and deliberately does NOT:

  * the version graph CSR, base data and partitioning assignment (the
    store's identity) — saved BITEXACT (int64 rids must not round-trip
    through fp32) and parent-chained, so consecutive snapshots dedup every
    unchanged row block (Bhattacherjee et al.'s storage/recreation
    tradeoff: persist the cheap-to-store state, recreate the rest);
  * the maintenance-loop state a restart would otherwise cold-start:
    ``DensityStats`` (streak + per-vid EWMAs), ``HotSetPolicy`` heat,
    the ``SuperblockGroups`` layout plan and all-time counters, and the
    serve ticket watermark (restored tickets never collide with
    pre-crash ones);
  * NOT the device superblocks: they are pure recreations of host state —
    ``restore()`` returns a store on the device it is given (the card
    unless the caller names the CPU) whose first ``warmup()`` (or first
    wave) re-pins them lazily, hot-first, under the same budget.

The crash-recovery contract (the fault suite's bar — swept across all
22 catalogued fault sites in ``core.faults.SITES``; the count is kept
in sync by ``tools.analyze`` rule REPRO001):

  * **journal** — every store mutation after a snapshot (version commits,
    migration intent→commit pairs, repartitions, regroup layouts, ticket
    watermark advances) appends a checksummed record to that generation's
    ``journal-<vid>.wal``; data-plane records fsync before the in-memory
    swap, so any operation that RETURNED survives any crash;
  * **verify** — every snapshot leaf carries a crc32 digest in the
    checkpoint manifest; ``restore()`` picks the newest snapshot whose
    digests verify, falling back along the parent chain past corrupt
    generations instead of resurrecting flipped bits;
  * **replay** — the journals of the chosen generation and every newer
    one replay in order (truncated at the first torn/bad record,
    idempotent by epoch/vid guards), landing a store bit-identical to the
    pre-crash state for all fsync-acknowledged operations;
  * **scrub** — ``scrub()`` runs the same digest + checksum sweep offline
    (detection only; restore does the healing), and ``prune()`` retires
    old generations without breaking the retained parent-chain dedup.

Counter invariants across the cycle: the group layer's
``pins - evictions == len(groups)`` must hold on the restored store too;
since a restored store has ZERO pinned groups, the snapshot folds the
still-pinned count into the persisted eviction counter (a kill IS an
eviction of every pinned group).  The recovery suite asserts this plus
zero leaked reservations and device buffers.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np

from ..kernels.ops import resolve_device
from .checkout import (DensityStats, SuperblockGroups, get_density_stats,
                       get_superblock_groups)
from .graph import BipartiteGraph
from .journal import (Journal, attach_journal, fsync_dir, read_records,
                      replay_into)
from .online import HotSetPolicy, get_hot_set_policy
from .partition import PartitionedCVD

logger = logging.getLogger(__name__)

_TREE_TEMPLATE = {"assignment": 0, "data": 0,
                  "graph_indices": 0, "graph_indptr": 0}

# Snapshot meta schema version.  v1: pre-format_version snapshots (no
# journal, no digests).  v2: adds format_version + journal generations.
# Readers tolerate anything <= their own version (missing fields default);
# a FUTURE version refuses loudly instead of misreading new semantics.
SNAPSHOT_FORMAT = 2


@dataclasses.dataclass(frozen=True)
class StoreSnapshot:
    """One persisted snapshot: the checkpoint-CVD vid plus the host-state
    meta that rebuilds the maintenance loop."""
    vid: int
    epoch: int
    meta: dict


@dataclasses.dataclass
class RestoredStore:
    """A store rebuilt from a snapshot (+ journal replay), plus the
    serve-side watermarks.

    ``store`` is live immediately (host path); device superblocks are
    rebuilt lazily — call ``make_server(...).warmup()`` to pre-pin them.
    ``make_server`` seeds each server's ticket counter past its TENANT's
    watermark — the max of the snapshot's record and any journaled
    advance — so restored tickets never collide with pre-crash ones; and
    because global ticket identity is (tenant, ticket), two servers
    restored from the same snapshot can never mint overlapping ids: a
    caller-supplied tenant gets that tenant's watermark, and anonymous
    servers get distinct auto-assigned namespaces."""
    store: PartitionedCVD
    snapshot: StoreSnapshot
    ticket_watermark: int                       # legacy: max across tenants
    ticket_watermarks: dict = dataclasses.field(default_factory=dict)
    replayed: int = 0                           # journal records applied
    _minted: int = dataclasses.field(default=0, repr=False)

    def make_server(self, *, tenant=None, **kwargs):
        # lazy import: serve imports core, not the other way around
        from ..serve.checkout import BatchedCheckoutServer
        if tenant is None:
            # distinct namespace per anonymous restore — the n-th unnamed
            # server is NOT the same ticket stream as the (n-1)-th
            # (named-tenant restores don't burn anonymous namespaces)
            tenant = (None if self._minted == 0
                      else f"restored-{self._minted}")
            self._minted += 1
        srv = BatchedCheckoutServer(self.store, tenant=tenant, **kwargs)
        key = "" if tenant is None else str(tenant)
        srv._next_ticket = int(self.ticket_watermarks.get(
            key, self.ticket_watermark))
        return srv


def _density_meta(store) -> Optional[dict]:
    stats = get_density_stats(store)
    if stats is None:
        return None
    return {"low_threshold": float(stats.low_threshold),
            "ewma_alpha": float(stats.ewma_alpha),
            "waves": int(stats.waves), "tiles": int(stats.tiles),
            "run_tiles": float(stats.run_tiles),
            "low_streak": int(stats.low_streak),
            "last_wave_density": float(stats.last_wave_density),
            "per_vid": {str(int(v)): float(d)
                        for v, d in stats.per_vid.items()}}


def _heat_meta(store) -> Optional[dict]:
    pol = getattr(store, "_hot_set_policy", None)
    if pol is None:
        return None
    return {"alpha": float(pol.alpha), "waves": int(pol.waves),
            "ewma": {str(int(p)): [float(v), int(seen)]
                     for p, (v, seen) in pol.touch_ewma.items()}}


def _groups_meta(store) -> Optional[dict]:
    mgr = get_superblock_groups(store)
    if mgr is None:
        return None
    return {"budget": int(mgr.budget),
            "block_n": None if mgr.block_n is None else int(mgr.block_n),
            "block_d": None if mgr.block_d is None else int(mgr.block_d),
            "planned": [[int(q) for q in key] for key in mgr.planned],
            "stragglers": sorted(int(q) for q in mgr.straggler_pids),
            # a kill evicts every pinned group: folding the pinned count
            # into the persisted evictions keeps pins - evictions ==
            # len(groups) (== 0) true on the restored, nothing-pinned store
            "pins": int(mgr.pins),
            "evictions": int(mgr.evictions) + len(mgr.groups),
            "launches": int(mgr.launches), "waves": int(mgr.waves),
            "groups_touched": int(mgr.groups_touched),
            "straggler_requests": int(mgr.straggler_requests)}


class StoreDurability:
    """Snapshot and restore over one checkpoint directory.

    Snapshots parent-chain automatically (each dedups against the
    previous one); ``restore()`` with no vid rebuilds the newest VERIFIED
    generation and replays its journal chain.  The underlying
    ``CheckpointStore`` persists atomically (tmp + rename + directory
    fsync), so a process killed mid-snapshot leaves the previous
    generation restorable — the crash-recovery contract the fault suite
    exercises.

    ``journal=True`` (default) rotates a write-ahead journal per snapshot
    generation and attaches it to the snapshotted store, so every store
    mutation between snapshots is replayable; ``journal=False`` is the
    snapshot-only behavior (RPO = snapshot cadence).
    """

    def __init__(self, directory: str, *, shard_rows: int = 1 << 12,
                 journal: bool = True):
        # lazy import: train imports core itself
        from ..train.checkpoint import CheckpointStore
        self.ckpt = CheckpointStore(directory, shard_rows=shard_rows)
        self.journal_enabled = bool(journal)
        self._journal: Optional[Journal] = None

    def _journal_path(self, vid: int) -> str:
        return os.path.join(self.ckpt.directory, f"journal-{int(vid)}.wal")

    @property
    def journal(self) -> Optional[Journal]:
        """The ACTIVE journal (the newest generation's), None before the
        first snapshot or with journaling disabled."""
        return self._journal

    # -- write plane -----------------------------------------------------------
    def snapshot(self, store, *, server=None, servers=None) -> StoreSnapshot:
        """Persist the store and the serve-side ticket watermarks, then
        ROTATE the journal: the fresh generation's ``journal-<vid>.wal``
        is attached to ``store`` and records every mutation until the next
        snapshot (old generations' journals are kept — the parent-chain
        fallback replays through them).  Cheap on the steady path:
        unchanged graph/data/assignment rows dedup against the parent
        snapshot, so only the meta JSON and genuinely new rows hit disk.

        ``server`` persists one server's watermark (the single-tenant
        path); ``servers`` takes an iterable of ``BatchedCheckoutServer``s,
        a ``{tenant: server}`` mapping, or a ``serve.tenancy.
        MultiTenantServer`` (its tenant servers are enumerated directly)
        and persists each one's watermark under its TENANT namespace —
        what lets two restored servers resume their own ticket streams
        instead of minting overlapping ids."""
        tree = {"assignment": np.asarray(store.assignment, np.int64),
                "data": np.asarray(store.data),
                "graph_indices": np.asarray(store.graph.indices, np.int64),
                "graph_indptr": np.asarray(store.graph.indptr, np.int64)}
        sb_budget = getattr(store, "superblock_max_bytes", None)
        marks: dict[str, int] = {}
        srv_list = []
        if server is not None:
            srv_list.append(server)
        if servers is not None:
            if hasattr(servers, "tenant_servers"):   # MultiTenantServer
                srv_list.extend(servers.tenant_servers().values())
            elif hasattr(servers, "values"):
                srv_list.extend(servers.values())
            else:
                srv_list.extend(servers)
        for srv in srv_list:
            tenant = getattr(srv, "tenant", None)
            key = "" if tenant is None else str(tenant)
            if key in marks:
                raise ValueError(
                    f"two servers share the ticket namespace {key or None!r}"
                    " — snapshotting both would alias their watermarks")
            marks[key] = int(srv._next_ticket)
        meta = {"kind": "store-snapshot",
                "format_version": SNAPSHOT_FORMAT,
                "epoch": int(getattr(store, "epoch", 0)),
                "n_records": int(store.graph.n_records),
                "superblock_max_bytes":
                    None if sb_budget is None else int(sb_budget),
                # legacy scalar (max across tenants) kept so old snapshots
                # and old readers interoperate; the dict is the real record
                "ticket_watermark": max(marks.values(), default=0),
                "ticket_watermarks": marks,
                "density": _density_meta(store),
                "heat": _heat_meta(store),
                "groups": _groups_meta(store)}
        parent = self.latest_vid()
        vid = self.ckpt.save(step=len(self.snapshots()), tree=tree,
                             parent_vid=parent, meta=meta, bitexact=True)
        if self.journal_enabled:
            if self._journal is not None:
                self._journal.close()
            j = Journal(self._journal_path(vid), owner=store)
            attach_journal(store, j)
            self._journal = j
        return StoreSnapshot(vid=vid, epoch=meta["epoch"], meta=meta)

    # -- read plane ------------------------------------------------------------
    def snapshots(self) -> list[int]:
        """Snapshot vids, oldest first (non-snapshot versions the caller
        committed into the same CVD are skipped)."""
        return sorted(
            int(v) for v, info in self.ckpt.manifest["versions"].items()
            if info.get("meta", {}).get("kind") == "store-snapshot")

    def latest_vid(self) -> Optional[int]:
        vids = self.snapshots()
        return vids[-1] if vids else None

    def verify(self, vid: int) -> list[str]:
        """Digest-check one snapshot generation; returns the leaf paths
        that fail (empty = verified; pre-digest snapshots verify
        vacuously)."""
        return self.ckpt.verify(int(vid))

    def _pick_verified(self, snaps: list[int]) -> int:
        """The newest snapshot whose digests verify, walking the parent
        chain past corrupt generations — journal replay of the newer
        generations' journals recovers what the skipped snapshots held."""
        skipped = []
        for v in reversed(snaps):
            bad = self.verify(v)
            if not bad:
                if skipped:
                    logger.warning(
                        "snapshot(s) %s failed digest verification; "
                        "falling back to %d + journal replay", skipped, v)
                return v
            skipped.append(v)
        raise ValueError(
            f"every snapshot failed digest verification ({skipped}) — "
            "no uncorrupted generation to restore from")

    def restore(self, vid: Optional[int] = None, *, verify: bool = True,
                replay: Optional[bool] = None,
                device=None) -> RestoredStore:
        """Rebuild a live store: the newest VERIFIED snapshot (or ``vid``)
        plus deterministic replay of the journal chain.

        With no ``vid``, generations whose digests fail verification are
        skipped (parent-chain fallback) and the journals of the chosen
        generation AND every newer one replay in order — each truncated
        at its first torn/bad record — so the result is bit-identical to
        the pre-crash store for every fsync-acknowledged operation.  An
        explicit ``vid`` that fails verification raises instead (the
        caller asked for that generation specifically).  ``verify=False``
        trusts the bytes; ``replay=False`` restores
        the bare snapshot (RPO = snapshot cadence).  ``device`` is where
        the restored store lives and its kernels run (None = the card,
        raising when there is none, before anything is read); its host
        state (data, CSR, assignment) stays numpy.

        The returned store is on the resulting epoch with partitioning,
        heat and density state reattached; the group layout plan is
        restored with ZERO pinned groups (counters folded — see module
        docstring), and the first warmup()/wave re-pins lazily.  The
        newest generation's journal is re-attached for appending, so the
        restored store keeps journaling where the dead one stopped."""
        dev = resolve_device(device)
        if replay is None:
            replay = self.journal_enabled
        snaps = self.snapshots()
        if not snaps:
            raise ValueError("no snapshots to restore")
        if vid is None:
            vid = self._pick_verified(snaps) if verify else snaps[-1]
        else:
            vid = int(vid)
            info = self.ckpt.manifest["versions"].get(str(vid))
            if info is None or info.get("meta", {}).get("kind") \
                    != "store-snapshot":
                raise ValueError(f"vid {vid} is not a store snapshot")
            if verify:
                bad = self.verify(vid)
                if bad:
                    raise ValueError(
                        f"snapshot {vid} failed digest verification "
                        f"({bad}); restore() with no vid falls back along "
                        "the parent chain instead")
        meta = self.ckpt.manifest["versions"][str(vid)]["meta"]
        fmt = int(meta.get("format_version", 1))
        if fmt > SNAPSHOT_FORMAT:
            raise ValueError(
                f"snapshot {vid} has format_version {fmt}, newer than "
                f"this reader ({SNAPSHOT_FORMAT}) — upgrade before "
                "restoring it")
        tree = self.ckpt.restore(vid, treedef_like=_TREE_TEMPLATE)
        data = np.asarray(tree["data"])
        graph = BipartiteGraph(
            indptr=np.asarray(tree["graph_indptr"], np.int64),
            indices=np.asarray(tree["graph_indices"], np.int64),
            n_records=int(meta.get("n_records", len(data))))
        store = PartitionedCVD(graph, data,
                               np.asarray(tree["assignment"], np.int64),
                               device=dev)
        store.epoch = int(meta.get("epoch", 0))
        if meta.get("superblock_max_bytes") is not None:
            store.superblock_max_bytes = int(meta["superblock_max_bytes"])
        d = meta.get("density")
        if d is not None:
            stats = DensityStats(
                low_threshold=float(d["low_threshold"]),
                ewma_alpha=float(d["ewma_alpha"]), waves=int(d["waves"]),
                tiles=int(d["tiles"]), run_tiles=float(d["run_tiles"]),
                low_streak=int(d["low_streak"]),
                last_wave_density=float(d["last_wave_density"]),
                per_vid={int(v): float(x)
                         for v, x in d["per_vid"].items()})
            store._density_stats = stats
        h = meta.get("heat")
        if h is not None:
            pol = HotSetPolicy(alpha=float(h["alpha"]))
            pol.waves = int(h["waves"])
            pol.touch_ewma = {int(p): (float(v), int(seen))
                              for p, (v, seen) in h["ewma"].items()}
            store._hot_set_policy = pol
        g = meta.get("groups")
        if g is not None:
            mgr = SuperblockGroups(
                store, int(g["budget"]),
                block_n=None if g["block_n"] is None else int(g["block_n"]),
                block_d=None if g["block_d"] is None else int(g["block_d"]))
            mgr.planned = [tuple(int(q) for q in key)
                           for key in g["planned"]]
            for key in mgr.planned:
                for q in key:
                    mgr.pid_to_group[q] = key
            mgr.straggler_pids = set(int(q) for q in g["stragglers"])
            mgr.pins = int(g["pins"])
            mgr.evictions = int(g["evictions"])
            mgr.launches = int(g["launches"])
            mgr.waves = int(g["waves"])
            mgr.groups_touched = int(g["groups_touched"])
            mgr.straggler_requests = int(g["straggler_requests"])
            mgr.epoch = store.epoch
            mgr._plan_epoch = store.epoch   # the plan IS this epoch's plan
            store._superblock_groups = mgr
            get_hot_set_policy(store, create=True)
        marks = {str(k): int(v)
                 for k, v in meta.get("ticket_watermarks", {}).items()}
        replayed = 0
        newest_journal: Optional[Journal] = None
        if replay:
            chain = [v for v in snaps if v >= vid]
            for i, gen in enumerate(chain):
                path = self._journal_path(gen)
                if gen == snaps[-1]:
                    if not os.path.exists(path) \
                            and not self.journal_enabled:
                        continue
                    # the head generation's journal gets REPAIRED (torn
                    # tail truncated) and reopened for appending: the
                    # restored store journals on from where the dead
                    # process stopped
                    newest_journal = Journal(path)
                    recs = newest_journal.recover()
                elif os.path.exists(path):
                    recs, bad = read_records(path)
                    if bad is not None:
                        logger.warning(
                            "journal %s: ignoring bad tail at byte %d "
                            "(%d records replayable)", path, bad, len(recs))
                else:
                    continue
                if recs:
                    out = replay_into(store, recs)
                    replayed += out["applied"]
                    for k, w in out["ticket_watermarks"].items():
                        marks[k] = max(marks.get(k, 0), w)
        if newest_journal is not None:
            attach_journal(store, newest_journal)
            self._journal = newest_journal
        snap = StoreSnapshot(vid=int(vid), epoch=int(meta.get("epoch", 0)),
                             meta=meta)
        legacy = int(meta.get("ticket_watermark", 0))
        return RestoredStore(store=store, snapshot=snap,
                             ticket_watermark=max(
                                 [legacy, *marks.values()], default=0),
                             ticket_watermarks=marks, replayed=replayed)

    # -- integrity plane -------------------------------------------------------
    def scrub(self) -> dict:
        """Offline integrity sweep over every generation: recompute each
        snapshot's per-leaf digests and walk each journal's record
        checksums.  DETECTION only — nothing is modified (``restore()``
        does the healing: parent-chain fallback + truncated replay).

        Returns ``{"snapshots": {vid: [bad leaf paths]},
        "journals": {vid: {"records", "bad_offset"}}, "clean": bool}`` —
        ``clean`` iff every digest and every record checks out (zero
        false positives on an uncorrupted store is part of the recovery
        suite's bar)."""
        if self._journal is not None:
            self._journal.flush(sync=False)   # buffered advisory tail
        report: dict = {"snapshots": {}, "journals": {}, "clean": True}
        for v in self.snapshots():
            bad = self.verify(v)
            report["snapshots"][v] = bad
            if bad:
                report["clean"] = False
            path = self._journal_path(v)
            if os.path.exists(path):
                recs, bad_off = read_records(path)
                report["journals"][v] = {"records": len(recs),
                                         "bad_offset": bad_off}
                if bad_off is not None:
                    report["clean"] = False
        return report

    # -- retention plane -------------------------------------------------------
    def prune(self, keep_last: int) -> dict:
        """Retire all but the newest ``keep_last`` snapshot generations.

        The checkpoint CVD is compacted around the retained vids: the
        oldest KEPT snapshot re-anchors as a parentless full commit and
        each newer one re-parents on its predecessor, so the retained
        chain keeps its content dedup while every dropped generation's
        rows (and any non-snapshot versions sharing the CVD) are
        physically gone.  Journal files follow their generation — dropped
        ones are deleted, kept ones renamed to their new vids — so
        ``restore()`` still replays the full tail.  Returns the
        ``{old_vid: new_vid}`` mapping for the retained snapshots."""
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1 ({keep_last})")
        snaps = self.snapshots()
        if len(snaps) <= keep_last:
            return {v: v for v in snaps}
        keep = snaps[-keep_last:]
        dropped = [v for v in snaps if v not in keep]
        if self._journal is not None:
            self._journal.flush()
        mapping = self.ckpt.compact(keep)
        for v in dropped:
            path = self._journal_path(v)
            if os.path.exists(path):
                os.remove(path)
        for old in keep:                     # ascending: new vid <= old vid
            new = mapping[old]
            if new != old and os.path.exists(self._journal_path(old)):
                os.replace(self._journal_path(old), self._journal_path(new))
        fsync_dir(self.ckpt.directory)
        if self._journal is not None:
            # the active journal file moved: reopen under its new name and
            # keep the snapshotted store's attachment current
            store = self._journal._owner
            self._journal.close()
            j = Journal(self._journal_path(mapping[snaps[-1]]), owner=store)
            self._journal = j
            if store is not None:
                attach_journal(store, j)
        return mapping

    def lineage(self, vid: int) -> list[int]:
        return self.ckpt.lineage(vid)

    def dedup_ratio(self) -> float:
        return self.ckpt.dedup_ratio()


def snapshot_roundtrip_equal(a, b) -> bool:
    """True iff two stores carry identical persisted state (graph, data,
    assignment, epoch) — the recovery tests' cheap equality check."""
    return (int(getattr(a, "epoch", 0)) == int(getattr(b, "epoch", 0))
            and np.array_equal(a.graph.indptr, b.graph.indptr)
            and np.array_equal(a.graph.indices, b.graph.indices)
            and np.array_equal(a.assignment, b.assignment)
            and np.array_equal(a.data, b.data))
