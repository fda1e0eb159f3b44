"""Write-ahead intent journal: the zero-RPO half of the durability story.

``core.durability`` snapshots make the store crash-safe up to the LAST
snapshot; everything after it — version commits, migrations, regroup
layout changes, ticket-watermark advances — used to be lost on a kill.
This module closes that window with the classic WAL contract:

  * every store mutation between snapshots appends ONE framed,
    crc-checksummed record to an append-only per-generation journal file
    (``journal-<snapshot_vid>.wal`` next to the checkpoint manifest);
  * data-plane records (``commit``, ``commit.batch``,
    ``migration.commit``) are appended and fsynced BEFORE the in-memory
    state swap — an operation that returned has its record durable
    (fsync-acknowledged), and an operation whose append failed mutated
    nothing, so a plain retry is always safe; a ``commit.batch`` record
    is a whole ``commit_many`` ingest wave group-committed under ONE
    fsync, and replays all-or-nothing (K commits inside one checksummed
    frame);
  * advisory records (``ticket`` watermarks, ``regroup`` layout) ride
    the same file buffered (no fsync of their own — they piggyback on
    the next synced record or ``close()``): losing the tail of them
    costs nothing the recovery contract promises;
  * recovery = newest VERIFIED snapshot + ``replay_into`` of the journal
    chain: the reader stops at the first torn/bad record (``recover()``
    truncates the file there), and replay is idempotent — every
    state-changing record carries the epoch/vid it produces, so a record
    whose effect is already present (snapshot taken after it) is
    skipped, never double-applied.

Record framing (little-endian)::

    MAGIC(4) | u32 payload_len | u32 crc32(payload) | payload

``payload`` is a pickled dict ``{"kind": ..., "seq": ..., ...}`` with
numpy arrays flattened to (bytes, dtype, shape) triples.  Every payload
value is a Python scalar, list, ``bytes`` or such a triple — never a torch
tensor, which would tie the file to torch and to a device — so the frames
are the JAX package's byte for byte and either package reads the other's.
A record is valid iff the magic matches, the full payload is present, and
the crc agrees — a torn write (short frame) or flipped bit fails the check
and truncates the readable prefix at the LAST good record.

Failure repair: ``append`` captures the end-of-file offset first and
truncates back to it on ANY exception (an injected ``journal.append``/
``journal.fsync``/``disk.torn_write``/``disk.bitflip`` fault, a real
ENOSPC), so a retried append never leaves a duplicate or a half-frame
behind *in process*.  A frame torn by a KILL mid-write has no in-process
handler — that is what the reader-side truncation repairs at restore.

Fault sites (``core.faults.SITES``): ``journal.append`` fires before any
bytes are written; ``disk.torn_write``/``disk.bitflip`` write a
deliberately damaged frame first (exercising the repair path the same
way a failing disk would); ``journal.fsync`` fires between the buffered
write and the fsync; ``journal.replay`` fires at ``replay_into`` entry,
before any record is applied.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

from .faults import InjectedFault, fault_point

logger = logging.getLogger(__name__)

MAGIC = b"OWJ1"
_HEADER = struct.Struct("<II")      # payload_len, crc32(payload)
_FRAME_MIN = len(MAGIC) + _HEADER.size

# record kinds whose replay mutates the store (appended sync=True by the
# mutation that owns them); everything else is advisory telemetry
DATA_KINDS = ("commit", "commit.batch", "migration.commit", "repartition")
ADVISORY_KINDS = ("migration.intent", "regroup", "ticket")


def _enc(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"b": arr.tobytes(), "dt": str(arr.dtype), "sh": list(arr.shape)}


def _dec(d: dict) -> np.ndarray:
    return np.frombuffer(d["b"], dtype=d["dt"]).reshape(d["sh"]).copy()


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One decoded journal record plus its physical position."""
    kind: str
    seq: int
    payload: dict
    offset: int          # byte offset of the frame start
    end: int             # byte offset one past the frame


class Journal:
    """One append-only journal file.  Thread-safe: N tenant servers and a
    migration coordinator append against the same store's journal."""

    def __init__(self, path: str, *, owner=None):
        self.path = path
        self._owner = owner          # store, for per-store fault plans
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        # all-time accounting (the fault suite balances these; the bench
        # reads write_s for the paired overhead measurement)
        self.appended = 0            # records acknowledged this process
        self.synced = 0              # fsyncs paid
        self.repairs = 0             # failed appends truncated away
        self.dropped = 0             # advisory appends absorbed on failure
        self.write_s = 0.0           # wall time inside append()
        self.seq = self._scan_seq()

    def _scan_seq(self) -> int:
        recs, _ = read_records(self.path)
        return recs[-1].seq + 1 if recs else 0

    # -- write plane -------------------------------------------------------
    def append(self, kind: str, payload: dict, *, sync: bool = True) -> int:
        """Append one record; returns its seq.  ``sync=True`` (the
        data-plane contract) returns only after the fsync — the record
        survives any subsequent crash.  On ANY failure the file is
        truncated back to its pre-append length: a retry appends a clean
        frame, never a duplicate."""
        t0 = time.perf_counter()
        with self._lock:
            fault_point("journal.append", self._owner)
            rec = dict(payload)
            rec["kind"] = kind
            rec["seq"] = self.seq
            data = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
            frame = MAGIC + _HEADER.pack(len(data), zlib.crc32(data)) + data
            self._f.seek(0, os.SEEK_END)
            start = self._f.tell()
            try:
                self._write_frame(frame)
                if sync:
                    fault_point("journal.fsync", self._owner)
                    os.fsync(self._f.fileno())
                    self.synced += 1
            except BaseException:
                self._repair(start)
                raise
            self.appended += 1
            self.seq += 1
            self.write_s += time.perf_counter() - t0
            return rec["seq"]

    def _write_frame(self, frame: bytes) -> None:
        # the disk sites damage the frame FIRST, then raise: the repair
        # path (and, for a simulated kill, the reader-side truncation)
        # must clean up exactly what a failing disk leaves behind
        try:
            fault_point("disk.torn_write", self._owner)
        except InjectedFault:
            self._f.write(frame[:max(1, len(frame) // 2)])
            self._f.flush()
            raise
        try:
            fault_point("disk.bitflip", self._owner)
        except InjectedFault:
            bad = bytearray(frame)
            bad[-1] ^= 0x40
            self._f.write(bytes(bad))
            self._f.flush()
            raise
        self._f.write(frame)
        self._f.flush()

    def _repair(self, start: int) -> None:
        try:
            self._f.truncate(start)
            self._f.flush()
            self.repairs += 1
        except OSError:                       # pragma: no cover - disk gone
            logger.warning("journal repair truncate failed", exc_info=True)

    def append_advisory(self, kind: str, payload: dict) -> bool:
        """Buffered advisory append that ABSORBS failures: watermark and
        layout records must never fail the serve path that carries them
        (the record re-emits on the next advance).  Returns whether the
        record landed."""
        try:
            self.append(kind, payload, sync=False)
            return True
        except Exception:
            self.dropped += 1
            logger.warning("advisory journal record %r dropped", kind,
                           exc_info=True)
            return False

    def flush(self, *, sync: bool = True) -> None:
        with self._lock:
            self._f.flush()
            if sync:
                os.fsync(self._f.fileno())
                self.synced += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()

    # -- read plane --------------------------------------------------------
    def records(self) -> tuple[list[JournalRecord], Optional[int]]:
        """The valid record prefix + the offset of the first bad/torn
        frame (None when the whole file reads clean)."""
        with self._lock:
            self._f.flush()
        return read_records(self.path)

    def recover(self) -> list[JournalRecord]:
        """Read the valid prefix and TRUNCATE the file at the first
        bad/torn record — what restore() calls before replaying, and what
        makes a reopened journal safely appendable after a kill."""
        recs, bad = self.records()
        if bad is not None:
            with self._lock:
                self._f.truncate(bad)
                self._f.flush()
                os.fsync(self._f.fileno())
                self.repairs += 1
                self.seq = recs[-1].seq + 1 if recs else 0
            logger.warning("journal %s truncated at byte %d "
                           "(%d records keep)", self.path, bad, len(recs))
        return recs


def read_records(path: str) -> tuple[list[JournalRecord], Optional[int]]:
    """Scan a journal file: (valid prefix, first-bad-offset|None).  Any
    framing violation — wrong magic, short header, short payload (torn
    write), crc mismatch (bit flip), undecodable payload — stops the scan
    at that record's start; everything before it is intact by checksum."""
    out: list[JournalRecord] = []
    if not os.path.exists(path):
        return out, None
    with open(path, "rb") as f:
        blob = f.read()
    off = 0
    n = len(blob)
    while off < n:
        if (off + _FRAME_MIN > n
                or blob[off:off + len(MAGIC)] != MAGIC):
            return out, off
        length, crc = _HEADER.unpack_from(blob, off + len(MAGIC))
        body_at = off + _FRAME_MIN
        end = body_at + length
        if end > n:
            return out, off                     # torn tail
        data = blob[body_at:end]
        if zlib.crc32(data) != crc:
            return out, off                     # flipped bit
        try:
            rec = pickle.loads(data)
            kind, seq = rec.pop("kind"), rec.pop("seq")
        except Exception:
            return out, off
        out.append(JournalRecord(kind=str(kind), seq=int(seq),
                                 payload=rec, offset=off, end=end))
        off = end
    return out, None


# -- store attachment ------------------------------------------------------

def attach_journal(store, journal: Optional[Journal]) -> None:
    """Attach (None: detach) the active journal to a store — the pattern
    ``_fault_plan``/``_hot_set_policy`` use, so the mutation paths in
    ``core.partition``/``core.checkout``/``serve.checkout`` find it
    without new plumbing.  ``StoreDurability`` owns rotation: a fresh
    journal per snapshot generation."""
    store._journal = journal
    if journal is not None:
        journal._owner = store


def get_journal(store) -> Optional[Journal]:
    return getattr(store, "_journal", None)


def journal_regroup(mgr) -> None:
    """Advisory record of a ``SuperblockGroups.regroup()`` RESULT.  The
    trigger (heat drift) is not replayable — heat EWMAs are not journaled
    per wave — so the journal captures the plan the regroup produced and
    replay installs it directly."""
    j = get_journal(mgr.store)
    if j is None:
        return
    j.append_advisory("regroup", {
        "budget": int(mgr.budget),
        "block_n": None if mgr.block_n is None else int(mgr.block_n),
        "block_d": None if mgr.block_d is None else int(mgr.block_d),
        "planned": [[int(q) for q in key] for key in mgr.planned],
        "stragglers": sorted(int(q) for q in mgr.straggler_pids)})


# -- replay ----------------------------------------------------------------

def replay_into(store, records: list[JournalRecord]) -> dict:
    """Apply a journal's record prefix to a freshly restored store.

    Idempotent by construction: ``commit`` records apply iff their vid is
    still unborn, ``migration.commit``/``repartition`` iff the store has
    not reached the record's post-epoch — so replaying a chain of
    generation journals over a newer snapshot (the parent-chain fallback
    path) skips everything the snapshot already contains.  Intent records
    without a matching commit are the crashed-mid-migration signature and
    are (correctly) ignored.  The restored store must NOT have a journal
    attached yet — replayed mutations re-journaling themselves would
    duplicate every record.

    Returns ``{"applied", "skipped", "ticket_watermarks"}``."""
    from .checkout import get_superblock_groups
    from .partition import plan_migration
    if get_journal(store) is not None:
        raise RuntimeError("replay into a store with an attached journal "
                           "would re-journal every replayed mutation")
    fault_point("journal.replay", store)
    applied = skipped = 0
    marks: dict[str, int] = {}
    for rec in records:
        kind, p = rec.kind, rec.payload
        if kind == "commit":
            if store.graph.n_versions > int(p["vid"]):
                skipped += 1
                continue
            new_rows = None if p["new_rows"] is None else _dec(p["new_rows"])
            store.commit_version(_dec(p["rlist"]),
                                 parent=p["parent"], new_rows=new_rows,
                                 pid=int(p["pid"]))
            applied += 1
        elif kind == "commit.batch":
            # group commit: ONE record covers a whole commit_many wave.
            # All-or-nothing by construction — the wave's K commits either
            # all sit inside this (checksummed) record or the record never
            # made it to disk; replay re-applies them through commit_many
            # itself, which swaps in-memory state only after staging the
            # entire wave.
            if store.graph.n_versions > int(p["vid0"]):
                skipped += 1
                continue
            store.commit_many([
                {"rlist": _dec(c["rlist"]),
                 "new_rows": (None if c["new_rows"] is None
                              else _dec(c["new_rows"])),
                 "parent": c["parent"],
                 "pid": int(c["pid"])}
                for c in p["commits"]])
            applied += 1
        elif kind in ("migration.commit", "repartition"):
            if int(getattr(store, "epoch", 0)) >= int(p["epoch_after"]):
                skipped += 1
                continue
            assignment = _dec(p["assignment"])
            if kind == "repartition":
                store.repartition(assignment)
            else:
                store.apply_migration(plan_migration(store, assignment))
            applied += 1
        elif kind == "regroup":
            mgr = get_superblock_groups(store)
            if mgr is None or int(mgr.budget) != int(p["budget"]):
                skipped += 1
                continue
            mgr.evict_all()
            mgr.planned = [tuple(int(q) for q in key)
                           for key in p["planned"]]
            mgr.pid_to_group = {}
            for key in mgr.planned:
                for q in key:
                    mgr.pid_to_group[q] = key
            mgr.straggler_pids = set(int(q) for q in p["stragglers"])
            mgr._plan_epoch = int(getattr(store, "epoch", 0))
            applied += 1
        elif kind == "ticket":
            key = str(p["tenant"])
            marks[key] = max(marks.get(key, 0), int(p["watermark"]))
            applied += 1
        elif kind == "migration.intent":
            skipped += 1            # bracketing marker: commit never landed
        else:                       # unknown kind from a newer writer
            skipped += 1
            logger.warning("skipping unknown journal record kind %r", kind)
    return {"applied": applied, "skipped": skipped,
            "ticket_watermarks": marks}


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename/create inside it survives a crash —
    the half of tmp+rename durability ``os.replace`` alone does not give.
    Best-effort on platforms without directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                            # pragma: no cover - windows
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
