"""Checkpointing — checkpoints ARE a CVD (the paper's bolt-on applied to the
trainer's own state).

Every save commits a new version to a checkpoint CVD whose records are
parameter SHARDS (flattened fp32 blocks, one record per (leaf, shard) pair).
The split-by-rlist property gives us for free exactly what the paper promises
for datasets:
  * dedup across checkpoints — frozen leaves (embeddings during staged
    training, EMA snapshots, restored-then-re-saved params) are stored once;
  * lineage — the checkpoint version graph is the training-run DAG (restarts
    branch, mixtures merge);
  * cheap restore-any-step — checkout(vid).

A leaf is a numpy array or a torch tensor on any device; ``save`` brings it
to host numpy.  ``restore`` returns host numpy, tensors on the device it is
given, or DTensors laid out on a mesh by specs (``sharding``'s tuples),
each rank keeping its own shard of each leaf: any mesh whose axis names
the specs use, so a checkpoint saved on one mesh restores onto another
(``ft.elastic_reshard``), across the batch axes and "model" alike.  A
tree of DTensors saves whole: every rank of their mesh calls ``save``,
the leaves (sharded over "data", "model" or both) are gathered, rank 0
writes and the others reread the store, so the CVD's rows are a one-rank
save's byte for byte.  The tree is walked as the JAX package walks it (dict keys in
sorted order, ``[i]`` for list and tuple items, a namedtuple's field names,
``None`` an empty subtree), so both packages write the same manifest
``layout`` and the same CVD rows for the same tree.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..core.datamodels import SplitByRlist, _raw_keys
from ..core.journal import fsync_dir
from ..kernels.ops import resolve_device
from ..sharding import distribute, whole


def _walk(node, path: tuple, paths: list, leaves: list) -> None:
    if node is None:
        return                          # an empty subtree: no leaf
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], path + (str(key),), paths, leaves)
    elif isinstance(node, (list, tuple)):
        names = getattr(node, "_fields", None)   # a namedtuple
        for i, child in enumerate(node):
            _walk(child, path + (names[i] if names else f"[{i}]",),
                  paths, leaves)
    else:
        paths.append("/".join(path))
        leaves.append(node)


def _flatten_with_paths(tree):
    """(path strings, leaves, tree) in the JAX package's flatten order."""
    paths: list = []
    leaves: list = []
    _walk(tree, (), paths, leaves)
    return paths, leaves, tree


def _unflatten(like, leaves):
    """The structure of ``like`` with its leaves replaced, in flatten
    order, from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(child, leaves) for child in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return whole(leaf).detach().cpu().numpy()
    return np.asarray(leaf)


def _has_dtensor(leaves) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor) for leaf in leaves)


@dataclasses.dataclass
class CheckpointStore:
    """A CVD of checkpoints, plus a side manifest for shapes/dtypes/specs."""
    directory: str
    shard_rows: int = 1 << 14      # record = one 16k-float block of a leaf

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._manifest_path = os.path.join(self.directory, "manifest.json")
        self._cvd_path = os.path.join(self.directory, "cvd.pkl")
        if os.path.exists(self._cvd_path):
            try:
                with open(self._cvd_path, "rb") as f:
                    self.cvd: SplitByRlist = pickle.load(f)
                with open(self._manifest_path) as f:
                    self.manifest = json.load(f)
            except Exception as e:
                raise ValueError(
                    f"corrupt checkpoint store in {self.directory!r}: "
                    f"{e} — the manifest/CVD pair is unreadable; recover "
                    "from a replica or remove the directory") from e
            if not isinstance(self.manifest, dict) \
                    or "versions" not in self.manifest:
                raise ValueError(
                    f"corrupt checkpoint manifest in {self.directory!r}: "
                    "missing the versions table")
        else:
            # records: (shard_rows,) fp32 blocks => n_attrs = shard_rows
            self.cvd = SplitByRlist(n_attrs=self.shard_rows)
            self.manifest = {"versions": {}}

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree: Any, parent_vid: Optional[int] = None,
             meta: Optional[dict] = None, bitexact: bool = False) -> int:
        """Commit the pytree as a new checkpoint version.

        ``bitexact=False`` (default, the param-tree path) casts every leaf
        to fp32 before sharding — fine for training state, LOSSY for wide
        integers.  ``bitexact=True`` shards each leaf's raw bytes instead
        (uint8 view, zero-padded to int32 words): any dtype round-trips
        exactly — what ``core.durability`` needs for int64 rid arrays —
        at the cost of dedup granularity staying byte-block-level."""
        paths, leaves, _ = _flatten_with_paths(tree)
        if _has_dtensor(leaves):
            return self._save_sharded(step, leaves, parent_vid, meta,
                                      bitexact, tree)
        rows = []
        layout = []
        for path, leaf in zip(paths, leaves):
            leaf = _to_host(leaf)
            entry = {"path": path, "shape": list(np.shape(leaf)),
                     "dtype": str(leaf.dtype)}
            if bitexact:
                raw = np.ascontiguousarray(leaf).view(np.uint8).ravel()
                nbytes = len(raw)
                n_words = -(-max(nbytes, 1) // 4)
                padded8 = np.zeros(n_words * 4, np.uint8)
                padded8[:nbytes] = raw
                arr = padded8.view(np.int32)
                entry["nbytes"] = nbytes
                entry["encoding"] = "raw"
                entry["crc32"] = zlib.crc32(raw.tobytes())
            else:
                arr = leaf.astype(np.float32).ravel()
                entry["crc32"] = zlib.crc32(arr.tobytes())
            n_blocks = max(1, -(-len(arr) // self.shard_rows))
            padded = np.zeros(n_blocks * self.shard_rows, arr.dtype)
            padded[:len(arr)] = arr
            blocks = padded.reshape(n_blocks, self.shard_rows)
            rows.append(blocks)
            entry["n_blocks"] = n_blocks
            layout.append(entry)
        table = np.concatenate(rows, axis=0)
        # CVD records are int32 rows; reinterpret the payload bitwise
        table_i32 = table if table.dtype == np.int32 else table.view(np.int32)
        parents = () if parent_vid is None else (parent_vid,)
        vid = self.cvd.commit(table_i32, parents=parents, t=float(step))
        entry = {"step": step, "layout": layout, "meta": meta or {}}
        # checkout() returns rows in sorted-RID order, which differs from
        # commit row order whenever rows partially dedup against a parent
        # (kept rows reuse old/small rids, new rows append large ones) —
        # restoring by layout offsets would scramble the leaves.  Record
        # the permutation back to commit order when they diverge.
        co = self.cvd.checkout(vid)
        if not np.array_equal(co, table_i32):
            ck, tk = _raw_keys(co), _raw_keys(table_i32)
            order = np.argsort(ck, kind="stable")
            pos = np.searchsorted(ck[order], tk)
            entry["row_perm"] = order[pos].tolist()
        self.manifest["versions"][str(vid)] = entry
        self._persist()
        return vid

    def _save_sharded(self, step, leaves, parent_vid, meta, bitexact,
                      tree) -> int:
        """``save`` of a tree holding DTensors: every rank gathers each
        leaf, rank 0 writes, and the other ranks reread the store once it
        has; all return the new vid."""
        import torch.distributed as dist
        host = [_to_host(leaf) for leaf in leaves]     # collective gathers
        rank = dist.get_rank()
        box = [None]
        if rank == 0:
            box[0] = self.save(step, _unflatten(tree, iter(host)),
                               parent_vid=parent_vid, meta=meta,
                               bitexact=bitexact)
        dist.broadcast_object_list(box, src=0)
        if rank != 0:
            self.__post_init__()                       # rank 0's files
        return box[0]

    # -- restore ------------------------------------------------------------------
    def restore(self, vid: int, *, device=None, mesh=None, specs: Any = None,
                treedef_like: Any = None) -> Any:
        """Rebuild the tree: the leaves in flatten order, or the structure
        of ``treedef_like`` holding them.  Leaves are host numpy with
        ``device=None``, and tensors on ``device`` otherwise; with ``mesh``
        and ``specs`` (a tree of specs of the restored tree's structure)
        they are DTensors on ``mesh`` laid out by ``specs`` (the
        reference's ``:133-170``), each rank keeping its own shard."""
        info = self.manifest["versions"][str(vid)]
        table_i32 = self.cvd.checkout(vid)
        if "row_perm" in info:
            table_i32 = table_i32[np.asarray(info["row_perm"], np.int64)]
        table_f32 = table_i32.view(np.float32)
        leaves = []
        off = 0
        for entry in info["layout"]:
            if entry.get("encoding") == "raw":
                raw = np.ascontiguousarray(
                    table_i32[off:off + entry["n_blocks"]]
                ).view(np.uint8).ravel()[:entry["nbytes"]]
                arr = np.frombuffer(
                    raw.tobytes(), dtype=entry["dtype"]
                ).reshape(entry["shape"])
            else:
                n = int(np.prod(entry["shape"])) if entry["shape"] else 1
                blocks = table_f32[off:off + entry["n_blocks"]]
                flat = blocks.ravel()[:n]
                arr = flat.reshape(entry["shape"]).astype(entry["dtype"])
            leaves.append(arr)
            off += entry["n_blocks"]
        if mesh is not None and specs is not None:
            tree = (_unflatten(treedef_like, iter(leaves))
                    if treedef_like is not None else leaves)
            return distribute(tree, specs, mesh)
        if device is not None:
            dev = resolve_device(device)
            leaves = [torch.from_numpy(np.array(a)).to(dev) for a in leaves]
        if treedef_like is not None:
            return _unflatten(treedef_like, iter(leaves))
        return leaves

    def verify(self, vid: int) -> list[str]:
        """Recompute every leaf's digest for ``vid`` against the per-leaf
        ``crc32`` the manifest recorded at save time; returns the paths
        that FAIL (empty = verified).  A flipped bit anywhere in a
        version's stored rows — base data chunks, a scrambled row
        permutation, a corrupt rlist — changes some leaf's decoded bytes
        and trips its digest.  Leaves saved by a pre-digest writer carry
        no crc and are skipped (nothing to verify against); a version
        whose rows cannot be decoded at all fails wholesale."""
        try:
            info = self.manifest["versions"][str(vid)]
            table_i32 = self.cvd.checkout(vid)
            if "row_perm" in info:
                table_i32 = table_i32[np.asarray(info["row_perm"],
                                                 np.int64)]
            table_f32 = table_i32.view(np.float32)
        except Exception:
            return [f"<version {vid}>"]
        bad: list[str] = []
        off = 0
        for entry in info["layout"]:
            want = entry.get("crc32")
            blocks = table_i32[off:off + entry["n_blocks"]]
            off += entry["n_blocks"]
            if want is None:
                continue
            try:
                if entry.get("encoding") == "raw":
                    got = zlib.crc32(np.ascontiguousarray(blocks).view(
                        np.uint8).ravel()[:entry["nbytes"]].tobytes())
                else:
                    n = (int(np.prod(entry["shape"]))
                         if entry["shape"] else 1)
                    flat = table_f32[
                        off - entry["n_blocks"]:off].ravel()[:n]
                    got = zlib.crc32(np.ascontiguousarray(flat).tobytes())
            except Exception:
                got = None
            if got != int(want):
                bad.append(entry["path"])
        return bad

    def compact(self, keep_vids: list[int]) -> dict:
        """Rebuild the CVD retaining ONLY ``keep_vids``, re-chained in the
        given order: the first kept version re-anchors as a parentless
        full commit, each later one parents on its predecessor — so
        content dedup between retained generations survives the drop of
        everything older.  Versions not listed (including non-checkpoint
        versions a caller committed into the same CVD) are gone for good.
        Persists atomically and returns ``{old_vid: new_vid}``."""
        keep = [int(v) for v in keep_vids]
        for v in keep:
            if str(v) not in self.manifest["versions"]:
                raise ValueError(f"vid {v} not in this checkpoint store")
        new_cvd = SplitByRlist(n_attrs=self.shard_rows)
        new_manifest: dict = {"versions": {}}
        mapping: dict = {}
        prev_new: Optional[int] = None
        for v in keep:
            info = self.manifest["versions"][str(v)]
            table = self.cvd.checkout(v)
            if "row_perm" in info:
                table = table[np.asarray(info["row_perm"], np.int64)]
            parents = () if prev_new is None else (prev_new,)
            nv = new_cvd.commit(table, parents=parents,
                                t=float(info.get("step", 0)))
            entry = {k: val for k, val in info.items() if k != "row_perm"}
            co = new_cvd.checkout(nv)
            if not np.array_equal(co, table):
                ck, tk = _raw_keys(co), _raw_keys(table)
                order = np.argsort(ck, kind="stable")
                pos = np.searchsorted(ck[order], tk)
                entry["row_perm"] = order[pos].tolist()
            new_manifest["versions"][str(nv)] = entry
            mapping[v] = nv
            prev_new = nv
        self.cvd = new_cvd
        self.manifest = new_manifest
        self._persist()
        return mapping

    def lineage(self, vid: int) -> list[int]:
        return self.cvd.vgraph.ancestors(vid)

    def dedup_ratio(self) -> float:
        """Stored cells / naive (sum over versions) — the paper's storage win."""
        naive = sum(len(self.cvd.rlist(v)) * self.shard_rows
                    for v in range(self.cvd.vgraph.n_versions))
        return self.cvd.storage_cells() / max(naive, 1)

    def _persist(self):
        # atomic (tmp + rename): a process killed mid-write must leave the
        # previous checkpoint generation readable — core.durability's
        # restore() contract depends on it
        for path, write in ((self._cvd_path,
                             lambda f: pickle.dump(self.cvd, f)),
                            (self._manifest_path,
                             lambda f: f.write(
                                 json.dumps(self.manifest).encode()))):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                write(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        # fsync the DIRECTORY too: os.replace made the rename atomic, but
        # the new directory entry itself is not durable until the dir
        # inode is flushed — a crash right after rename could resurface
        # the old file or none at all
        fsync_dir(self.directory)
