"""VersionedDataset — the bolt-on point between a CVD and a training run.

Training data lives in a CVD; a training run *checks out* a dataset version
and streams deterministic, shard-aware batches from it.  The engine sees
only (tokens, labels) and knows nothing of versions.  Each run records the
exact dataset vid it consumed (provenance), and a preempted run resumes
mid-epoch from (vid, cursor) with zero replay.

``checkout`` materializes one version on the store's device: the
partition's host block is uploaded on every call (as the JAX package does)
and one ``gather_row_tiles`` launch (``use_tiled=True``, the default; the
rlist is run-dense after LyreSplit) or one ``gather_rows`` launch gathers
it.  ``checkout_many`` runs through the store's cross-partition wave engine:
ONE ``checkout_wave`` launch over the device-resident superblock.
``batches`` is host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.graph import BipartiteGraph
from ..core.partition import PartitionedCVD
from ..kernels import ops as K


@dataclasses.dataclass
class VersionedDataset:
    """records = fixed-width token rows: (n_records, row_len) int32."""
    store: PartitionedCVD
    seq_len: int
    pad_id: int = 0

    @classmethod
    def from_graph(cls, graph: BipartiteGraph, data: np.ndarray,
                   assignment: np.ndarray, seq_len: int, *,
                   device=None) -> "VersionedDataset":
        """A dataset over a new store on ``device`` (None = the card;
        ``"cpu"`` runs the kernels' plain torch versions)."""
        return cls(store=PartitionedCVD(graph, data, assignment,
                                        device=device), seq_len=seq_len)

    # -- checkout (device path) ---------------------------------------------
    def checkout(self, vid: int, use_tiled: bool = True) -> np.ndarray:
        """Materialize version ``vid`` via the gather kernel: its rows in
        sorted local-rid order, as host numpy."""
        p = self.store.partitions[self.store.vid_to_pid[vid]]
        rl = np.sort(np.asarray(p.local_rlist(vid)))
        dev = self.store.device
        if use_tiled:
            packed, perm, _ = K.checkout_gather_tiled(p.block, rl, device=dev)
            return packed.cpu().numpy()[perm]
        return K.checkout_gather(p.block, rl, device=dev).cpu().numpy()

    def checkout_many(self, vids, *, use_kernel: bool = True,
                      engine: str = "wave") -> list[np.ndarray]:
        """Materialize a wave of versions via the fused batched engine — by
        default ONE ``checkout_wave`` launch for the whole wave over the
        store's epoch-cached superblock, however many partitions it spans."""
        return self.store.checkout_many(vids, use_kernel=use_kernel,
                                        engine=engine)

    # -- batching -------------------------------------------------------------
    def batches(self, vid: int, global_batch: int, seed: int = 0,
                start_step: int = 0, n_steps: Optional[int] = None,
                drop_hosts: Optional[np.ndarray] = None,
                n_hosts: int = 1) -> Iterator[dict]:
        """Deterministic shuffled batches of (tokens, labels).

        Rows are chunked/padded to seq_len+1; tokens = row[:-1],
        labels = row[1:].  ``start_step`` makes restart replay-free; a host's
        shard can be dropped for a step (straggler policy) and re-enqueued —
        determinism comes from (vid, seed, step), the paper's checkout
        immutability.
        """
        rows = self.checkout(vid)
        flat = rows.reshape(-1)
        chunk = self.seq_len + 1
        n_seqs = len(flat) // chunk
        seqs = flat[:n_seqs * chunk].reshape(n_seqs, chunk).astype(np.int32)
        rng = np.random.default_rng(seed)
        order = rng.permutation(n_seqs)
        steps_per_epoch = max(n_seqs // global_batch, 1)
        step = start_step
        emitted = 0
        requeue: list[np.ndarray] = []
        while n_steps is None or emitted < n_steps:
            epoch = step // steps_per_epoch
            i = step % steps_per_epoch
            if i == 0 and step > 0:
                order = np.random.default_rng(seed + epoch).permutation(n_seqs)
            idx = order[i * global_batch:(i + 1) * global_batch]
            if len(idx) < global_batch:   # wrap the tail
                idx = np.concatenate([idx, order[:global_batch - len(idx)]])
            if drop_hosts is not None and n_hosts > 1:
                per = global_batch // n_hosts
                keep = np.ones(global_batch, bool)
                for h in drop_hosts:
                    keep[h * per:(h + 1) * per] = False
                requeue.append(idx[~keep])
                # backfill from requeued shards (re-enqueue semantics)
                fill = np.concatenate(requeue)[:int((~keep).sum())] \
                    if requeue else idx[~keep]
                idx = np.concatenate([idx[keep], fill])[:global_batch]
            batch = seqs[idx]
            yield {"tokens": batch[:, :-1], "labels": batch[:, 1:],
                   "step": step, "vid": vid}
            step += 1
            emitted += 1

    # -- provenance -----------------------------------------------------------
    def provenance(self, vid: int) -> dict:
        return {"vid": int(vid),
                "partition": int(self.store.vid_to_pid[vid]),
                "n_records": int(len(self.store.graph.rlist(vid))),
                "checkout_cost": int(self.store.checkout_cost(vid))}
