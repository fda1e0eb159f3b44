"""Fault tolerance & elasticity for the trainer: the port of
``repro.train.ft``.

* restart-from-CVD — the train driver checkpoints into a CheckpointStore (a
  CVD); ``resume_latest`` restores the parameters and the data-pipeline
  cursor, so a preempted job replays *nothing* and re-reads only its current
  batch.  The optimizer state starts fresh, as in the reference.
* straggler mitigation — ``StragglerPolicy`` tracks per-host step latencies
  (EWMA) and, past a deadline factor, drops the slowest hosts' data shards
  for the step (the versioned store makes the dropped shard reproducible —
  it is re-enqueued, not lost).
* ``HeartbeatMonitor`` detects dead hosts for restart decisions.
* elastic_reshard — checkpoints are whole leaves and the layout lives in
  specs, so a restore onto a different mesh shape (2 pods -> 1 pod after a
  pod loss) is ``restore`` with the new mesh; no format change.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np

from .checkpoint import CheckpointStore


# ------------------------------------------------------------- restart ----
def resume_latest(store: CheckpointStore, device=None, mesh=None,
                  specs=None, treedef_like=None
                  ) -> tuple[Optional[int], Any, dict]:
    """Latest committed checkpoint version (by step), restored; (vid, tree,
    meta).  Returns (None, None, {}) on a fresh run.  The leaves are host
    numpy with ``device=None``, tensors on ``device`` otherwise, and
    DTensors with ``mesh`` and ``specs`` (the reference's ``:31``)."""
    if not store.manifest["versions"]:
        return None, None, {}
    vid, info = max(store.manifest["versions"].items(),
                    key=lambda kv: kv[1]["step"])
    tree = store.restore(int(vid), device=device, mesh=mesh, specs=specs,
                         treedef_like=treedef_like)
    return int(vid), tree, info["meta"]


# ------------------------------------------------------------ elastic ----
def elastic_reshard(store: CheckpointStore, vid: int, new_mesh, specs,
                    treedef_like=None) -> Any:
    """Restore checkpoint ``vid`` onto a DIFFERENT mesh (the reference's
    ``:45``): any mesh whose axis names exist works, (data, model) meshes
    of any shape included (names absent from the new mesh are dropped, so
    that dim replicates)."""
    return store.restore(vid, mesh=new_mesh, specs=specs,
                         treedef_like=treedef_like)


# ---------------------------------------------------------- stragglers ----
@dataclasses.dataclass
class StragglerPolicy:
    """EWMA per-host latency tracking with a drop decision per step.

    deadline_factor: a host is a straggler for the step if its EWMA exceeds
    deadline_factor × the median EWMA.  max_drop_frac bounds how much of the
    batch may be skipped (the dropped hosts' shards are re-enqueued)."""
    n_hosts: int
    deadline_factor: float = 2.0
    max_drop_frac: float = 0.125
    alpha: float = 0.3

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self._seen = np.zeros(self.n_hosts, dtype=bool)

    def observe(self, host: int, latency_s: float) -> None:
        if not self._seen[host]:
            self.ewma[host] = latency_s
            self._seen[host] = True
        else:
            self.ewma[host] = (1 - self.alpha) * self.ewma[host] \
                + self.alpha * latency_s

    def active_hosts(self) -> np.ndarray:
        """Hosts allowed to contribute this step (stragglers dropped,
        bounded by max_drop_frac, never dropping below 1 host)."""
        if not self._seen.any():
            return np.arange(self.n_hosts)
        med = np.median(self.ewma[self._seen])
        slow = np.flatnonzero(self._seen & (self.ewma > self.deadline_factor
                                            * max(med, 1e-9)))
        max_drop = int(self.max_drop_frac * self.n_hosts)
        if len(slow) > max_drop:   # drop only the worst offenders
            slow = slow[np.argsort(-self.ewma[slow])[:max_drop]]
        mask = np.ones(self.n_hosts, dtype=bool)
        mask[slow] = False
        if not mask.any():
            mask[int(np.argmin(self.ewma))] = True
        return np.flatnonzero(mask)


@dataclasses.dataclass
class HeartbeatMonitor:
    """Detects dead hosts (missed heartbeats) for restart decisions."""
    n_hosts: int
    timeout_s: float = 60.0

    def __post_init__(self):
        now = time.monotonic()
        self.last = np.full(self.n_hosts, now)

    def beat(self, host: int, t: Optional[float] = None) -> None:
        self.last[host] = time.monotonic() if t is None else t

    def dead_hosts(self, now: Optional[float] = None) -> np.ndarray:
        now = time.monotonic() if now is None else now
        return np.flatnonzero(now - self.last > self.timeout_s)

    def healthy(self, now: Optional[float] = None) -> bool:
        return len(self.dead_hosts(now)) == 0
