"""Training on PyTorch: AdamW and its schedule, the microbatched train step
(one device, or data-parallel and FSDP across the ranks of a mesh, with the
cross-pod int8 gradient exchange), the checkpoint CVD (checkpoints are a
version of a split-by-rlist store) and fault tolerance (resume, elastic
restore onto another mesh, stragglers, heartbeats)."""
from . import ft
from .checkpoint import CheckpointStore
from .ft import (HeartbeatMonitor, StragglerPolicy, elastic_reshard,
                 resume_latest)
from .optimizer import AdamW, AdamWState, cosine_schedule
from .train_step import (accumulate_grads, ef_init, ef_specs,
                         make_eval_step, make_train_step, quantize_int8)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "accumulate_grads",
           "ef_init", "ef_specs", "make_eval_step", "make_train_step",
           "quantize_int8",
           "CheckpointStore", "HeartbeatMonitor", "StragglerPolicy",
           "elastic_reshard", "resume_latest", "ft"]
