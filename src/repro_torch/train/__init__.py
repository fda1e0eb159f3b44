"""Training on PyTorch: AdamW and its schedule, the microbatched train step,
the checkpoint CVD (checkpoints are a version of a split-by-rlist store)
and fault tolerance (resume, stragglers, heartbeats)."""
from . import ft
from .checkpoint import CheckpointStore
from .ft import HeartbeatMonitor, StragglerPolicy, resume_latest
from .optimizer import AdamW, AdamWState, cosine_schedule
from .train_step import (accumulate_grads, ef_init, make_eval_step,
                         make_train_step, quantize_int8)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "accumulate_grads",
           "ef_init", "make_eval_step", "make_train_step", "quantize_int8",
           "CheckpointStore", "HeartbeatMonitor", "StragglerPolicy",
           "resume_latest", "ft"]
