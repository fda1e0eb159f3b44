"""Training-side state on PyTorch: the checkpoint CVD (checkpoints are a
version of a split-by-rlist store).  The optimizer, the train step and
fault tolerance are not ported yet."""
from .checkpoint import CheckpointStore

__all__ = ["CheckpointStore"]
