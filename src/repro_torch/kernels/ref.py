"""Plain oracles for the checkout kernels: the tests hold the kernels and
the wave engine against these."""
from __future__ import annotations

import numpy as np
import torch


def gather_rows_ref(data: torch.Tensor, rids: torch.Tensor) -> torch.Tensor:
    return data[rids.long()]


def gather_batched_ref(data, rlists):
    """NumPy oracle for checkout_batched: per-version gather loop."""
    data = data.cpu().numpy() if isinstance(data, torch.Tensor) \
        else np.asarray(data)
    return [data[np.asarray(rl, dtype=np.int64)] for rl in rlists]
