"""The weight carry: a reference parameter tree into the port's model.

``from_reference(cfg, tree)`` takes the JAX package's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, init_params(cfg, key))``, which a
test makes; this module imports no jax) and returns the port's ``Model``
with the same weights.  The reference stacks every layer's parameters on a
leading axis (its ``vmap``/``scan``); the port's modules are one per layer,
so ``layers/ssd/in_proj/w`` of shape (L, d_in, d_out) becomes
``layers.<i>.ssd.in_proj.w`` for i < L.  Every leaf must land on a
parameter and every parameter must be filled, or it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import resolve_device
from .transformer import ArchConfig, Model


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def state_dict_from_reference(tree) -> dict:
    """The port's parameter names -> float32 host tensors."""
    out = {}
    for path, arr in _leaves(tree):
        if path[0] == "layers":
            for i in range(arr.shape[0]):
                out[".".join((path[0], str(i)) + path[1:])] = \
                    torch.from_numpy(np.array(arr[i], np.float32))
        else:
            out[".".join(path)] = torch.from_numpy(np.array(arr, np.float32))
    return out


def from_reference(cfg: ArchConfig, tree, device=None) -> Model:
    """The port's model on ``device`` (the card unless the caller names the
    CPU) holding the reference tree's weights."""
    model = Model(cfg, None, resolve_device(device))
    model.load_state_dict(state_dict_from_reference(tree), strict=True)
    return model
