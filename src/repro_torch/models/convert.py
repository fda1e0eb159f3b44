"""The weight carry: a reference parameter tree into the port's model, and
back (``to_reference``, the tree the trainer checkpoints).

``from_reference(cfg, tree)`` takes the JAX package's parameter tree as
numpy arrays (``jax.tree.map(np.asarray, init_params(cfg, key))``, which a
test makes; this module imports no jax) and returns the port's ``Model``
with the same weights.  The reference stacks every layer's parameters on a
leading axis (its ``vmap``/``scan``); the port's modules are one per layer,
so ``layers/ssd/in_proj/w`` of shape (L, d_in, d_out) becomes
``layers.<i>.ssd.in_proj.w`` for i < L, and an MoE stack's
``dense_layers`` and an encoder-decoder's ``enc_layers`` split the same way
(an expert leaf ``layers/moe/wi`` of shape (L, E, d, f) becomes
``layers.<i>.moe.wi`` of shape (E, d, f); a decoder block's cross-attention
``layers/xattn/wq/w`` becomes ``layers.<i>.xattn.wq.w``).
Every leaf must land on a parameter and every parameter must be filled,
or it raises.  ``to_reference`` stacks the layers back: the JAX package's
nested dict of the model's parameters (or of any tensors under the same
names, such as gradients or an optimizer moment), so both packages'
``CheckpointStore.save`` write the same manifest layout for the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import resolve_device
from .transformer import ArchConfig, Model

# the reference's stacked trees: a leading layer axis on every leaf
STACKED = ("layers", "dense_layers", "enc_layers")


def reference_path(name: str) -> str:
    """The reference's path of the leaf a port parameter is (a row of):
    ``layers.3.attn.wq.w`` -> ``layers/attn/wq/w``."""
    parts = name.split(".")
    if parts[0] in STACKED:
        parts = [parts[0]] + parts[2:]
    return "/".join(parts)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _float32(arr) -> torch.Tensor:
    """A float32 tensor of ``arr``: a tensor stays on its device, anything
    else becomes a host tensor of its own."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float32)
    return torch.from_numpy(np.array(arr, np.float32))


def state_dict_from_reference(tree) -> dict:
    """The port's parameter names -> float32 tensors (host tensors from a
    numpy tree, a tensor tree's rows on its own device)."""
    out = {}
    for path, arr in _leaves(tree):
        if path[0] in STACKED:
            for i in range(arr.shape[0]):
                out[".".join((path[0], str(i)) + path[1:])] = _float32(arr[i])
        else:
            out[".".join(path)] = _float32(arr)
    return out


def to_reference(model: Model, named: dict | None = None, *,
                 host: bool = True) -> dict:
    """The reference's nested parameter dict of ``model`` (or of ``named``,
    tensors under the model's parameter names): the layers stacked on a
    leading axis on the tensors' device, then numpy on the host (``host``)
    or left there as tensors."""
    named = (dict(model.named_parameters()) if named is None else named)
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        t = t.detach()
        if parts[0] in STACKED:
            stacks.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = t
        else:
            _put(tree, parts, t)
    for path, rows in stacks.items():
        _put(tree, list(path), torch.stack([rows[i]
                                            for i in range(len(rows))]))
    if host:
        tree = _map(tree, lambda t: t.cpu().numpy())
    return tree


def reference_specs(specs: dict) -> dict:
    """``transformer.param_specs``'s specs (by the port's parameter name)
    as the reference's nested tree: a stacked leaf's spec gains the layer
    axis's leading ``None``.  The specs of a ``to_reference`` checkpoint,
    and what the reference's ``param_specs`` gives."""
    tree: dict = {}
    for name, spec in specs.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            path, spec = [parts[0], *parts[2:]], (None, *spec)
            have = _get(tree, path)
            if have is not None and have != spec:
                raise ValueError(f"{name}: spec {spec} differs from the "
                                 f"stack's {have}")
        else:
            path = parts
        _put(tree, path, spec)
    return tree


def _get(tree: dict, path: list):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def reference_like(model: Model) -> dict:
    """``to_reference``'s structure with ``meta`` tensors for leaves (shape
    and dtype, no storage): the ``treedef_like`` of a checkpoint restore."""
    return to_reference(model, {n: torch.empty(p.shape, dtype=p.dtype,
                                                device="meta")
                                for n, p in model.named_parameters()},
                        host=False)


def load_reference(model: Model, tree) -> Model:
    """``model`` with the reference tree's weights copied in (numpy, or
    tensors on any device); every parameter must be filled, or it
    raises."""
    with torch.no_grad():
        model.load_state_dict(state_dict_from_reference(tree), strict=True)
    return model


def _put(tree: dict, path: list, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_reference(cfg: ArchConfig, tree, device=None) -> Model:
    """The port's model on ``device`` (the card unless the caller names the
    CPU) holding the reference tree's weights."""
    return load_reference(Model(cfg, None, resolve_device(device)), tree)
