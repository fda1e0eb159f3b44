"""Seeded weights, made on the device in float32: one generator and one
call a leaf of the reference's schema (a stacked leaf holds every layer),
so that any leaf can be made again alone from the seed."""
from __future__ import annotations

import torch

from .harness import reference


def _generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + k) % (1 << 63))


def schema(c: dict) -> dict:
    """Leaf name -> (shape, init, scale), as the configuration's reference
    lays its weights out."""
    return reference(c).schema(c)


def make_leaf(c: dict, seed: int, name: str, device) -> torch.Tensor:
    names = list(schema(c))
    shape, init, scale = schema(c)[name]
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    g = _generator(seed, names.index(name), device)
    return torch.randn(shape, generator=g, device=device).mul_(scale)


def make(c: dict, seed: int, device) -> dict:
    """Every leaf by name: the same tensors from the same seed."""
    return {name: make_leaf(c, seed, name, device) for name in schema(c)}


def nested(flat: dict) -> dict:
    """The leaves as the nested tree the program's weight carry takes
    (``layers/ssd/in_proj/w`` -> tree["layers"]["ssd"]["in_proj"]["w"])."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, last = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def layer_leaves(flat: dict) -> dict:
    """One tensor a layer: a stacked leaf ``layers/attn/wq/w`` becomes
    ``layers.<i>.attn.wq.w``, the program's parameter names."""
    out = {}
    for name, t in flat.items():
        parts = name.split("/")
        if parts[0] == "layers":
            for i in range(t.shape[0]):
                out[".".join([parts[0], str(i)] + parts[1:])] = t[i]
        else:
            out[".".join(parts)] = t
    return out
