"""Sharding on one device: the port's counterpart of ``repro.sharding``.

The port runs on one NVIDIA H100, so there is nothing to shard: ``shard``
returns its input and ``current_ctx()`` is always ``None``, so attention
always takes the single-device core (the reference's sequence-sharded
attention is training on many chips and is not ported).  A
``MeshContext`` is still made and passed where the reference passes one,
so the serving API reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """One device: data- and model-parallel degree 1."""
    mesh: object = None
    tp_size: int = 1


def make_ctx(mesh=None) -> MeshContext:
    return MeshContext(mesh=mesh)


def current_ctx() -> Optional[MeshContext]:
    """No mesh is ever active on one device."""
    return None


def shard(x, spec=None):
    """The identity: one device holds every tensor whole."""
    return x
