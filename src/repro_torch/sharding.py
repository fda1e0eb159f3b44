"""Mesh context + sharding helpers: the port of ``repro.sharding`` over
``torch.distributed``'s ``DeviceMesh`` and DTensor.

Axis roles (as the reference's):
  pod    — data parallelism across pods (multi-pod mesh only)
  data   — data parallelism + FSDP parameter sharding within a pod
  model  — tensor / expert / sequence parallelism (size 1 in this port:
           ``launch.mesh.make_mesh`` refuses more, ROADMAP A.11f-2)

A spec is a tuple whose entries are ``None``, an axis name, or a tuple of
names, one entry a tensor dim: the counterpart of ``PartitionSpec``.
``logical_to_sharding`` maps it onto a mesh as DTensor placements (each
mesh dim named in the spec shards that tensor dim; names the mesh lacks
are dropped), and ``distribute`` lays a tree or a model out by it, each
rank keeping its own shard.

The models never see a DTensor: the train step (``train.train_step``)
gathers whole weights for the forward, which runs on a rank's own rows as
plain tensors, so the models never read the context either.  ``shard`` is
the identity without a context or on a plain tensor, and redistributes a
DTensor.  The reference's ``compat_shard_map`` papers over jax versions'
``shard_map`` signatures; it has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional

import torch

from .kernels.build import PlanError


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh, its batch axes ``dp`` and its model axis ``tp`` (the
    reference's ``:46-60``)."""
    mesh: Any
    dp: tuple = ("data",)     # batch axes; ("pod", "data") multi-pod
    tp: str = "model"

    def size(self, axis: str) -> int:
        names = self.mesh.mesh_dim_names
        return self.mesh.shape[names.index(axis)] if axis in names else 1

    @property
    def dp_size(self) -> int:
        return math.prod(self.size(a) for a in self.dp)

    @property
    def tp_size(self) -> int:
        return self.size(self.tp)

    @property
    def dp_rank(self) -> int:
        """This rank's index along the batch axes."""
        return self.rank_along(self.dp)

    def rank_along(self, axes) -> int:
        """This rank's index along ``axes``, the first axis major (the order
        in which ``P(("pod", "data"))`` splits the batch)."""
        r = 0
        for a in axes:
            if a in self.mesh.mesh_dim_names:
                r = r * self.size(a) + self.mesh.get_local_rank(a)
        return r

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)


_state = threading.local()


def current_ctx() -> Optional[MeshContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def mesh_context(ctx: Optional[MeshContext]):
    prev = current_ctx()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def make_ctx(mesh) -> MeshContext:
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return MeshContext(mesh=mesh, dp=dp or ("data",), tp="model")


def _fix(spec: tuple, names) -> tuple:
    """``spec`` with the axis names that ``names`` lacks dropped."""
    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None
    return tuple(fix(e) for e in spec)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``spec`` with
    the names the mesh lacks dropped, and its DTensor ``placements``, one a
    mesh dim."""
    mesh: Any
    spec: tuple
    placements: tuple


def sharding(spec: tuple, mesh) -> Sharding:
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    spec = _fix(spec, names)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if list(axes) != sorted(axes, key=names.index):
            raise PlanError(f"spec {spec}: the axes {axes} of one dim must "
                            f"follow the mesh's order {names}")
        for a in axes:
            placements[names.index(a)] = Shard(dim)
    return Sharding(mesh, spec, tuple(placements))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and namedtuples are
    its nodes; anything else, a plain tuple such as a spec included, is a
    leaf), with the same structure of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and hasattr(tree, "_fields")):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else items
    return fn(tree, *rest)


def logical_to_sharding(tree_specs, mesh):
    """A tree of specs -> the same tree of ``Sharding``s on ``mesh``
    (the reference's ``:135``)."""
    return tree_map(lambda s: sharding(s, mesh), tree_specs)


def distribute(tree, specs, mesh):
    """``tree`` laid out on ``mesh`` by ``specs`` (the reference's
    ``jax.device_put(tree, logical_to_sharding(specs, mesh))``): every rank
    holds the whole leaf on the mesh's device and keeps its own shard, with
    no communication.  A ``torch.nn.Module`` has its parameters replaced in
    place (``specs`` by parameter name; each keeps ``requires_grad``) and
    is returned; any other tree comes back as the same tree of DTensors."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        return distribute_tensor(
            x.detach().to(mesh.device_type), mesh,
            sharding(spec, mesh).placements, src_data_rank=None)

    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner)
            mod._parameters[leaf] = torch.nn.Parameter(
                one(p, specs[name]), requires_grad=p.requires_grad)
        return tree
    return tree_map(one, tree, specs)


def local(x):
    """A rank's own part of ``x``: a DTensor's local shard (sharing its
    storage), a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def whole(x):
    """``x`` whole on every rank: a DTensor gathered (a copy only where it
    is sharded over a dim of more than one rank), a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if tuple(x.to_local().shape) == tuple(x.shape):
        return x.to_local()
    return x.full_tensor()


def shard(x, spec: tuple):
    """Lay ``x`` out by ``spec`` on the active mesh: the identity without a
    context or on a plain tensor (a rank's own rows), a redistribution of a
    DTensor.  Axis names the mesh lacks are dropped."""
    from torch.distributed.tensor import DTensor
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, sharding(spec, ctx.mesh).placements)


def dp_spec(*rest) -> tuple:
    """A spec over the batch dim using the active context's dp axes."""
    ctx = current_ctx()
    dp = ctx.dp if ctx else ("data",)
    return (dp, *rest)


def residual_spec(x) -> tuple:
    """Sharding for the (B, S, D) residual stream between blocks: the
    sequence over the model axis where S divides it (the reference's
    Megatron-style sequence parallelism), else replicated over it."""
    ctx = current_ctx()
    dp = ctx.dp if ctx else ("data",)
    s = x.shape[1] if x.ndim >= 3 else 0
    if ctx is not None and s > 1 and s % ctx.tp_size == 0:
        return (dp, "model", None)
    return (dp, None, None)
