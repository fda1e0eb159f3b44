"""Mesh context + sharding helpers: the port of ``repro.sharding`` over
``torch.distributed``'s ``DeviceMesh`` and DTensor.

Axis roles (as the reference's):
  pod    — data parallelism across pods (multi-pod mesh only)
  data   — data parallelism + FSDP parameter sharding within a pod
  model  — tensor and expert parallelism, the vocabulary (the embedding's
           rows, the LM head's columns, the logits), the residual
           stream's sequence between blocks, the sequence-sharded
           attention where the kv heads do not split over it, SSD heads,
           and the serving cache's sequence
           (``models.transformer.cache_specs``)

A spec is a tuple whose entries are ``None``, an axis name, or a tuple of
names, one entry a tensor dim: the counterpart of ``PartitionSpec``.
``logical_to_sharding`` maps it onto a mesh as DTensor placements (each
mesh dim named in the spec shards that tensor dim; names the mesh lacks
are dropped), and ``distribute`` lays a tree or a model out by it, each
rank keeping its own shard.

The models never see a DTensor: the train, eval and serve steps gather
each weight over the batch axes into a plain tensor, each rank keeping
its working shard over "model", and run the forward on a rank's own
rows.  The layers read ``current_ctx()`` for the model group, as the
reference's ``moe_ffn`` and ``_sdpa`` read theirs, and cross it with the
collectives below, each a ``torch.autograd.Function`` over plain
``torch.distributed`` calls on that group (a group of one rank still runs
them):

  copy_to_tp      identity forward, all-reduce backward (before a
                  column-parallel product on a replicated input: the
                  input's gradient is the sum of every rank's columns'
                  part);
  reduce_from_tp  all-reduce forward, identity backward (after a
                  row-parallel product into a replicated residual, and the
                  vocabulary-parallel embedding's partial rows);
  all_gather_seq  the residual's sequence rows all-gathered forward, the
                  ranks' partial gradients reduce-scattered back to each
                  rank's rows backward (a block's entry: the
                  sequence-sharded residual into a column-parallel
                  product, or the sequence path's K and V);
  reduce_scatter_seq
                  the partial sums reduce-scattered into each rank's
                  sequence rows forward, the rows' gradients all-gathered
                  backward (a block's exit after a row-parallel product,
                  and the embedding's partial rows into the residual);
  norm_sum        all-reduce forward and backward (the SSD norm's sum of
                  squares over a rank's heads: each rank uses the sum for
                  its own features, so each holds a part of its gradient);
  split_seq       this rank's slice of a dim forward, all-gather backward;
  gather_seq      all-gather of a dim forward, this rank's slice backward;
  gather_weight   a weight's "model" shard cast to the compute dtype and
                  all-gathered whole forward (an attention whose heads
                  do not split, at each use); backward the gradient in
                  float32, reduce-scattered to the shard where each rank's
                  rows give a partial sum, else this rank's slice of the
                  whole gradient every rank computes;
  expert_exchange the MoE ``all_to_all`` (split E, concat C) forward, the
                  reverse exchange backward, and ``expert_return`` the
                  other way round;
  decode_max, decode_sum
                  the sequence-parallel decode's merge (an all-reduce
                  MAX of the logits' row maxima, an all-reduce SUM of the
                  softmax sums and of the P·V partials); serving only, so
                  their backward refuses;
  vocab_log_likelihood
                  the cross-entropy over the vocabulary's shards: an
                  all-reduce MAX of the logits' row maxima (``vocab_max``)
                  and one all-reduce SUM of the exp sums and the labels'
                  shifted logits (``vocab_sum``) forward; the backward
                  (softmax minus the one-hot on the rank's own columns)
                  runs no collective.

The residual's layout rides on the context: ``residual_layout(True)``
marks the stream between blocks as this rank's S/m sequence rows (the
reference's ``residual_spec``; ``residual_rows()`` reads it, and remat's
recompute, which re-enters the forward's context, sees it too), and a
layer that reads the residual gathers it (``all_gather_seq``) and hands its
output back as rows (``reduce_scatter_seq``).  Outside it the residual is
whole on every model rank.

``TP_CALLS`` counts the collectives these issue, by function (``copy_to_tp``
counts its backward's all-reduces, ``split_seq`` its backward's
all-gathers, ``norm_sum``, ``all_gather_seq`` and ``reduce_scatter_seq``
both, ``gather_weight`` its forward's all-gathers and a partial
gradient's reduce-scatters), once for each forward and each backward; a forward rerun inside the backward (remat's recompute, which
``torch.utils.checkpoint`` stops once the tensors the backward needs are
rebuilt, at a point that differs between torch builds and devices) counts
in ``TP_RECOMPUTE`` instead.  ``zero_tp_calls`` resets both.  ``shard`` is
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
import torch.distributed as dist

from . import trace
from .kernels.build import PlanError


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh, its batch axes ``dp`` and its model axis ``tp`` (the
    reference's ``:46-60``)."""
    mesh: Any
    dp: tuple = ("data",)     # batch axes; ("pod", "data") multi-pod
    tp: str = "model"
    residual_rows: bool = False   # the residual is this rank's sequence rows

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


def residual_rows() -> bool:
    """Whether the residual stream under the active context is this rank's
    S/m sequence rows (``residual_layout``)."""
    return bool(getattr(current_ctx(), "residual_rows", False))


@contextlib.contextmanager
def residual_layout(rows: bool):
    """The active context with the residual stream laid out as this rank's
    sequence rows (``rows``) or whole on every model rank; nothing changes
    without a context."""
    ctx = current_ctx()
    if ctx is None or residual_rows() == rows:
        yield ctx
        return
    with mesh_context(dataclasses.replace(ctx, residual_rows=rows)) as inner:
        yield inner


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


# ------------------------------------------ collectives over "model" --
TP_CALLS = {"copy_to_tp": 0, "reduce_from_tp": 0, "split_seq": 0,
            "gather_seq": 0, "all_to_all": 0, "all_gather_seq": 0,
            "reduce_scatter_seq": 0, "norm_sum": 0, "decode_max": 0,
            "decode_sum": 0, "vocab_max": 0, "vocab_sum": 0,
            "gather_weight": 0}
TP_RECOMPUTE = dict(TP_CALLS)


def zero_tp_calls() -> None:
    for k in TP_CALLS:
        TP_CALLS[k] = TP_RECOMPUTE[k] = 0


def _count(kind: str, forward: bool) -> None:
    """One collective of ``kind``; a forward's inside a running backward
    (a graph task) is a recompute."""
    rerun = forward and torch._C._current_graph_task_id() != -1
    (TP_RECOMPUTE if rerun else TP_CALLS)[kind] += 1


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The model axis as the layers use it: the process group of this
    rank's line along it, its size and this rank's index on it."""
    group: Any
    size: int
    rank: int


def tp_group(ctx: Optional[MeshContext] = None) -> Optional[TPGroup]:
    """The active context's model axis, or None without a context."""
    ctx = ctx if ctx is not None else current_ctx()
    if ctx is None:
        return None
    if ctx.tp not in ctx.mesh.mesh_dim_names:
        raise PlanError(f"mesh {tuple(ctx.mesh.mesh_dim_names)} has no "
                        f"{ctx.tp!r} axis")
    return TPGroup(ctx.group(ctx.tp), ctx.tp_size,
                   ctx.mesh.get_local_rank(ctx.tp))


def _all_gather(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    n = x.shape[dim]
    if n % tp.size:
        raise PlanError(f"dim {dim} of {tuple(x.shape)} does not split over "
                        f"{tp.size} model ranks")
    return x.narrow(dim, tp.rank * (n // tp.size), n // tp.size)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count("copy_to_tp", False)
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        y = x.contiguous().clone()
        _count("reduce_from_tp", True)
        dist.all_reduce(y, group=tp.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _NormSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        y = x.contiguous().clone()
        _count("norm_sum", True)
        dist.all_reduce(y, group=tp.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count("norm_sum", False)
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _DecodeMerge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, kind):
        y = x.contiguous().clone()
        _count(kind, True)
        op = dist.ReduceOp.MAX if kind == "decode_max" else dist.ReduceOp.SUM
        dist.all_reduce(y, op=op, group=tp.group)
        return y

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the sequence-parallel decode's merge serves; "
                           "it is not differentiated")


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _slice(x, dim, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        _count("split_seq", False)
        return _all_gather(g, ctx.dim, ctx.tp), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        _count("gather_seq", True)
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.tp).contiguous(), None, None


def _reduce_scatter(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    """The sum over the model group of ``x``, this rank's 1/m slice of
    ``dim`` (the r-th contiguous part) of it: each rank's slices exchanged
    (``all_to_all``, the bytes a ring reduce-scatter moves) and added here
    in rank order, so that the sum rounds the same way on every backend
    and topology (the reference's, on faked host devices, adds in that
    order).  The count names it the reduce-scatter it is."""
    from .launch.op_count import collective_as
    m, n = tp.size, x.shape[dim]
    if n % m:
        raise PlanError(f"dim {dim} of {tuple(x.shape)} does not split over "
                        f"{m} model ranks")
    send = x.movedim(dim, 0).contiguous()
    recv = torch.empty_like(send)
    with collective_as("reduce-scatter", recv.nbytes // m):
        dist.all_to_all_single(recv, send, group=tp.group)
    parts = recv.chunk(m)
    out = parts[0] + parts[1] if m > 1 else parts[0].clone()
    for part in parts[2:]:
        out.add_(part)
    return out.movedim(0, dim)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        _count("all_gather_seq", True)
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        _count("all_gather_seq", False)
        return _reduce_scatter(g, ctx.dim, ctx.tp), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        _count("reduce_scatter_seq", True)
        return _reduce_scatter(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        _count("reduce_scatter_seq", False)
        return _all_gather(g.contiguous(), ctx.dim, ctx.tp), None, None


WEIGHT_CAST = "model.weight_cast_bytes"


def cast_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 parameter (or this rank's shard of one) in ``dtype`` for
    one use; a cast's bytes read are added to the trace's
    ``model.weight_cast_bytes`` counter."""
    if w.dtype == dtype:
        return w
    trace.count(WEIGHT_CAST, w.nbytes)
    return w.to(dtype)


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, dtype, tp, partial):
        ctx.dim, ctx.tp, ctx.partial = dim, tp, partial
        _count("gather_weight", True)
        return _all_gather(cast_weight(w, dtype), dim, tp)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            _count("gather_weight", False)
            g = _reduce_scatter(g.float(), ctx.dim, ctx.tp)
        else:
            g = _slice(g, ctx.dim, ctx.tp).float()
        return g.contiguous(), None, None, None, None


class _VocabLogLikelihood(torch.autograd.Function):
    """Each position's log-softmax at its label, float32, from this rank's
    columns of the logits (B, S, V/m), the r-th contiguous part of the
    padded vocabulary; the rank's softmax, exp(x - max) / Σ exp(x - max)
    over every rank's columns, kept in float32 for the backward."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        n = logits.shape[-1]
        ids = labels.long() - tp.rank * n
        own = (ids >= 0) & (ids < n)
        ids = ids.clamp(0, n - 1)[..., None]
        p = logits.to(torch.float32, copy=True)
        top = p.amax(dim=-1, keepdim=True)
        _count("vocab_max", True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=tp.group)
        p.sub_(top)                                 # shifted, in place
        label = torch.where(own, p.gather(-1, ids)[..., 0], 0.0)
        p.exp_()
        both = torch.stack([p.sum(dim=-1), label], dim=-1)
        _count("vocab_sum", True)
        dist.all_reduce(both, group=tp.group)
        total = both[..., :1]
        ctx.save_for_backward(p.div_(total), ids, own)  # the rank's softmax
        ctx.dtype = logits.dtype
        return both[..., 1] - torch.log(total[..., 0])

    @staticmethod
    def backward(ctx, g):
        p, ids, own = ctx.saved_tensors
        d = p * -g[..., None]
        d.scatter_add_(-1, ids, (g * own)[..., None])
        return d.to(ctx.dtype), None, None


def _exchange(x: torch.Tensor, tp: TPGroup, back: bool,
              forward: bool) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` pair on (E, C, d) buffers:
    forward (split E, concat C) (E, C, d) -> (E/m, m·C, d); ``back`` (split
    C, concat E) (E/m, m·C, d) -> (E, C, d)."""
    m = tp.size
    if back:
        e_loc, mc, d = x.shape
        send = x.reshape(e_loc, m, mc // m, d).transpose(0, 1).contiguous()
    else:
        send = x.contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all", forward)
    dist.all_to_all_single(recv, send, group=tp.group)
    if back:
        return recv.reshape(m * e_loc, mc // m, d)
    e, c, d = x.shape
    return recv.reshape(m, e // m, c, d).transpose(0, 1).reshape(
        e // m, m * c, d)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, back):
        ctx.tp, ctx.back = tp, back
        return _exchange(x, tp, back, True)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.tp, not ctx.back, False), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model group."""
    return _CopyToTP.apply(x, tp)


def norm_sum(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """All-reduce (sum) over the model group forward and backward: a sum
    every rank then uses for its own part of a tensor (the SSD norm's sum
    of squares over its heads' features), so that the gradient of each
    rank's addend is the sum of every rank's use."""
    return _NormSum.apply(x, tp)


def decode_max(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """All-reduce MAX over the model group (the decode merge's row
    maxima); serving only."""
    return _DecodeMerge.apply(x, tp, "decode_max")


def decode_sum(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """All-reduce SUM over the model group (the decode merge's softmax
    sums and P·V partials); serving only."""
    return _DecodeMerge.apply(x, tp, "decode_sum")


def reduce_from_tp(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """All-reduce (sum) over the model group forward; identity backward."""
    return _ReduceFromTP.apply(x, tp)


def split_seq(x: torch.Tensor, tp: TPGroup, dim: int = 1) -> torch.Tensor:
    """This rank's 1/m slice of ``dim`` forward (rank r takes the r-th
    contiguous part); the slices' gradients all-gathered backward."""
    return _SplitSeq.apply(x, dim, tp)


def gather_seq(x: torch.Tensor, tp: TPGroup, dim: int = 1) -> torch.Tensor:
    """The ranks' slices all-gathered along ``dim`` in rank order forward;
    this rank's slice of the gradient backward (every rank holds the same
    whole gradient, so nothing is summed)."""
    return _GatherSeq.apply(x, dim, tp)


def all_gather_seq(x: torch.Tensor, tp: TPGroup, dim: int = 1
                   ) -> torch.Tensor:
    """The ranks' sequence rows all-gathered along ``dim`` in rank order
    forward; the ranks' partial gradients of the whole summed and each
    rank's rows of the sum returned backward (a reduce-scatter: every rank
    uses the whole sequence for its own columns or heads)."""
    return _AllGatherSeq.apply(x, dim, tp)


def reduce_scatter_seq(x: torch.Tensor, tp: TPGroup, dim: int = 1
                       ) -> torch.Tensor:
    """The ranks' partial sums of the whole sequence summed and each rank's
    1/m rows of ``dim`` kept forward (a reduce-scatter); the rows'
    gradients all-gathered backward."""
    return _ReduceScatterSeq.apply(x, dim, tp)


def gather_weight(w: torch.Tensor, dim: int, dtype: torch.dtype,
                  tp: TPGroup, partial: bool) -> torch.Tensor:
    """This rank's shard ``w`` of a weight (the r-th contiguous part of
    ``dim``) cast to ``dtype`` and gathered whole over the model group in
    rank order, so the gather moves the compute dtype's bytes.  Backward,
    the whole gradient in float32: with ``partial`` (each rank's sequence
    rows give a partial sum) summed over the ranks in rank order and this
    rank's part kept (a reduce-scatter, ``_reduce_scatter``), else (every
    rank computes the same whole gradient) this rank's part sliced."""
    return _GatherWeight.apply(w, dim, dtype, tp, partial)


def vocab_log_likelihood(logits: torch.Tensor, labels: torch.Tensor,
                         tp: TPGroup) -> torch.Tensor:
    """log_softmax(logits)[label] in float32 a position, (B, S), from this
    rank's vocabulary columns ``logits`` (B, S, V/m; rank r holds columns
    [r·V/m, (r+1)·V/m) of the padded vocabulary): the maximum and the
    exp sum over every rank's columns, the label's logit from the rank
    that holds it.  No rank holds a whole row of the logits."""
    return _VocabLogLikelihood.apply(logits, labels, tp)


def expert_exchange(buf: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """(E, C, d) -> (E/m, m·C, d): each rank's slots for rank j's experts
    to rank j, concatenated in rank order (``all_to_all(split_axis=0,
    concat_axis=1, tiled=True)``)."""
    return _Exchange.apply(buf, tp, False)


def expert_return(out: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """(E/m, m·C, d) -> (E, C, d): the reverse of ``expert_exchange``."""
    return _Exchange.apply(out, tp, True)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward; the gradient times ``scale`` backward."""
    return _ScaleGrad.apply(x, scale)
