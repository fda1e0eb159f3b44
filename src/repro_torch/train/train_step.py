"""Training step: microbatched gradient accumulation + AdamW, with optional
int8 error-feedback gradient compression on the cross-pod reduction: the
port of ``repro.train.train_step``.

The engine is versioning-UNAWARE: batches arrive as plain (tokens, labels),
numpy or tensors; the paper's machinery lives entirely in ``repro_torch.data``.
The step runs eagerly (there is nothing to jit) on the device that holds
the parameters, which must require gradients (``init_params(...,
trainable=True)``).

Without a mesh context (``ctx=None``) the step runs on one device.  With
one (``sharding.MeshContext`` over ``launch.mesh``'s ``DeviceMesh``) every
rank of the mesh calls the step with the same global batch and takes its
own rows, as the reference shards the batch over ("pod", "data"):

* the plain step: each rank runs the forward and backward on its rows of
  each microbatch (every model rank of a (pod, data) line takes that
  line's rows, as the reference shards the batch over the batch axes
  only), and the gradients and the loss are averaged over the batch axes
  (summed for ``vlm``, whose loss the reference divides by one row's
  count); the grad norm is the global one, each leaf counted once across
  the ranks that hold its shards;
* FSDP and tensor/expert parallelism: parameters laid out by
  ``sharding.distribute(model, param_specs(cfg), mesh)`` hold 1/dp of
  every leaf that the specs shard over "data" and 1/tp of every leaf they
  shard over "model" on each rank, and so do the AdamW moments and the
  error-feedback residuals.  Each step gathers the weights over the batch
  axes once (``cast_and_gather_params``; the reference's ``_drop_fsdp``;
  the FSDP2 alternative, ``fully_shard``, is not used) into a model of
  plain tensors, each rank keeping its "model" shard as the layers want it
  (``working_specs``: the vocabulary's rows or columns among them, and
  the storage shards of an attention's weights where its kv heads do not
  split, which its layers gather whole only at each use), and
  the forward runs under ``mesh_context(ctx)``, so the attention, SwiGLU,
  latent-attention, expert and SSD layers run tensor-, expert- and
  sequence-parallel over "model" (``models.layers``, ``models.mla``,
  ``models.moe``, ``models.ssd``) at every model-axis size, 1 included,
  and above 1 the embedding, the LM head and the loss run over the
  vocabulary's shards and the residual stream is the rank's sequence rows
  (``models.transformer``), while the flash, SSD and RMS-norm Functions and the
  kernels see plain local tensors, never DTensors.  Each working shard's
  gradient is whole for that shard (the layers' collectives sum what the
  model ranks share, such as the router's and the SSD's B/C columns');
  it is all-reduced over the batch axes and laid back out as the
  parameter's shard for AdamW (an SSD leaf's regrouped columns through
  the whole gradient, ``_ungroup``);
* ``grad_compress=True`` on a mesh with a "pod" axis: the reference's
  compressed step (``:140-184``).  Gradients are averaged within the pod
  at full precision; then per leaf ``target = g + e``, ``q, scale =
  quantize_int8(target)`` (each pod its own scale, over the whole
  reference leaf: a stacked leaf's scale spans its layers, as the
  reference's leaf holds them all),
  an int32 SUM of ``q`` and a MAX of the scale over "pod", ``ĝ = s · sc /
  npods`` and ``e ← target − q · scale`` (the pod's own residual row); the
  loss is averaged over pods.  On TP shards the formula is the same: the
  scale's max runs over the leaf's shards on "data" and "model", and the
  residuals are laid out by ``ef_specs``.  Without a "pod" axis
  ``grad_compress`` gives the plain step, as the reference's does.

Collectives run on the mesh's groups (NCCL on the card, gloo on the CPU);
a group of one rank still runs them.
"""
from __future__ import annotations

import copy
import functools
import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .. import trace
from ..kernels.build import PlanError
from ..models.convert import reference_path
from ..models.layers import heads_split
from ..models.ssd import head_columns
from ..models.transformer import (FRONTEND_INPUTS, ArchConfig, Model,
                                  loss_fn, param_specs)
from ..sharding import (MeshContext, local, mesh_context, sharding,
                        tree_map, whole)
from .optimizer import AdamW, AdamWState


def _to_device(batch: dict, device: torch.device) -> dict:
    """The model's inputs on ``device``: tokens, labels and a stub
    frontend's embeddings where the batch has them (a data pipeline's
    batch also carries its step and version, which stay behind)."""
    return {k: torch.as_tensor(batch[k]).to(device)
            for k in ("tokens", "labels", *FRONTEND_INPUTS) if k in batch}


def _trainable(params: Model) -> dict:
    named = dict(params.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"{len(frozen)} parameters do not require "
                         f"gradients (first {frozen[0]!r}); make the model "
                         "with init_params(..., trainable=True)")
    return named


def accumulate_grads(params: Model, batch: dict, cfg: ArchConfig):
    """(mean loss, grads by parameter name) over ``cfg.microbatches``
    sequential microbatches (the batch's rows split in order), the
    gradients summed in float32 and scaled by 1/n, as the reference's scan
    does.  The sum is the parameters' ``.grad`` while the microbatches
    run: each leaf's gradient is added in place as the backward makes it,
    so no microbatch's whole gradient set is held beside the sum (the same
    additions in the same order as a separate float32 sum); the
    parameters' own ``.grad`` is put back after."""
    named = _trainable(params)
    batch = _to_device(batch, params.embed.device)
    n = max(cfg.microbatches, 1)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    held = {k: p.grad for k, p in named.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=params.embed.device)
    try:
        for p in named.values():
            p.grad = None
        for i in range(n):
            rows = slice(i * (b // n), (i + 1) * (b // n))
            with trace.span("train.forward"):
                loss = loss_fn(params, {k: t[rows] for k, t in
                                        batch.items()}, cfg)
            with trace.span("train.backward"):
                torch.autograd.backward(loss, inputs=list(named.values()))
            lsum = lsum + loss.detach()
        inv = 1.0 / n
        return lsum * inv, {k: p.grad.mul_(inv) for k, p in named.items()}
    finally:
        for k, p in named.items():
            p.grad = held[k]


# ------------------------------------------------ int8 EF compression ------
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): x ≈ q · scale, |q| ≤ 127, half to even."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_init(params, npods: int, ctx: Optional[MeshContext] = None) -> dict:
    """Per-pod error-feedback residuals, stacked on a leading pod axis.
    With ``ctx`` (a mesh with ``npods`` on its "pod" axis) they are
    DTensors laid out by ``ef_specs``: each rank holds its pod's row, over
    "data" as the parameter's shard."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else dict(params))
    if ctx is None:
        return {n: torch.zeros((npods, *p.shape), dtype=torch.float32,
                               device=p.device) for n, p in named.items()}
    if ctx.size("pod") != npods:
        raise ValueError(f"{npods} pods on a mesh whose pod axis has "
                         f"{ctx.size('pod')}")
    from torch.distributed.tensor import zeros
    specs = ef_specs(_specs_of(named, ctx))
    return {n: zeros((npods, *p.shape), dtype=torch.float32,
                     device_mesh=ctx.mesh,
                     placements=sharding(specs[n], ctx.mesh).placements)
            for n, p in named.items()}


def ef_init_abstract(abstract_params, npods: int) -> dict:
    """``ef_init``'s leaves as ``meta`` tensors (the reference's
    ``:103``)."""
    named = (dict(abstract_params.named_parameters())
             if isinstance(abstract_params, torch.nn.Module)
             else dict(abstract_params))
    return {n: torch.empty((npods, *p.shape), dtype=torch.float32,
                           device="meta") for n, p in named.items()}


def ef_specs(param_specs):
    """The residuals' specs: the parameters' with "pod" on the leading axis
    (the reference's ``:109``)."""
    return tree_map(lambda s: ("pod", *s), param_specs)


def _drop_fsdp(spec: tuple) -> tuple:
    """``spec`` with its FSDP ("data") factor replaced by None (the
    reference's ``:29``)."""
    def fix(e):
        if e == "data":
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a != "data")
            return kept if kept else None
        return e
    return tuple(fix(e) for e in spec)


REGROUPED = "ssd_heads"      # a working leaf no spec describes


@functools.lru_cache(maxsize=None)
def working_specs(cfg: ArchConfig, m: int) -> dict:
    """The layout of each leaf in the forward's working copy on a model
    axis of ``m``, by parameter name: ``_drop_fsdp`` of its
    ``param_specs`` entry (gathered over "data", each rank keeping its
    "model" shard, as the reference's ``cast_and_gather_params``; the
    embedding's rows and the LM head's columns are the rank's V/m of the
    vocabulary, so its gradients return to the storage specs with no
    gather over "model"), but
      * latent attention's ``wkv_a`` whole and ``wkv_b``'s columns (its
        heads) over "model" (``models.mla``'s docstring), and where its
        heads do not divide ``m`` (above 1) its ``wq``/``wkv_b``/``wo``
        whole (no production config takes this: DeepSeek-V2-Lite's 16
        heads split the production axis of 16);
      * a GQA attention whose kv heads do not divide ``m`` keeps its
        ``wq``/``wk``/``wv`` columns and ``wo`` rows as the storage
        shards, like any other leaf, and each layer gathers a weight
        whole only at its use (``models.layers.at_use``), its gradient
        coming back as the shard; its q/k/v biases are whole;
      * an SSD layer's ``in_proj.w``, ``conv_w`` and ``conv_b``
        ``REGROUPED`` (each rank its heads' columns and the whole B and C,
        ``models.ssd.head_columns``), and its ``A_log``, ``D``,
        ``dt_bias`` and ``norm`` split by heads;
      * a column-parallel product's bias over "model" with its columns
        (the reference stores it replicated).
    Made once a config and axis (the step reads it every step); not to be
    changed."""
    specs = param_specs(cfg)
    mla = cfg.attn_type == "mla"
    split = heads_split(cfg.mla.n_heads if mla else cfg.n_kv, m)
    out = {}
    for name, spec in specs.items():
        parts = name.split(".")
        leaf = parts[-1]
        attn = ("attn" in parts or "xattn" in parts) and parts[-2] in (
            "wq", "wk", "wv", "wo", "wkv_b")
        if name.endswith(".wkv_a.w") or (attn and mla and not split):
            out[name] = (None,) * len(spec)
        elif name.endswith(".wkv_b.w"):
            out[name] = (None, "model")
        elif "ssd" in parts and leaf in ("w", "conv_w", "conv_b") and (
                parts[-2] == "in_proj" or leaf != "w"):
            out[name] = REGROUPED
        elif "ssd" in parts and leaf in ("A_log", "D", "dt_bias", "norm"):
            out[name] = ("model",)
        elif leaf == "b" and specs.get(name[:-1] + "w", ())[-1:] == ("model",):
            out[name] = ("model",) if split or not attn else (None,)
        else:
            out[name] = _drop_fsdp(spec)
    return out


def _regroup(whole: torch.Tensor, cfg: ArchConfig, ctx: MeshContext,
             name: str) -> torch.Tensor:
    """This rank's working columns of a ``REGROUPED`` leaf held whole."""
    m = ctx.tp_size
    if m == 1:                          # one rank's columns are the leaf's
        return whole
    cols = head_columns(cfg.ssd, m, ctx.mesh.get_local_rank(ctx.tp),
                        "in_proj" if name.endswith("in_proj.w") else "conv")
    return whole.index_select(-1, cols.to(whole.device))


def _ungroup(g: torch.Tensor, cfg: ArchConfig, ctx: MeshContext,
             name: str) -> torch.Tensor:
    """The whole gradient of a ``REGROUPED`` leaf from each rank's working
    columns' (all-gathered over "model"; the B and C columns, whose
    gradient ``copy_to_tp`` summed, are equal on every rank)."""
    m = ctx.tp_size
    if m == 1:
        return g
    parts = [torch.empty_like(g) for _ in range(m)]
    dist.all_gather(parts, g.contiguous(), group=ctx.group(ctx.tp))
    leaf = "in_proj" if name.endswith("in_proj.w") else "conv"
    n = cfg.ssd.d_in_proj if leaf == "in_proj" else cfg.ssd.conv_dim
    out = g.new_empty((*g.shape[:-1], n))
    for r, part in enumerate(parts):
        out[..., head_columns(cfg.ssd, m, r, leaf).to(g.device)] = part
    return out


def _shell(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s tree that shares no container with it: each
    module shallow-copied with its own parameter and child dicts, the
    parameters still ``module``'s until the caller replaces them.  No
    tensor is made (a whole skeleton on ``meta`` would be a whole model's
    storage to the count, ``launch.op_count``)."""
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._modules = {k: None if m is None else _shell(m)
                    for k, m in module._modules.items()}
    return out


def cast_and_gather_params(params: Model, cfg: ArchConfig,
                           ctx: MeshContext) -> Model:
    """The forward's working copy (the reference's ``:41``): ``params`` (a
    ``Model`` of ``cfg`` with DTensor parameters) gathered over the batch
    axes once a step, each leaf laid out by ``working_specs`` (each rank
    its "model" shard; whole on a model axis of 1), as a ``Model`` of plain
    tensors that require gradients.  A leaf already so laid out is its own
    storage, not a copy.  A GQA attention whose kv heads do not split
    keeps its weights' storage shards here, and its layers gather each
    whole, in the compute dtype, only at its use
    (``models.layers.at_use``).  The
    reference casts its working copy to bf16; the port's forward casts at
    each use, as its one-device step does, so the copy stays float32."""
    work = _shell(params)
    specs = working_specs(cfg, ctx.tp_size)
    for name, p in params.named_parameters():
        if _is_dtensor(p):
            if specs[name] == REGROUPED:
                p = _regroup(whole(p), cfg, ctx, name)
            else:
                want = sharding(specs[name], ctx.mesh).placements
                # a dim of one rank holds the whole leaf either way
                same = all(a == b or n == 1 for a, b, n in
                           zip(p.placements, want, ctx.mesh.shape))
                p = (p if same else p.redistribute(ctx.mesh, want)
                     ).to_local()
        owner, _, leaf = name.rpartition(".")
        work.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            p.detach(), requires_grad=True)
    return work


# ----------------------------------------------------------- train step ----
def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _working(params: Model, cfg: ArchConfig, ctx: MeshContext) -> Model:
    """The model the forward runs: its gathered working copy, or
    ``params`` itself when it holds plain tensors on a model axis of 1
    (whole leaves are then every rank's shards)."""
    if any(_is_dtensor(p) for p in params.parameters()):
        return cast_and_gather_params(params, cfg, ctx)
    if ctx.tp_size > 1:
        raise PlanError(f"a model axis of {ctx.tp_size} needs the parameters "
                        "laid out on the mesh (sharding.distribute(model, "
                        "param_specs(cfg), mesh)); these are plain tensors")
    return params


def _specs_of(named: dict, ctx: MeshContext) -> dict:
    """Each leaf's spec on ``ctx``'s mesh, read off its placements (a plain
    tensor is replicated)."""
    from torch.distributed.tensor import DTensor, Shard
    names = ctx.mesh.mesh_dim_names
    out = {}
    for n, p in named.items():
        spec = [None] * p.ndim
        if isinstance(p, DTensor):
            for axis, pl in zip(names, p.placements):
                if isinstance(pl, Shard):
                    have = spec[pl.dim]
                    spec[pl.dim] = axis if have is None else (
                        (have,) if isinstance(have, str) else have) + (axis,)
        out[n] = tuple(spec)
    return out


def _rank_rows(b: int, n: int, outer: tuple, inner: tuple) -> torch.Tensor:
    """The batch rows a rank takes: the batch split over the ``outer``
    (index, size) axes, each part into ``n`` microbatches, each microbatch
    over the ``inner`` (index, size) axes, contiguously; the rank's rows of
    its microbatches in order (so ``accumulate_grads`` splits them into
    the same microbatches)."""
    (oi, on), (ii, inn) = outer, inner
    if b % (on * n * inn):
        raise ValueError(f"batch {b} does not split over {on} x {inn} ranks "
                         f"and {n} microbatches")
    part = b // on
    mb = part // n
    chunk = mb // inn
    return torch.cat([torch.arange(oi * part + i * mb + ii * chunk,
                                   oi * part + i * mb + (ii + 1) * chunk)
                      for i in range(n)])


def _select(batch: dict, rows: torch.Tensor) -> dict:
    return {k: torch.as_tensor(batch[k])[rows]
            for k in ("tokens", "labels", *FRONTEND_INPUTS) if k in batch}


def _all_reduce(t: torch.Tensor, ctx: MeshContext, axes, op=None):
    """``t`` reduced in place over the mesh lines of ``axes``."""
    for a in axes:
        if a in ctx.mesh.mesh_dim_names:
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=ctx.group(a))
    return t


def _shard_of(g: torch.Tensor, p, spec, cfg: ArchConfig, ctx: MeshContext,
              name: str) -> torch.Tensor:
    """A rank's shard, laid out as ``p``, of the gradient ``g`` of its
    working shard (laid out by ``spec`` over "model", whole over the batch
    axes): a local slice, an all-to-all where both shard "model" (latent
    attention's ``wkv_b``), or for a ``REGROUPED`` leaf the whole gradient
    (``_ungroup``) sliced."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(p, DTensor):
        return g
    mesh = p.device_mesh
    if spec == REGROUPED:
        g = _ungroup(g, cfg, ctx, name)
        have = (Replicate(),) * mesh.ndim
    else:
        have = sharding(spec, mesh).placements
    if all(a == b or n == 1 for a, b, n in zip(have, p.placements,
                                                 mesh.shape)):
        return g
    return DTensor.from_local(g, mesh, have, run_check=False, shape=p.shape,
                              stride=p.stride()).redistribute(
        mesh, p.placements).to_local()


def _global_norm(shards: dict, specs: dict, ctx: MeshContext) -> torch.Tensor:
    """sqrt of the sum of squares of the whole leaves whose shards these
    are: each leaf's squares summed over the ranks that hold its other
    shards (its spec's axes), once."""
    groups: dict = {}
    for n, g in shards.items():
        axes = tuple(a for e in specs[n] if e is not None
                     for a in ((e,) if isinstance(e, str) else e))
        sq = torch.sum(torch.square(g.float()))
        groups[axes] = groups.get(axes, 0) + sq
    return torch.sqrt(sum(_all_reduce(sq, ctx, axes)
                          for axes, sq in groups.items()))


def _spanned_step(step):
    """``step`` with each call a ``train.step`` span, timed on the device
    too, its attribute ``step`` the call's index."""
    calls = itertools.count()

    @functools.wraps(step)
    def call(*args):
        with trace.span("train.step", device=True, step=next(calls)):
            return step(*args)
    return call


def make_train_step(cfg: ArchConfig, opt: Optional[AdamW] = None,
                    grad_compress: bool = False, *,
                    ctx: Optional[MeshContext] = None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, or with ``grad_compress`` on a mesh with a "pod" axis
    ``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
    metrics)``; metrics ``loss``, ``grad_norm`` (before clipping) and
    ``step`` as 0-d device tensors.  The parameters, the optimizer state
    and the residuals are updated in place.  ``ctx=None`` is the
    one-device step, where ``grad_compress`` has no cross-pod hop to
    compress and gives the same plain step.  Each call is a ``train.step``
    span (``trace``)."""
    opt = opt or AdamW()
    if ctx is None:
        def train_step(params: Model, opt_state: AdamWState, batch: dict):
            loss, grads = accumulate_grads(params, batch, cfg)
            with trace.span("train.optimizer"):
                params, new_state, gnorm = opt.update(grads, opt_state,
                                                      params)
            metrics = {"loss": loss.float(), "grad_norm": gnorm.float(),
                       "step": new_state.step}
            return params, new_state, metrics
        return _spanned_step(train_step)

    # vlm's loss is a sum over rows divided by one row's count
    mean = cfg.family != "vlm"
    n = max(cfg.microbatches, 1)
    compressed = grad_compress and "pod" in ctx.mesh.mesh_dim_names
    inner = tuple(a for a in ctx.dp if a != "pod") if compressed else ctx.dp
    inner_size = math.prod(ctx.size(a) for a in inner)
    npods = ctx.size("pod")

    # the compressed step splits the batch over the pods first, then each
    # pod's microbatches over its data ranks (the reference's shard_map
    # over "pod" around accumulate_grads); the plain step splits each
    # microbatch over all the batch axes
    outer = (ctx.rank_along(("pod",)), npods) if compressed else (0, 1)

    work_specs = working_specs(cfg, ctx.tp_size)

    def grads_on_rows(params, batch):
        named = _trainable(params)
        rows = _rank_rows(batch["tokens"].shape[0], n, outer,
                          (ctx.rank_along(inner), inner_size))
        with mesh_context(ctx):
            loss, grads = accumulate_grads(_working(params, cfg, ctx),
                                           _select(batch, rows), cfg)
        with trace.span("train.reduce"):
            loss = loss.float().clone()
            for g in (loss, *grads.values()):
                _all_reduce(g, ctx, inner)
                if mean:
                    g.div_(inner_size)
        return named, loss, grads

    def update(named, opt_state, shards, specs):
        with torch.no_grad():
            gnorm = _global_norm(shards, specs, ctx)
            local_state = AdamWState(
                step=opt_state.step,
                m={k: local(v) for k, v in opt_state.m.items()},
                v={k: local(v) for k, v in opt_state.v.items()})
            with trace.span("train.optimizer"):
                _, new_state, gnorm = opt.update(
                    shards, local_state,
                    {k: local(p) for k, p in named.items()}, gnorm=gnorm)
        return gnorm, AdamWState(step=new_state.step, m=opt_state.m,
                                 v=opt_state.v)

    if not compressed:
        def train_step_dp(params: Model, opt_state: AdamWState, batch: dict):
            named, loss, grads = grads_on_rows(params, batch)
            specs = _specs_of(named, ctx)
            shards = {k: _shard_of(grads.pop(k), p, work_specs[k], cfg,
                                   ctx, k) for k, p in named.items()}
            gnorm, state = update(named, opt_state, shards, specs)
            metrics = {"loss": loss, "grad_norm": gnorm.float(),
                       "step": state.step}
            return params, state, metrics
        return _spanned_step(train_step_dp)

    def train_step_c(params: Model, opt_state: AdamWState, ef: dict,
                     batch: dict):
        named, loss, grads = grads_on_rows(params, batch)
        specs = _specs_of(named, ctx)
        pod = ctx.rank_along(("pod",))
        # a scale per reference leaf: a stack's layers share theirs
        leaf = {k: reference_path(k) for k in named}
        slot = {path: i for i, path in enumerate(sorted(set(leaf.values())))}
        with torch.no_grad(), trace.span("train.compress"):
            _all_reduce(loss, ctx, ("pod",))
            loss.div_(npods)                              # pod mean
            grads = {k: _shard_of(grads.pop(k), p, work_specs[k], cfg,
                                  ctx, k) for k, p in named.items()}
            # the pod's row: a DTensor's shard holds only its own
            res = {k: local(e)[0] if _is_dtensor(e) else e[pod]
                   for k, e in ef.items()}
            amax = torch.zeros(len(slot), device=loss.device)
            for k, g in grads.items():
                if g.numel():
                    i = slot[leaf[k]]
                    amax[i] = torch.maximum(amax[i],
                                            (g.float() + res[k]).abs().max())
            _all_reduce(amax, ctx, inner + (ctx.tp,),
                        dist.ReduceOp.MAX)                # the pod's max
            scale = amax / 127.0 + 1e-12
            sc = _all_reduce(scale.clone(), ctx, ("pod",),
                             dist.ReduceOp.MAX)               # shared scale
            shards = {}
            for k in named:
                g, i = grads.pop(k), slot[leaf[k]]
                target = g.float() + res[k]
                q = torch.clamp(torch.round(target / scale[i]), -127,
                                127).to(torch.int8)
                s = _all_reduce(q.to(torch.int32), ctx, ("pod",))  # int8 wire
                shards[k] = (s.float() * sc[i] / npods).to(g.dtype)  # pod mean
                res[k].copy_(target - q.float() * scale[i])       # residual
                del g, target, q, s
        gnorm, state = update(named, opt_state, shards, specs)
        metrics = {"loss": loss, "grad_norm": gnorm.float(),
                   "step": state.step}
        return params, state, ef, metrics
    return _spanned_step(train_step_c)


def make_eval_step(cfg: ArchConfig, ctx: Optional[MeshContext] = None):
    """Returns ``eval_step(params, batch) -> loss`` (no gradients); with
    ``ctx`` each rank takes its rows (every model rank its (pod, data)
    line's), the forward runs tensor- and expert-parallel as the train
    step's, and the loss is averaged over the batch axes (the reference's
    ``:186``)."""
    @torch.no_grad()
    def eval_step(params: Model, batch: dict):
        if ctx is None:
            return loss_fn(params, _to_device(batch, params.embed.device),
                           cfg)
        rows = _rank_rows(batch["tokens"].shape[0], 1, (0, 1),
                          (ctx.dp_rank, ctx.dp_size))
        work = _working(params, cfg, ctx)
        with mesh_context(ctx):
            loss = loss_fn(work, _to_device(_select(batch, rows),
                                            work.embed.device), cfg).float()
        _all_reduce(loss, ctx, ctx.dp)
        return loss / ctx.dp_size if cfg.family != "vlm" else loss
    return eval_step
