"""Shared layers: dense, RMS norm, RoPE, GQA attention with a dense KV
cache, SwiGLU.  The port of ``repro.models.layers``.

Each layer is an ``nn.Module`` that holds its parameters under the
reference's names and in its layout (``x @ w`` with ``w`` of shape
``(d_in, d_out)``), so a reference parameter tree loads without transposes
(``models.convert``); the apply functions keep the reference's names and
take the module where the reference takes its parameter dict.  Parameters
are float32 and cast to ``COMPUTE_DTYPE`` at use, as in the reference.
They are made without gradients (serving); ``model.requires_grad_(True)``
or ``init_params(..., trainable=True)`` makes them trainable.  The RMS norm
carries the reference's hand-written backward (``_RMSNorm``); everything
else is differentiated by autograd.

Under a mesh context (``sharding.mesh_context``, as the train, eval and
serve steps run the forward) the SwiGLU and, where the kv heads divide the
model axis, attention are tensor-parallel over "model", Megatron-style:
``wq``/``wk``/``wv``/``wi``/``wg`` are column-parallel on this rank's
columns, ``wo`` is row-parallel.  On a whole residual the input passes
``sharding.copy_to_tp`` (``dense(..., gather="col")``) and ``wo``'s sums
``sharding.reduce_from_tp`` (``gather="row"``).  On the sequence-sharded
residual (``sharding.residual_rows``: the steps' forward on a model axis
above 1 where it divides S) the layer's input is this rank's S/m rows:
it is gathered over the sequence (``sharding.all_gather_seq``, whose
backward reduce-scatters the ranks' partial gradients) and ``wo``'s sums
are reduce-scattered back to the rank's rows (``gather="scatter"``,
``sharding.reduce_scatter_seq``).  The weights are each
rank's shards as plain tensors (``train.train_step``
``cast_and_gather_params``), and each layer reads its local head count off
its shard (local columns / head_dim), so one config serves every model
axis; without a context the same code is the one-device layer.

Where the kv heads do not divide a model axis above 1, the heads are not
split: every rank computes the whole layer, but the working copy still
holds only the rank's storage shards of ``wq``/``wk``/``wv`` (columns)
and ``wo`` (rows) (``train_step.working_specs``), and each use gathers
its weight whole, cast to the compute dtype first so that the gather
moves bf16 (``at_use``, ``sharding.gather_weight``); the whole weight
lives for one block's forward, or under remat its recompute.  On the
sequence-sharded residual (the reference's rule, ``seq_sharded``) the
layer runs the reference's sequence-sharded attention
(``src/repro/models/layers.py:143-170`` and ``:191-259``) on the rank's
rows (``_attention_rows``): q, k and v are projected from its S/m rows at
their positions, K and V gathered over the sequence in float32
(``seq_attention``), the materialised core run with the causal mask
offset by its first row (``seq_rows``, the reference's custom VJP: dQ
stays with the rank's rows, dK and dV are partial sums over them,
reduce-scattered to their rows' owners by the gather's backward), and
``wo`` applied to the rows; each weight's gradient is a sum over the
rank's rows, reduce-scattered in float32 to the rank's shard (the q/k/v
biases, whole, pass ``copy_to_tp``).  No projection runs on all rows.
On a whole residual at a model axis above 1 (an S that the axis does
not divide) the reference leaves the layout to its partitioner; the
port computes the same values with the heads replicated over "model",
every rank the whole layer and the same whole gradient, of which it
keeps its shard's slice.

Decode under a mesh context is sequence-parallel, as the reference's
``cache_specs`` lays the cache out: each rank holds S/m of the cache's
positions, the rank that owns position ``len`` writes the new K/V row,
and every rank scores the query against its positions
(``scores``), the row maxima merged by ``decode_max``, the softmax
sums and the P·V partials (``decode_values``) by ``decode_sum``; the
probabilities are rounded to the compute dtype after the global sum, as
the reference rounds them.  The queries of a head-split layer are
gathered over the heads first (``gather_seq`` on the head dim) and the
merged output sliced back to the rank's heads before ``wo``.

Attention with ``q_offset == 0`` runs the flash kernel (``kernels.ops
.flash_attention``) when ``Sq == Sk`` (every self-attention prefill and
full-sequence forward) or when it is non-causal with ``Sq > 1`` (an
encoder's and a prefill's cross-attention, any Sk: the kernel masks its
ragged tiles); the decode step (one query against the cache, offset by the
cache length, or against the encoder's K/V) runs the reference's
materialised softmax, as the reference does: the flash kernel has no query
offset.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops, ref
from ..kernels.build import PlanError
from ..launch.op_count import attn_core
from ..sharding import (all_gather_seq, cast_weight, copy_to_tp, decode_max,
                        decode_sum, gather_seq, gather_weight, norm_sum,
                        reduce_from_tp, reduce_scatter_seq, residual_rows,
                        tp_group)

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------- helpers --
def param(shape, generator: Optional[torch.Generator], device, *,
          scale: float = 1.0, fill: Optional[float] = None) -> nn.Parameter:
    """A float32 parameter on ``device``: ``fill`` everywhere, or a standard
    normal times ``scale`` drawn from ``generator`` (on the generator's
    device, then moved); left uninitialised when there is no generator (a
    weight carry fills it)."""
    if generator is None:
        t = torch.empty(shape, dtype=PARAM_DTYPE, device=device)
    elif fill is not None:
        t = torch.full(shape, fill, dtype=PARAM_DTYPE, device=device)
    else:
        t = torch.randn(shape, generator=generator, dtype=PARAM_DTYPE,
                        device=generator.device).mul_(scale).to(device)
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``w`` (d_in, d_out) drawn as normal · d_in^-0.5, optional zero
    bias ``b``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 generator=None, device=None):
        super().__init__()
        self.w = param((d_in, d_out), generator, device, scale=d_in ** -0.5)
        self.b = (param((d_out,), generator, device, fill=0.0) if bias
                  else None)


def dense(p: Dense, x: torch.Tensor, gather: Optional[str] = None
          ) -> torch.Tensor:
    """``x @ w (+ b)``.  ``gather`` keeps the reference's signature
    (``layers.py:39-55``, where it pins the weight's layout for the
    partitioner); here, under a mesh context, it names the tensor-parallel
    role of the rank's shard: ``"col"`` a column-parallel product on a
    whole input (the input through ``copy_to_tp``, the output this rank's
    columns, the bias its slice), ``"row"`` a row-parallel one (the input
    this rank's features, the partial sums through ``reduce_from_tp``,
    then the bias), ``"scatter"`` a row-parallel one into the
    sequence-sharded residual (the partial sums through
    ``reduce_scatter_seq``, each rank keeping its rows).  A
    column-parallel product on the residual's rows gathered by
    ``all_gather_seq`` passes ``gather=None``: the gather's backward sums
    the ranks' parts.  Without a context, or with ``gather=None``, the
    plain product."""
    tp = tp_group() if gather else None
    if tp is not None and gather == "col":
        x = copy_to_tp(x, tp)
    y = x @ cast_weight(p.w, x.dtype)
    if tp is not None and gather == "row":
        y = reduce_from_tp(y, tp)
    elif tp is not None and gather == "scatter":
        y = reduce_scatter_seq(y, tp)
    if p.b is not None:
        y = y + cast_weight(p.b, x.dtype)
    return y


def heads_split(n_kv: int, m: Optional[int] = None) -> bool:
    """Whether an attention's heads split over a model axis of ``m`` (the
    active mesh context's when not given; False without one): its
    ``n_kv`` kv heads divide the axis.  The working copy then holds each
    rank's heads (``train.train_step.working_specs``), else the weights'
    storage shards, gathered whole at each use (``at_use``)."""
    if m is None:
        tp = tp_group()
        if tp is None:
            return False
        m = tp.size
    return n_kv % m == 0


def local_heads(t: torch.Tensor, n_heads: int, dh: int, what: str,
                split: bool) -> int:
    """The heads of this rank's shard ``t`` (local columns / ``dh``): its
    1/m of ``n_heads`` when the heads are ``split`` over the model axis,
    all of them otherwise."""
    tp = tp_group()
    m = tp.size if split and tp is not None else 1
    h = t.shape[-1] // dh
    if h * m != n_heads or t.shape[-1] % dh:
        raise PlanError(f"{what}: a shard of {t.shape[-1]} columns is not "
                        f"1/{m} of {n_heads} heads of {dh}; under a model "
                        "axis the weights are each rank's working shards "
                        "(train.train_step.cast_and_gather_params)")
    return h


@dataclasses.dataclass(frozen=True)
class Gathered:
    """A ``Dense`` for one use: its weight gathered whole, its bias."""
    w: torch.Tensor
    b: Optional[torch.Tensor]


def at_use(d: Dense, dim: int, dtype: torch.dtype, tp,
           partial: bool = False):
    """``d`` for one use by an attention whose heads do not split over the
    model group ``tp``: the working copy holds the weight's storage shard
    (``wq``/``wk``/``wv`` their columns, ``dim`` 1; ``wo`` its rows, 0),
    here cast to ``dtype`` and gathered whole (``sharding.gather_weight``:
    its gradient, in float32, reduce-scattered back to the shard where
    each rank's rows give a partial sum, ``partial``, else sliced); the
    bias is whole, its gradient with ``partial`` summed over the ranks
    (``copy_to_tp``).  The whole weight lives while its use's autograd
    node keeps it: under remat (every full-size config's) one block's
    forward or its recompute; without remat until the backward reaches
    the block.  ``d`` itself without a group."""
    if tp is None:
        return d
    b = d.b
    if b is not None and partial:
        b = copy_to_tp(b, tp)
    return Gathered(gather_weight(d.w, dim, dtype, tp, partial), b)


class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP of ``rms_norm``: the forward saves
    (scale, x, inv) with ``inv`` the float32 row statistic, and the
    backward keeps every full-size tensor in the cotangent's dtype, the
    row statistic ``mean(sdy · x)`` in float32, rounding where
    ``_rms_norm_bwd`` rounds."""

    @staticmethod
    def forward(ctx, scale, x, eps):
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps)                     # (..., 1) float32
        ctx.save_for_backward(scale, x, inv)
        return x * inv.to(x.dtype) * cast_weight(scale, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        scale, x, inv = ctx.saved_tensors
        sdy = dy * cast_weight(scale, dy.dtype)
        m = (sdy.float() * x.float()).sum(dim=-1, keepdim=True) / x.shape[-1]
        dx = sdy * inv.to(dy.dtype) - x * (m * inv ** 3).to(dy.dtype)
        dscale = (dy * x * inv.to(dy.dtype)).float().sum(
            dim=tuple(range(dy.ndim - 1))).to(scale.dtype)
        return dscale, dx, None


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The variance in float32; the full-size tensors in x's dtype, in the
    forward and in the hand-written backward."""
    return _RMSNorm.apply(scale, x, eps)


class _RMSNormPart(torch.autograd.Function):
    """``_RMSNorm`` on one rank's features, given the row's sum of squares
    over every rank's (``ss``, float32): the backward returns the direct
    term of dx and this rank's part of the gradient of ``ss``,
    ``-sum(sdy · x) · inv³ / (2n)`` in float32, whose sum over the ranks
    (``norm_sum``'s backward) reaches x through the squares as the
    reference's ``- x · mean(sdy · x) · inv³`` term."""

    @staticmethod
    def forward(ctx, scale, x, ss, n, eps):
        inv = torch.rsqrt(ss / n + eps)                  # (..., 1) float32
        ctx.save_for_backward(scale, x, inv)
        ctx.n = n
        return x * inv.to(x.dtype) * cast_weight(scale, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        scale, x, inv = ctx.saved_tensors
        sdy = dy * cast_weight(scale, dy.dtype)
        part = (sdy.float() * x.float()).sum(dim=-1, keepdim=True)
        dss = -part * inv ** 3 / (2 * ctx.n)
        dx = sdy * inv.to(dy.dtype)
        dscale = (dy * x * inv.to(dy.dtype)).float().sum(
            dim=tuple(range(dy.ndim - 1))).to(scale.dtype)
        return dscale, dx, dss, None, None


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """A rank's part of the row statistic of a norm split over "model":
    the sum of its features' squares in float32, (..., 1)."""
    return x.float().square().sum(dim=-1, keepdim=True)


def rms_norm_split(scale: torch.Tensor, x: torch.Tensor, n: int, tp,
                   eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` over a feature dim of ``n`` split over the model group
    ``tp``: ``x`` and ``scale`` are this rank's features, the sum of
    squares is summed over the ranks (``norm_sum``) and the hand-written
    backward's row statistic with it."""
    ss = norm_sum(sum_squares(x), tp)
    return _RMSNormPart.apply(scale, x, ss, n, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh) — rotate pairs along Dh.  positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.from_numpy(np.asarray(
        theta ** (-np.arange(0, half, dtype=np.float32) / half),
        dtype=np.float32)).to(x.device)
    ang = positions[..., None].float() * freqs                   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]   # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention --
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True


class Attention(nn.Module):
    def __init__(self, cfg: AttnConfig, generator=None, device=None):
        super().__init__()
        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
        self.wq = Dense(cfg.d_model, hq, cfg.qkv_bias, generator, device)
        self.wk = Dense(cfg.d_model, hkv, cfg.qkv_bias, generator, device)
        self.wv = Dense(cfg.d_model, hkv, cfg.qkv_bias, generator, device)
        self.wo = Dense(hq, cfg.d_model, False, generator, device)


def seq_sharded(sq: int, sk: int, n_kv: int) -> bool:
    """The reference's test for its sequence-sharded attention
    (``src/repro/models/layers.py:163-170``): under a context whose model
    axis is above 1, as many queries as keys (more than one), kv heads
    that do not divide the axis and a sequence that does.  Where it holds
    the residual's rows layout takes ``seq_attention``."""
    tp = tp_group()
    if tp is None or tp.size == 1:
        return False
    return sq > 1 and sq == sk and n_kv % tp.size != 0 and sq % tp.size == 0


def _sdpa_core(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    """The flash kernel where its contract holds (no query offset, and as
    many queries as keys, or non-causal with more than one query: the
    kernel's causal mask aligns the first query with the first key); else
    the reference's materialised softmax, its probabilities rounded to q's
    dtype before ``p·v``.  Both are the reference's ``attn_core`` scope
    (``launch.op_count.attn_core``)."""
    sq, sk = q.shape[1], k.shape[1]
    with attn_core:
        if q_offset == 0 and (sq == sk or (not causal and sq > 1)):
            return ops.flash_attention(q, k, v, causal=causal)
        return ref.mha_ref(q, k, v, causal, q_offset)


def scores(q, k, q_pos: int, k_pos0: int, causal: bool):
    """The scaled float32 logits (B, Hkv, G, Sq, Sk) of q (B, Sq, H, Dh),
    its first query at position ``q_pos``, against k (B, Sk, Hkv, Dh),
    its first key at ``k_pos0`` (a rank's rows or cache positions),
    masked (-1e30) past each query's position when ``causal``: the
    reference's materialised core before its softmax.  Scaled and masked
    in place (the same values; one float32 tensor of the logits' size)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float().mul_(
        dh ** -0.5)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_pos
        kpos = torch.arange(k.shape[1], device=q.device) + k_pos0
        logits.masked_fill_((kpos[None, :] > qpos[:, None])[None, None,
                                                             None], -1e30)
    return logits


def seq_rows_forward(q, k, v, causal: bool, row0: int):
    """The rank-local forward of the sequence-sharded attention (the
    reference's ``_sdpa_seq_fwd_impl`` on one rank's rows): q (B, Sq, H,
    Dh) this rank's query rows, the first at position ``row0``; k, v (B,
    Sk, Hkv, Dh) whole.  Returns (out (B, Sq, H, Dh), probs (B, Hkv, G,
    Sq, Sk) in q's dtype)."""
    b, sq, h, dh = q.shape
    probs = torch.softmax(scores(q, k, row0, 0, causal), -1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, dh), probs


def seq_rows_backward(q, k, v, probs, do):
    """The rank-local backward (the reference's ``_sdpa_seq_bwd``, float32
    inside): (dq in q's dtype for these rows, dk and dv float32 partial
    sums over these rows, which the ranks' all-reduce completes).  The
    softmax's gradient, ``p · (dp - sum(dp · p)) · dh^-0.5``, is formed in
    dp's storage (the same values), so that two float32 tensors of the
    probabilities' size are live at once, not four."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    dog = do.reshape(b, sq, hkv, g, dh).float()
    qg = q.reshape(b, sq, hkv, g, dh).float()
    pf = probs.float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pf, dog)
    dlogits = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())   # dp
    dlogits.sub_((dlogits * pf).sum(-1, keepdim=True)).mul_(pf)
    dlogits.mul_(dh ** -0.5)
    del pf
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dlogits, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", dlogits, qg)
    return dq.reshape(b, sq, h, dh).to(q.dtype), dk, dv


class _SeqRows(torch.autograd.Function):
    """``seq_rows_forward`` with ``seq_rows_backward`` as its backward; k
    and v arrive in float32 (exact copies of q's dtype) so that their
    partial gradients leave in float32 and are summed over the ranks
    before they round, as the reference's psum precedes its cast."""

    @staticmethod
    def forward(ctx, q, k, v, causal, row0):
        k, v = k.to(q.dtype), v.to(q.dtype)
        out, probs = seq_rows_forward(q, k, v, causal, row0)
        ctx.save_for_backward(q, k, v, probs)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = seq_rows_backward(*ctx.saved_tensors, do)
        return dq, dk, dv, None, None


def seq_rows(q, k, v, causal: bool, row0: int) -> torch.Tensor:
    """One rank's rows of the sequence-sharded attention, differentiable:
    q this rank's rows (first at ``row0``), k and v whole in float32."""
    return _SeqRows.apply(q, k, v, causal, row0)


def seq_attention(q, k, v, causal: bool, tp) -> torch.Tensor:
    """The sequence-sharded attention on the model group ``tp``: this
    rank's rows of q, k and v (B, S/m, ., Dh), the first at row
    ``rank · S/m``; K and V gathered over the sequence in float32
    (``all_gather_seq``, whose backward reduce-scatters the ranks' partial
    dK/dV sums to the rows' owners before they round, as the reference's
    psum precedes its cast), the rank's query rows against them
    (``seq_rows``) -> this rank's rows of the output (B, S/m, H, Dh)."""
    row0 = tp.rank * q.shape[1]
    kf, vf = all_gather_seq(k.float(), tp), all_gather_seq(v.float(), tp)
    with attn_core:
        return seq_rows(q, kf, vf, causal, row0)


def decode_values(weights, v, dtype) -> torch.Tensor:
    """A rank's P·V partial: the global softmax's probabilities on its
    positions (``weights``, float32), rounded to ``dtype`` as the
    reference rounds them, times its values v (B, Sk_r, Hkv, Dv), summed
    in float32 -> (B, Sq, H, Dv) float32."""
    b, hkv, g, sq, _ = weights.shape
    p = weights.to(dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hkv * g, v.shape[-1])


def merged_decode(q, k, v, q_pos: int, k_pos0: int, causal: bool, tp
                  ) -> torch.Tensor:
    """The sequence-parallel decode attention on the model group ``tp``:
    this rank's logits (``scores``), the row maximum merged
    (``decode_max``), exp and its sum merged (``decode_sum``), the P·V
    partials (``decode_values``) merged (``decode_sum``) -> (B, Sq, H, Dv)
    in q's dtype, the whole softmax over every rank's positions."""
    with attn_core:
        logits = scores(q, k, q_pos, k_pos0, causal)
        top = decode_max(logits.amax(dim=-1, keepdim=True), tp)
        e = torch.exp(logits - top)
        total = decode_sum(e.sum(dim=-1, keepdim=True), tp)
        out = decode_sum(decode_values(e / total, v, q.dtype), tp)
    return out.to(q.dtype)


def gather_heads(parts: list, tp) -> list:
    """Head-split (B, S, h_i, D) tensors whole over the model group: one
    all-gather of their concatenation on the head dim (``gather_seq``),
    split back in rank-major head order."""
    sizes = [t.shape[2] for t in parts]
    both = gather_seq(torch.cat(parts, dim=2), tp, dim=2)
    b, s, _, d = both.shape
    both = both.reshape(b, s, tp.size, sum(sizes), d)
    out, lo = [], 0
    for n in sizes:
        out.append(both[:, :, :, lo:lo + n].reshape(b, s, tp.size * n, d))
        lo += n
    return out


def own_heads(t: torch.Tensor, h: int, tp) -> torch.Tensor:
    """This rank's ``h`` heads of a (B, S, H, D) tensor whole over them."""
    return t[:, :, tp.rank * h:(tp.rank + 1) * h]


def write_cache(buf: torch.Tensor, rows: torch.Tensor, idx: int,
                pos0: int) -> None:
    """Write ``rows`` (B, s, ...) at positions ``idx``.. of a cache whose
    local positions start at ``pos0`` (0 without a mesh): the rows this
    rank owns go in place, the others belong to other ranks."""
    n = buf.shape[1]
    lo, hi = max(idx, pos0), min(idx + rows.shape[1], pos0 + n)
    if lo < hi:
        buf[:, lo - pos0:hi - pos0] = rows[:, lo - idx:hi - idx].to(buf.dtype)


def attention(p: Attention, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[dict] = None,
              cross_kv: Optional[tuple] = None,
              cross_sharded: bool = False):
    """Returns (out, new_kv_cache).  kv_cache: {"k","v": (B, Smax, Hkv,
    Dh), "len": int} for decode: the new keys and values are written into
    the cache's tensors IN PLACE at ``len`` (the reference returns new
    arrays), and the returned cache holds the same tensors and the new
    length.  cross_kv for encoder-decoder cross attention.  Under a mesh
    context the heads are this rank's when they split (q, k and v
    column-parallel, ``wo`` row-parallel), else whole; a cache holds this
    rank's positions (``cache_specs``) and so does ``cross_kv`` with
    ``cross_sharded`` (a decode's encoder rows), and the decode merges
    over "model".  On the sequence-sharded residual
    (``sharding.residual_rows``) ``x`` and the output are this rank's
    sequence rows: split heads gather x over the sequence and
    reduce-scatter ``wo``'s sums back to rows; whole heads project the rows
    (``_attention_rows``)."""
    tp = tp_group()
    split = heads_split(cfg.n_kv)
    rows = residual_rows()
    if rows and not split:
        if kv_cache is not None:
            raise PlanError("attention decodes on a whole residual")
        return _attention_rows(p, x, cfg, cross_kv), kv_cache
    if rows:
        x = all_gather_seq(x, tp)
        col, row = None, "scatter"
    else:
        col, row = ("col", "row") if split else (None, None)

    def use(d: Dense, dim: int):
        # heads that do not split: each rank the whole layer, its weights
        # gathered from their shards at each use
        return d if split else at_use(d, dim, x.dtype, tp)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    hd = cfg.head_dim
    wq = use(p.wq, 1)
    h = local_heads(wq.w, cfg.n_heads, hd, "attention wq", split)
    q = dense(wq, x, gather=col).reshape(b, s, h, hd)
    if cross_kv is not None:
        k, v = cross_kv
        if cross_sharded and tp is not None:
            if split:
                q, = gather_heads([q], tp)
            out = merged_decode(q, k, v, 0, 0, False, tp)
            if split:
                out = own_heads(out, h, tp)
        else:
            out = _sdpa_core(q, k, v, False, 0)
        return dense(use(p.wo, 0), out.reshape(b, s, -1), gather=row), \
            kv_cache
    wk = use(p.wk, 1)
    hkv = local_heads(wk.w, cfg.n_kv, hd, "attention wk", split)
    k = dense(wk, x, gather=col).reshape(b, s, hkv, hd)
    v = dense(use(p.wv, 1), x, gather=col).reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = _sdpa_core(q, k, v, cfg.causal, 0)
        new_cache = None
    else:
        idx = int(kv_cache["len"])
        ck, cv = kv_cache["k"], kv_cache["v"]
        m = tp.size if tp is not None else 1
        if idx + s > ck.shape[1] * m:
            raise ValueError(f"KV cache full: {idx} + {s} tokens > "
                             f"{ck.shape[1] * m} slots")
        new_cache = {"k": ck, "v": cv, "len": idx + s}
        if tp is None:
            ck[:, idx:idx + s] = k.to(ck.dtype)
            cv[:, idx:idx + s] = v.to(cv.dtype)
            # mask out cache slots beyond len via causal mask w/ offset
            out = _sdpa_core(q, ck.to(q.dtype), cv.to(q.dtype), True, idx)
        else:
            if split:
                q, k, v = gather_heads([q, k, v], tp)
            pos0 = tp.rank * ck.shape[1]
            write_cache(ck, k, idx, pos0)
            write_cache(cv, v, idx, pos0)
            out = merged_decode(q, ck.to(q.dtype), cv.to(q.dtype), idx, pos0,
                                True, tp)
            if split:
                out = own_heads(out, h, tp)
    return dense(use(p.wo, 0), out.reshape(b, s, -1), gather=row), new_cache


def _rows_proj(d: Dense, x: torch.Tensor, heads: int, hd: int, tp,
               what: str) -> torch.Tensor:
    """``d``, of an attention whose heads do not split, on this rank's
    sequence rows x -> (B, S/m, heads, hd): its weight gathered whole at
    use, whose gradient, a sum over the rank's rows, is reduce-scattered
    back to the shard, and its bias through ``copy_to_tp`` (``at_use``
    with ``partial``)."""
    b, s, _ = x.shape
    d = at_use(d, 1, x.dtype, tp, partial=True)
    local_heads(d.w, heads, hd, what, False)
    return dense(d, x).reshape(b, s, heads, hd)


def _attention_rows(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                    cross_kv: Optional[tuple] = None) -> torch.Tensor:
    """Attention whose heads are whole on every model rank, on this rank's
    sequence rows x (B, S/m, d): q projected from the rows (``_rows_proj``)
    and, for self-attention, k and v too, at the rows' positions, through
    ``seq_attention``; a cross-attention's K and V (``cross_kv``, gathered
    from the encoder's rows by ``cross_kv_init``) whole, the non-causal
    core on the rank's query rows; ``wo`` on the rows, gathered at use as
    ``_rows_proj`` gathers the others."""
    tp = tp_group()
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = _rows_proj(p.wq, x, cfg.n_heads, hd, tp, "attention wq")
    if cross_kv is not None:
        out = _sdpa_core(q, *cross_kv, False, 0)
    else:
        row0 = tp.rank * s
        positions = torch.arange(row0, row0 + s, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(_rows_proj(p.wk, x, cfg.n_kv, hd, tp, "attention wk"),
                 positions, cfg.rope_theta)
        out = seq_attention(q, k, _rows_proj(p.wv, x, cfg.n_kv, hd, tp,
                                             "attention wv"), cfg.causal, tp)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return dense(at_use(p.wo, 0, out.dtype, tp, partial=True), out)


def cross_kv_init(p: Attention, memory: torch.Tensor, cfg: AttnConfig,
                  memory_layout: str = "whole"):
    """Precompute encoder-memory K/V once per sequence (enc-dec decode);
    this rank's kv heads under a mesh context where they split.
    ``memory_layout`` says what ``memory`` is on a model axis: ``"whole"``
    (every rank the same; a split layer's products pass ``copy_to_tp``, a
    layer whose heads do not split gathers its weights at use),
    ``"gathered"`` (the encoder's sequence-sharded output through
    ``all_gather_seq``, whose backward sums the ranks' parts) or
    ``"rows"`` (the encoder's rows themselves: a layer whose heads do not
    split projects them and gathers K and V over the sequence)."""
    b, sm, _ = memory.shape
    tp = tp_group()
    split = heads_split(cfg.n_kv)
    hd = cfg.head_dim
    if memory_layout == "rows":
        if split:
            raise PlanError("a cross-attention whose kv heads split takes "
                            "the encoder's output gathered")
        return tuple(all_gather_seq(_rows_proj(d, memory, cfg.n_kv, hd, tp,
                                               f"cross {n}"), tp)
                     for n, d in (("wk", p.wk), ("wv", p.wv)))
    wk, wv = ((p.wk, p.wv) if split else
              (at_use(p.wk, 1, memory.dtype, tp),
               at_use(p.wv, 1, memory.dtype, tp)))
    hkv = local_heads(wk.w, cfg.n_kv, hd, "cross wk", split)
    col = "col" if split and memory_layout == "whole" else None
    k = dense(wk, memory, gather=col).reshape(b, sm, hkv, hd)
    v = dense(wv, memory, gather=col).reshape(b, sm, hkv, hd)
    return k, v


# ------------------------------------------------------------------- mlp --
class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, generator=None, device=None):
        super().__init__()
        self.wi = Dense(d_model, d_ff, False, generator, device)
        self.wg = Dense(d_model, d_ff, False, generator, device)
        self.wo = Dense(d_ff, d_model, False, generator, device)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """Under a mesh context this rank's columns of ``wi``/``wg`` and rows
    of ``wo``, the partial sums reduced over "model"; on the
    sequence-sharded residual x and the output are this rank's rows (x
    gathered, the sums reduce-scattered)."""
    col, row = "col", "row"
    if residual_rows():
        x, col, row = all_gather_seq(x, tp_group()), None, "scatter"
    h = F.silu(dense(p.wg, x, gather=col)) * dense(p.wi, x, gather=col)
    return dense(p.wo, h, gather=row)
