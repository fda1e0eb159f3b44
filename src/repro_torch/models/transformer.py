"""Architecture assembly: the port of ``repro.models.transformer``, every
family the reference assembles.

Families:
  dense   — uniform [norm→attn→res, norm→swiglu→res] decoder stack
  moe     — the same with the routed-expert FFN (``models.moe``), the
            first ``first_dense`` layers dense (``dense_layers``)
  ssm     — uniform [norm→SSD→res] stack (attention-free)
  hybrid  — Zamba2: groups of SSD layers + one SHARED attention+MLP block
            applied between groups (same parameters every application,
            its own KV slot each time)
  encdec  — Seamless backbone: a bidirectional encoder (``enc_layers``)
            and a causal decoder whose blocks add cross-attention to the
            encoder's output (no final norm on it); the audio frontend is a
            stub (precomputed frame embeddings enter through
            batch["enc_embeds"]), and the decode cache carries each
            decoder block's encoder K/V (``enc_k``/``enc_v``)
  vlm     — LLaVA-NeXT backbone: the dense stack; the anyres vision
            frontend is a stub (precomputed patch embeddings enter through
            batch["patch_embeds"] and replace the first positions), and
            the loss skips the patch positions
Attention is GQA (``models.layers``) or, with ``attn_type="mla"``, latent
attention (``models.mla``) with its compressed latent cache.

The model is an ``nn.Module`` whose parameter names follow the reference's
tree with the stacked layer axis unrolled (``layers.3.ssd.in_proj.w`` is
row 3 of the reference's ``layers/ssd/in_proj/w``, and an expert leaf
``layers.3.moe.wi`` of shape (E, d, f) is row 3 of ``layers/moe/wi``);
``models.convert``
carries a reference tree over.  The layer stacks the reference scans run as
Python loops.  The decode cache is a dict of tensors in the reference's
layout (leading layer axis); ``decode_step`` updates its tensors IN PLACE
and returns the same tensors with the new length (the reference returns
new arrays).  ``len`` is a Python int.

Training: ``loss_fn`` is the reference's mean cross-entropy in float32 over
the padded vocab; with ``cfg.remat`` each block of a differentiated forward
runs under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``),
so its activations are recomputed in the backward.  ``init_params(...,
trainable=True)`` (or ``model.requires_grad_(True)``) makes the parameters
trainable; serving keeps them frozen.

Under a mesh context (``sharding.mesh_context``; the train, eval and serve
steps run the forward under one) attention, latent attention, the
SwiGLU, the experts and the SSD heads are tensor- and expert-parallel
over "model" on each rank's working shards (``models.layers``,
``models.mla``, ``models.moe``, ``models.ssd``).  On a model axis m above
1 the layout of the activations is the reference's:
  * the vocabulary over "model" (the reference's ``embed``
    ``P("model", "data")``, ``lm_head`` ``P("data", "model")`` and
    vocab-sharded logits, ``transformer.py:402``): the working copy holds
    each rank's V/m rows of the embedding and columns of the head
    (``train.train_step.working_specs``); ``_embed`` looks up the tokens
    the rank's rows hold and sums the partial rows over "model", ``_head``
    gives the rank's logits (B, S, V/m) and ``loss_fn`` takes the
    cross-entropy over the shards (``sharding.vocab_log_likelihood``), so
    no rank holds a (B, S, V) tensor; a tied head is the rank's embedding
    shard transposed, both uses summing into it.  The serving prefill
    (``last_only``) and the decode gather their (B, 1, V) logits whole;
  * the residual stream's sequence over "model" between blocks (the
    reference's ``residual_spec``, ``sharding.py:117-132``): where m
    divides S > 1 (``rows_layout``) each rank holds rows [r·S/m,
    (r+1)·S/m) from the embedding (a reduce-scatter of the partial rows)
    to the final norm, the norms and the residual adds run on them, and
    each layer gathers its input over the sequence and reduce-scatters
    its output back (``sharding.all_gather_seq``/``reduce_scatter_seq``);
    the experts route the rank's rows as they come; attention whose kv
    heads do not divide m projects q, k and v from the rank's rows and
    gathers K and V (``layers.seq_attention``).  An encoder runs on its
    frames' rows the same way, and the decoder's cross-attention takes K/V
    from its output gathered over the sequence.  Under remat each block
    then saves its (B, S/m, d) input.  Elsewhere (the decode's S of 1, an
    S that m does not divide, in an encoder-decoder on either side) the
    residual is whole on every rank, as ``residual_spec`` says.

The decode cache on a mesh is laid out by ``cache_specs`` (the
reference's ``:482-505``): the batch over the batch axes when it has
more than one row, the KV and latent caches' sequence over "model", the
SSD state ``h`` by heads over "model", the conv state whole on every
rank.  ``init_cache(..., ctx=)`` makes a rank's local cache and
``shard_cache`` cuts a whole one; ``decode_step`` under the context then
runs the sequence-parallel decode (``models.layers``).  A dimension that
does not divide its axes raises ``PlanError``, as the reference's
``device_put`` refuses it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import trace
from ..kernels.build import PlanError
from ..kernels.ops import resolve_device
from ..sharding import (MeshContext, all_gather_seq, copy_to_tp, current_ctx,
                        gather_seq, mesh_context, reduce_from_tp,
                        reduce_scatter_seq, residual_layout, residual_rows,
                        split_seq, tp_group, vocab_log_likelihood)
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssd as SSD

SUPPORTED = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the stub frontends' inputs a batch may carry besides its tokens
FRONTEND_INPUTS = ("enc_embeds", "patch_embeds")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_type: str = "gqa"        # gqa | mla
    mla: Optional[MLA.MLAConfig] = None
    moe: Optional[MOE.MoEConfig] = None
    first_dense: int = 0          # leading dense-FFN layers in an MoE stack
    ssd: Optional[SSD.SSDConfig] = None
    shared_every: int = 0         # hybrid: shared attn block between groups
    n_enc_layers: int = 0         # encdec
    n_patches: int = 0            # vlm stub frontend length
    tie_embeddings: bool = True
    remat: bool = True
    microbatches: int = 1         # grad-accumulation steps in train_step

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Embedding/lm_head rows padded to a 512 multiple, as the reference
        pads them (logits for pad ids are live and never chosen in
        decode, which cuts them off)."""
        return -(-self.vocab // 512) * 512

    def attn_cfg(self, causal: bool = True) -> L.AttnConfig:
        return L.AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                            n_kv=self.n_kv, head_dim=self.hd,
                            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
                            causal=causal)


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family not in SUPPORTED:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"families are {', '.join(SUPPORTED)}")
    if cfg.family == "moe" and not isinstance(cfg.moe, MOE.MoEConfig):
        raise ValueError(f"{cfg.name}: the moe family needs a MoEConfig")
    if cfg.attn_type == "mla" and not isinstance(cfg.mla, MLA.MLAConfig):
        raise ValueError(f"{cfg.name}: attn_type 'mla' needs an MLAConfig")
    if cfg.family == "hybrid" and (cfg.shared_every <= 0
                                   or cfg.n_layers % cfg.shared_every):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of {cfg.shared_every}")


# =============================================================== blocks ====
class AttnBlock(nn.Module):
    """Attention (GQA, or latent with ``attn_type="mla"``) and a SwiGLU
    MLP; with ``cross`` (an encoder-decoder's decoder block) also a norm
    ``lnx`` and a cross-attention ``xattn`` between them."""

    def __init__(self, cfg: ArchConfig, generator=None, device=None,
                 mlp: bool = True, cross: bool = False):
        super().__init__()
        g, dev = generator, device
        self.ln1 = L.param((cfg.d_model,), g, dev, fill=1.0)
        self.ln2 = L.param((cfg.d_model,), g, dev, fill=1.0)
        self.attn = (MLA.MLA(cfg.mla, g, dev) if cfg.attn_type == "mla"
                     else L.Attention(cfg.attn_cfg(), g, dev))
        if cross:
            self.lnx = L.param((cfg.d_model,), g, dev, fill=1.0)
            self.xattn = L.Attention(cfg.attn_cfg(causal=False), g, dev)
        if mlp:
            self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, g, dev)


class MoEBlock(AttnBlock):
    """An ``AttnBlock`` whose MLP is the routed experts (``moe``)."""

    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__(cfg, generator, device, mlp=False)
        self.moe = MOE.MoE(cfg.moe, generator, device)


class SSDBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        self.ln = L.param((cfg.d_model,), generator, device, fill=1.0)
        self.ssd = SSD.SSD(cfg.ssd, generator, device)


def _norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``rms_norm`` on the residual stream: on its sequence rows
    (``sharding.residual_rows``) the scale's gradient is a sum over the rank's
    rows, so the scale passes ``copy_to_tp`` (summed over "model")."""
    if residual_rows():
        scale = copy_to_tp(scale, tp_group())
    return L.rms_norm(scale, x)


def _attn_block_apply(p: AttnBlock, x, cfg: ArchConfig, positions=None,
                      cache=None, cross_kv=None, causal=True):
    h = _norm(p.ln1, x)
    if cfg.attn_type == "mla":
        a, cache = MLA.mla_attention(p.attn, h, cfg.mla, positions=positions,
                                     cache=cache)
    else:
        a, cache = L.attention(p.attn, h, cfg.attn_cfg(causal=causal),
                               positions=positions, kv_cache=cache)
    x = x + a
    if hasattr(p, "xattn") and cross_kv is not None:
        h = _norm(p.lnx, x)
        # a decode's encoder K/V come from its cache: on a mesh, this
        # rank's positions
        a, _ = L.attention(p.xattn, h, cfg.attn_cfg(causal=False),
                           cross_kv=cross_kv, cross_sharded=cache is not None)
        x = x + a
    h = _norm(p.ln2, x)
    if isinstance(p, MoEBlock):
        x = x + MOE.moe_ffn(p.moe, h, cfg.moe)
    else:
        x = x + L.swiglu(p.mlp, h)
    return x, cache


def _ssd_block_apply(p: SSDBlock, x, cfg: ArchConfig, state=None):
    h = _norm(p.ln, x)
    if state is None:
        y, _ = SSD.ssd_forward(p.ssd, h, cfg.ssd)
        new_state = None
    else:
        y, new_state = SSD.ssd_decode_step(p.ssd, h, cfg.ssd, state)
    return x + y, new_state


# ========================================================= whole model ====
class Model(nn.Module):
    """Embedding (vocab_padded, d_model), the layer stack, the final norm,
    the lm head (tied to the embedding unless ``tie_embeddings`` is off)
    and, for the hybrid, the shared attention block.  An MoE stack is
    ``dense_layers`` (its first ``first_dense`` layers, dense) and then
    ``layers`` (MoE blocks); every other family has no dense layers.  An
    encoder-decoder has ``enc_layers`` (``n_enc_layers`` attention
    blocks) and decoder ``layers`` with cross-attention; every other
    family has no encoder layers."""

    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        g, dev = generator, device
        v, d = cfg.vocab_padded, cfg.d_model
        self.embed = L.param((v, d), g, dev, scale=d ** -0.5)
        self.final_norm = L.param((d,), g, dev, fill=1.0)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.param((d, v), g, dev, scale=d ** -0.5))
        block = {"dense": AttnBlock, "vlm": AttnBlock, "moe": MoEBlock,
                 "encdec": functools.partial(AttnBlock, cross=True)
                 }.get(cfg.family, SSDBlock)
        n_dense = cfg.first_dense if cfg.family == "moe" else 0
        n_enc = cfg.n_enc_layers if cfg.family == "encdec" else 0
        self.enc_layers = nn.ModuleList(AttnBlock(cfg, g, dev)
                                        for _ in range(n_enc))
        self.dense_layers = nn.ModuleList(AttnBlock(cfg, g, dev)
                                          for _ in range(n_dense))
        self.layers = nn.ModuleList(block(cfg, g, dev)
                                    for _ in range(cfg.n_layers - n_dense))
        self.shared_block = (AttnBlock(cfg, g, dev)
                             if cfg.family == "hybrid" else None)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, *, trainable: bool = False) -> Model:
    """Fresh weights from the reference's distributions (dense weights
    normal · d_in^-0.5, the embedding normal · d_model^-0.5, conv weights
    normal · 0.1, the experts' normal · d_in^-0.5, norms and D ones,
    biases, A_log and dt_bias zeros), drawn
    from ``generator`` on its own device and placed on ``device`` (the card
    unless the caller names the CPU); with ``trainable`` the parameters
    require gradients."""
    return Model(cfg, generator, resolve_device(device)).requires_grad_(
        trainable)


def abstract_params(cfg: ArchConfig) -> Model:
    """The model's parameters as ``meta`` tensors (shape and dtype, no
    storage): the port of ``repro.models.transformer.abstract_params``,
    whose ``ShapeDtypeStruct`` tree it stands for.  ``Model`` takes the
    device as given (``resolve_device`` refuses ``meta``)."""
    return Model(cfg, None, torch.device("meta"))


def _spec_for(joined: str, body: int) -> tuple:
    """The reference's rule (``transformer.py:279-303``) on a reference
    path ``joined`` (``layers/attn/wq/w``) of a leaf with ``body`` dims
    past the layer axis, that axis left out."""
    if "embed" in joined:
        return ("model", "data")
    if "lm_head" in joined:
        return ("data", "model")
    if body == 1:                          # norms, biases, A_log, D, ...
        return (None,)
    if "router" in joined:
        return (None, None)
    if "moe/wi" in joined or "moe/wg" in joined or "moe/wo" in joined:
        return ("model", None, None)                  # EP over experts
    if any(t in joined for t in ("wq", "wk", "wv", "wi", "wg", "wkv_a",
                                 "in_proj")):
        return ("data", "model")                      # col-parallel
    if any(t in joined for t in ("wo", "out_proj", "wkv_b")):
        return ("model", "data")                      # row-parallel
    if "conv_w" in joined:
        return (None, "model")
    return (None,) * body


def param_specs(cfg: ArchConfig) -> dict:
    """Specs by the port's parameter name (``sharding``'s tuples; the
    reference's ``:276-305``): FSDP ("data") on weight rows, TP ("model")
    on QKV/FFN columns, vocab over "model".  Each name gets the
    reference's spec of the leaf ``models.convert`` maps it to; a stacked
    leaf (``convert.STACKED``) has no layer axis here, so its spec loses
    the reference's leading ``None``."""
    from .convert import reference_path
    return {name: _spec_for(reference_path(name), p.ndim)
            for name, p in abstract_params(cfg).named_parameters()}


def count_params(model) -> int:
    """Parameters of ``model`` (a ``Model``, or a dict of tensors by
    name), counted as the reference's ``count_params`` sums its leaves."""
    named = (dict(model.named_parameters())
             if isinstance(model, nn.Module) else dict(model))
    return int(sum(t.numel() for t in named.values()))


def _vocab_tp():
    """The model group when the vocabulary is sharded over it (a context
    whose model axis is above 1), else None."""
    tp = tp_group()
    return tp if tp is not None and tp.size > 1 else None


def rows_layout(batch: dict, m: int) -> bool:
    """Whether a forward of ``batch`` on a model axis of ``m`` keeps the
    residual stream as each model rank's S/m sequence rows: the
    reference's ``residual_spec`` (m above 1, S above 1, m divides S), for
    the tokens and, in an encoder-decoder, the encoder's frames too (the
    decoder's cross-attention reads the encoder's output in the layout
    the encoder ran in)."""
    seqs = [batch["tokens"].shape[1]]
    if "enc_embeds" in batch:
        seqs.append(batch["enc_embeds"].shape[1])
    return m > 1 and all(s > 1 and s % m == 0 for s in seqs)


def _vocab_rows(params: Model, cfg: ArchConfig, tp) -> int:
    """This rank's rows of the embedding (its V/m of the padded
    vocabulary, the working copy's shard); PlanError if they are not."""
    n = params.embed.shape[0]
    head = n if params.lm_head is None else params.lm_head.shape[1]
    if n * tp.size != cfg.vocab_padded or head != n:
        raise PlanError(f"{cfg.name}: embedding rows {n} and LM head "
                        f"columns {head} are not 1/{tp.size} of the padded "
                        f"vocabulary {cfg.vocab_padded} (the working copy "
                        "shards the vocabulary over the model axis)")
    return n


def _embed(params: Model, tokens: torch.Tensor,
           cfg: Optional[ArchConfig] = None) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype.  Under a context whose
    model axis is above 1 (``cfg`` given) each rank looks up the tokens
    its vocabulary rows hold and writes zeros for the others, and the
    partial rows are summed over "model": reduce-scattered into the
    rank's sequence rows on the sequence-sharded residual, else
    all-reduced.  Exactly one rank adds a nonzero row, so the sum is
    exact; the backward reaches the rank's own rows only."""
    tp = _vocab_tp()
    if tp is None:
        return params.embed[tokens.long()].to(L.COMPUTE_DTYPE)
    n = _vocab_rows(params, cfg, tp)
    ids = tokens.long() - tp.rank * n
    own = ((ids >= 0) & (ids < n))[..., None]
    part = torch.where(own, params.embed[ids.clamp(0, n - 1)].to(
        L.COMPUTE_DTYPE), 0.0)
    return (reduce_scatter_seq(part, tp) if residual_rows()
            else reduce_from_tp(part, tp))


def _place_patches(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """The vlm stub's patch embeddings (B, P, d) in place of the first P
    positions: on the sequence-sharded residual, of those among the
    rank's rows."""
    pe = pe.to(x.device, x.dtype)
    lo = tp_group().rank * x.shape[1] if residual_rows() else 0
    n = min(max(pe.shape[1] - lo, 0), x.shape[1])
    if n == 0:
        return x
    return torch.cat([pe[:, lo:lo + n], x[:, n:]], dim=1)


def _logits(params: Model, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(params.final_norm, x)
    head = params.embed.T if params.lm_head is None else params.lm_head
    return x @ L.cast_weight(head, x.dtype)


def _head(params: Model, x: torch.Tensor, cfg: ArchConfig,
          last_only: bool = False) -> torch.Tensor:
    """The final norm and the LM head (with ``last_only`` on the last
    position).  Without a context, or on a model axis of 1, the whole
    vocabulary.  On a larger axis the head is this rank's V/m columns
    (tied: the embedding's rows, transposed): the final norm runs on the
    residual's rows, which are gathered over the sequence in front of the
    column-parallel head (``all_gather_seq``; ``copy_to_tp`` on a whole
    residual), giving this rank's logits (B, S, V/m); ``last_only`` takes
    the last rank's last row and gathers the (B, 1, V) logits whole over
    the vocabulary, as serving returns them."""
    tp = _vocab_tp()
    rows = residual_rows()
    if last_only:
        x = x[:, -1:, :]
        if rows:                                 # the last rank's last row
            x, rows = gather_seq(x, tp)[:, -1:], False
    if tp is None:
        return _logits(params, x)
    _vocab_rows(params, cfg, tp)
    x = L.rms_norm(copy_to_tp(params.final_norm, tp) if rows
                   else params.final_norm, x)
    x = all_gather_seq(x, tp) if rows else copy_to_tp(x, tp)
    head = params.embed.T if params.lm_head is None else params.lm_head
    logits = x @ L.cast_weight(head, x.dtype)
    return gather_seq(logits, tp, dim=-1) if last_only else logits


def _maybe_remat(apply, cfg: ArchConfig):
    """``apply(p, x, cfg)``'s residual out, under ``torch.utils.checkpoint``
    when ``cfg.remat`` and autograd is recording (the reference's
    ``jax.checkpoint`` around each block); a plain call otherwise.  The
    recompute runs inside the backward, which on the card runs on the
    autograd engine's device thread, where the forward's thread-local mesh
    context is not set: it re-enters the context the forward ran under.
    Each application is a ``model.block`` span, the recompute another."""
    def block(p, x):
        if cfg.remat and torch.is_grad_enabled():
            ctx = current_ctx()

            def run(h):
                with mesh_context(ctx), trace.span("model.block"):
                    return apply(p, h, cfg)[0]
            return checkpoint(run, x, use_reentrant=False)
        with trace.span("model.block"):
            return apply(p, x, cfg)[0]
    return block


def _encode(params: Model, enc_embeds: torch.Tensor, cfg: ArchConfig):
    """The encoder stack over the stub frontend's frame embeddings (cast to
    the compute dtype, on the model's device): non-causal blocks and no
    final norm, as the reference's ``forward`` runs them.  Returns (its
    output, ``cross_kv_init``'s ``memory_layout`` for it): (B, S_enc,
    d_model) ``"whole"``; on the sequence-sharded residual the rank's rows
    gathered over the sequence (``"gathered"``) where the cross-attention's
    kv heads split, else the rows themselves (``"rows"``)."""
    h = enc_embeds.to(params.embed.device, L.COMPUTE_DTYPE)
    rows, tp = residual_rows(), tp_group()
    if rows:
        h = split_seq(h, tp)
    enc = _maybe_remat(functools.partial(_attn_block_apply, causal=False),
                       cfg)
    for p in params.enc_layers:
        h = enc(p, h)
    if not rows:
        return h, "whole"
    if L.heads_split(cfg.n_kv):
        return all_gather_seq(h, tp), "gathered"
    return h, "rows"


def _decoder_block(enc: torch.Tensor, memory_layout: str):
    """A decoder block's apply with the encoder output ``enc`` captured, as
    the reference's closure captures it: the block's cross K/V are
    ``cross_kv_init`` of ``enc`` inside the block (recomputed with it under
    remat); ``memory_layout`` as ``_encode`` returns it."""
    def apply(p: AttnBlock, x, cfg: ArchConfig):
        ckv = L.cross_kv_init(p.xattn, enc, cfg.attn_cfg(causal=False),
                              memory_layout)
        return _attn_block_apply(p, x, cfg, cross_kv=ckv)
    return apply


def forward(params: Model, batch: dict, cfg: ArchConfig,
            last_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab_padded); with
    ``last_only`` the lm head runs on the final position only (serving
    prefill returns just the next-token distribution).  ``vlm`` takes
    batch["patch_embeds"] (B, P, d_model) in place of the first P
    positions' embeddings, ``encdec`` batch["enc_embeds"] (B, S_enc,
    d_model) as the encoder's input.  Under a context whose model axis m
    is above 1 the residual stream is each rank's S/m sequence rows where
    ``rows_layout`` says so (the encoder's too), and the logits are this
    rank's V/m vocabulary columns (B, S, V/m), or with ``last_only`` the
    whole (B, 1, V) (``_head``)."""
    check_supported(cfg)
    tp = _vocab_tp()
    with residual_layout(rows_layout(batch, tp.size if tp else 1)):
        attn = _maybe_remat(_attn_block_apply, cfg)
        ssd = _maybe_remat(_ssd_block_apply, cfg)
        x = _embed(params, batch["tokens"], cfg)
        if cfg.family == "vlm":
            x = _place_patches(x, batch["patch_embeds"])
        if cfg.family == "encdec":
            dec = _maybe_remat(_decoder_block(*_encode(
                params, batch["enc_embeds"], cfg)), cfg)
            for p in params.layers:
                x = dec(p, x)
        elif cfg.family in ("dense", "vlm", "moe"):
            for p in (*params.dense_layers, *params.layers):
                x = attn(p, x)
        elif cfg.family == "ssm":
            for p in params.layers:
                x = ssd(p, x)
        else:                                           # hybrid
            g = cfg.shared_every
            for i, p in enumerate(params.layers):
                x = ssd(p, x)
                if (i + 1) % g == 0:
                    x = attn(params.shared_block, x)
        with trace.span("model.head"):
            return _head(params, x, cfg, last_only)


def loss_fn(params: Model, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Next-token cross-entropy in float32 over the padded vocab, the
    reference's ``loss_fn``: the mean over every position, or for ``vlm``
    the sum over the positions from ``n_patches`` on (the patch positions
    carry no label) divided by the mask's count, which is one row's (the
    reference's mask is (1, S)), so a vlm batch of B rows gives B times
    the per-token mean, as the reference's does.  On a model axis above 1
    the logits are this rank's vocabulary columns and the log-likelihood
    comes from ``sharding.vocab_log_likelihood`` over the shards."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"].to(logits.device).long()
    tp = _vocab_tp()
    if tp is None:
        lp = F.log_softmax(logits.float(), dim=-1)
        ll = lp.gather(-1, labels[..., None])[..., 0]
    else:
        ll = vocab_log_likelihood(logits, labels, tp)
    mask = torch.ones_like(ll)
    if cfg.family == "vlm":
        pos = torch.arange(labels.shape[1], device=ll.device)[None, :]
        mask = (pos >= cfg.n_patches).float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------- decode --
def init_cache_abstract(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The cache's leaves as ``meta`` tensors (shape and dtype, no storage)
    for one-token decode with a ``max_len`` context; ``len`` is a 0-d int32
    leaf, a Python int in a live cache."""
    check_supported(cfg)
    bf16, f32 = L.COMPUTE_DTYPE, torch.float32

    def leaf(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    length = leaf((), torch.int32)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        if cfg.attn_type == "mla":
            m = cfg.mla
            return {"ckv": leaf((cfg.n_layers, batch, max_len,
                                 m.kv_lora + m.qk_rope), bf16),
                    "len": length}
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
        out = {"k": leaf(shape, bf16), "v": leaf(shape, bf16),
               "len": length}
        if cfg.family == "encdec":
            out.update(enc_k=leaf(shape, bf16), enc_v=leaf(shape, bf16))
        return out
    s = cfg.ssd
    out = {"h": leaf((cfg.n_layers, batch, s.n_heads, s.headdim, s.d_state),
                     f32),
           "conv": leaf((cfg.n_layers, batch, s.conv_width - 1, s.conv_dim),
                        f32)}
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.shared_every
        shape = (n_groups, batch, max_len, cfg.n_kv, cfg.hd)
        out.update(shared_k=leaf(shape, bf16), shared_v=leaf(shape, bf16),
                   len=length)
    return out


def cache_specs(cfg: ArchConfig, batch: int) -> dict:
    """The cache's specs by leaf (``sharding``'s tuples; the reference's
    ``:482-505``): the batch over ("pod", "data") when it has more than
    one row, the KV-like leaves' sequence over "model" (sequence-parallel
    decode attention), the SSD state ``h``'s heads over "model", ``conv``
    replicated over it, ``len`` a scalar."""
    dp = ("pod", "data") if batch > 1 else None
    out = {}
    for name, leaf in init_cache_abstract(cfg, batch, 8).items():
        if leaf.ndim == 0:
            out[name] = ()
        elif name == "h":
            out[name] = (None, dp, "model", None, None)
        elif name == "conv":
            out[name] = (None, dp, None, None)
        else:
            out[name] = (None, dp, "model", *([None] * (leaf.ndim - 3)))
    return out


def _local_part(spec: tuple, ctx: MeshContext):
    """Per dim of a leaf laid out by ``spec``: (the number of parts, this
    rank's index) over the axes the spec names (1, 0 where it names
    none)."""
    out = []
    for entry in spec:
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        axes = tuple(a for a in axes if a in ctx.mesh.mesh_dim_names)
        out.append((math.prod(ctx.size(a) for a in axes),
                    ctx.rank_along(axes)))
    return out


def _check_split(name: str, shape, parts) -> None:
    for dim, (n, (k, _)) in enumerate(zip(shape, parts)):
        if n % k:
            raise PlanError(f"cache leaf {name!r}: dim {dim} of "
                            f"{tuple(shape)} does not split into {k} parts "
                            "on the mesh "
                            "(the reference's device_put refuses it too)")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, fill_len: int = 0,
               device=None, ctx: Optional[MeshContext] = None) -> dict:
    """A zeroed cache on ``device`` (the card unless the caller names the
    CPU; ``"meta"`` gives shapes alone, for the dry run), ``len`` =
    ``fill_len``; with ``ctx`` this rank's part of it, laid out by
    ``cache_specs``."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    specs = cache_specs(cfg, batch) if ctx is not None else None
    out = {}
    for k, t in init_cache_abstract(cfg, batch, max_len).items():
        if k == "len":
            out[k] = int(fill_len)
            continue
        shape = tuple(t.shape)
        if specs is not None:
            parts = _local_part(specs[k], ctx)
            _check_split(k, shape, parts)
            shape = tuple(n // p for n, (p, _) in zip(shape, parts))
        out[k] = torch.zeros(shape, dtype=t.dtype, device=dev)
    return out


def shard_cache(cache: dict, cfg: ArchConfig, ctx: MeshContext) -> dict:
    """This rank's part of a whole cache, laid out by ``cache_specs``
    (copies; ``len`` as it is)."""
    b = next(t.shape[1] for k, t in cache.items() if k != "len")
    specs = cache_specs(cfg, b)
    out = {}
    for k, t in cache.items():
        if k == "len":
            out[k] = int(t)
            continue
        parts = _local_part(specs[k], ctx)
        _check_split(k, t.shape, parts)
        for dim, (p, r) in enumerate(parts):
            n = t.shape[dim] // p
            t = t.narrow(dim, r * n, n)
        out[k] = t.contiguous().clone()
    return out


def decode_step(params: Model, batch: dict, cache: dict, cfg: ArchConfig):
    """One-token decode.  batch["tokens"]: (B, 1).  Returns (logits
    (B, 1, vocab), cache): the cache's tensors are updated in place, the
    returned dict holds them and the new length.  An ``encdec`` decoder
    block attends (non-causally) to its ``enc_k``/``enc_v`` row, which the
    caller fills (``cross_kv_init`` of the encoder's output) before the
    first step.  Under a mesh context ``cache`` is this rank's part
    (``init_cache(..., ctx=)``, ``shard_cache``), the tokens its rows, and
    the attention sequence-parallel over "model"."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg)

    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        # an MoE stack's dense layers come first, and so do their slots
        pos = int(cache["len"])
        positions = torch.full((b, 1), pos, device=x.device)
        leaves = ("ckv",) if cfg.attn_type == "mla" else ("k", "v")
        for i, p in enumerate((*params.dense_layers, *params.layers)):
            blk = {name: cache[name][i] for name in leaves}
            blk["len"] = pos
            ckv = ((cache["enc_k"][i].to(x.dtype), cache["enc_v"][i].to(
                x.dtype)) if cfg.family == "encdec" else None)
            x, _ = _attn_block_apply(p, x, cfg, positions=positions,
                                     cache=blk, cross_kv=ckv)
        new_cache = dict(cache)
        new_cache["len"] = pos + 1
    else:                                               # ssm, hybrid
        hybrid = cfg.family == "hybrid"
        if hybrid:
            pos = int(cache["len"])
            positions = torch.full((b, 1), pos, device=x.device)
        for i, p in enumerate(params.layers):
            x, st = _ssd_block_apply(p, x, cfg, state={
                "h": cache["h"][i], "conv": cache["conv"][i]})
            cache["h"][i].copy_(st["h"])
            cache["conv"][i].copy_(st["conv"])
            if hybrid and (i + 1) % cfg.shared_every == 0:
                gi = i // cfg.shared_every
                blk = {"k": cache["shared_k"][gi], "v": cache["shared_v"][gi],
                       "len": pos}
                x, _ = _attn_block_apply(params.shared_block, x, cfg,
                                         positions=positions, cache=blk)
        new_cache = dict(cache)
        if hybrid:
            new_cache["len"] = pos + 1
    return _head(params, x, cfg, last_only=True)[..., :cfg.vocab], new_cache
