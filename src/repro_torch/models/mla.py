"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), forward
only: the port of ``repro.models.mla``.

V2-Lite geometry: no q down-projection, ``kv_lora`` 512, per head
qk_nope 128 / qk_rope 64 / v_head 128, 16 heads.  Decode caches only the
compressed latent ``ckv`` (B, Smax, kv_lora + qk_rope), updated IN PLACE
at ``len`` (a Python int; the reference returns a new array); K and V are
re-expanded from the whole latent every step, as the reference does.

The prefill's attention core (no cache) runs the flash kernel
(``kernels.ops.flash_attention``), as ``layers._sdpa_core`` sends every
full-sequence GQA core: q and k have the head dim qk_nope + qk_rope and v
its own v_head (the kernel's (192, 128) wgmma instance at V2-Lite's
widths), and the kernel's scale 1/√Dqk is the reference's
``(qk_nope + qk_rope) ** -0.5``.
On the card the kernel launches or raises; it never falls back.  The
decode's core (one query against the cache, offset by its length) is the
reference's materialised softmax, its probabilities rounded to x's dtype
before ``p·v``.

Under a mesh context (the train and eval steps) the heads split over
"model": ``wq`` is column-parallel and ``wo`` row-parallel, as in
``layers.attention``.  The latent's weights are stored as the reference
stores them, which does not line up with a head split: ``wkv_a`` is
column-sharded over the latent and its rope part, ``wkv_b`` row-sharded
over the latent (``transformer.py:296-300``).  So the step's working copy
(``train.train_step.working_specs``) holds ``wkv_a`` whole, gathered
over "model" once a step, and ``wkv_b`` redistributed to a head split (its
columns over "model", an all-to-all of the leaf) once a step; every rank
computes the whole latent, and the latent passes ``copy_to_tp`` before
the head-split ``wkv_b``, so ``wkv_a``'s and ``kv_norm``'s gradients are
whole and equal on every rank.  The train step takes each rank's shard of
``wkv_a``'s gradient and redistributes ``wkv_b``'s back to rows (another
all-to-all).  Cost a step: ``wkv_a``'s all-gather and two all-to-alls of
``wkv_b`` (V2-Lite: 2048 × 576 and 512 × 4096 floats a layer), where the
other choice, ``wkv_b`` row-parallel, would all-reduce a
(B, S, H·(dn + dv)) activation twice a layer.  Where the heads do not
divide the model axis the working copy holds ``wq``, ``wkv_b`` and ``wo``
whole too, and every rank computes the whole layer (the reference leaves
that layout to its partitioner).

On the sequence-sharded residual (``sharding.residual_rows``) the layer's
input is the rank's S/m rows, gathered over the sequence: with its heads
split by ``all_gather_seq`` (whose backward sums the ranks' partial
gradients; the whole latent's gradient, equal on every rank, enters that
sum scaled by 1/m) and ``wo``'s sums reduce-scattered back to the rows;
with its heads whole by ``gather_seq``, the whole layer on every rank and
its output sliced to the rank's rows (``split_seq``).

Decode under a mesh context is sequence-parallel, as ``cache_specs`` lays
out the latent cache (each rank S/m positions): every rank computes the
step's latent row whole and the rank that owns position ``len`` writes
it; each rank expands its positions' latents into every head's K and V
(``wkv_b`` gathered whole over "model" where it is head-split, and the
queries gathered over the heads), and the softmax merges over "model"
(``layers.merged_decode``); the output goes back to the rank's heads
before ``wo``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..kernels import ops, ref
from ..kernels.build import PlanError
from ..launch.op_count import attn_core
from ..sharding import (all_gather_seq, copy_to_tp, gather_seq, scale_grad,
                        residual_rows, split_seq, tp_group)
from . import layers as L


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rope_theta: float = 10000.0


class MLA(nn.Module):
    """The reference's leaves: ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``,
    ``wo``."""

    def __init__(self, cfg: MLAConfig, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        h, dn, dr, dv = cfg.n_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head
        self.wq = L.Dense(cfg.d_model, h * (dn + dr), False, g, dev)
        self.wkv_a = L.Dense(cfg.d_model, cfg.kv_lora + dr, False, g, dev)
        self.kv_norm = L.param((cfg.kv_lora,), g, dev, fill=1.0)
        self.wkv_b = L.Dense(cfg.kv_lora, h * (dn + dv), False, g, dev)
        self.wo = L.Dense(h * dv, cfg.d_model, False, g, dev)


def _expand_kv(w: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
               cfg: MLAConfig):
    """latent (B, S, kv_lora) + shared rope key (B, S, dr) -> per-head K
    (B, S, H, dn + dr), V (B, S, H, dv), through ``wkv_b``'s weight ``w``
    (this rank's heads' columns, or all of them)."""
    b, s, _ = c_kv.shape
    dn = cfg.qk_nope
    h = w.shape[-1] // (dn + cfg.v_head)
    kv = (c_kv @ L.cast_weight(w, c_kv.dtype)).reshape(b, s, h,
                                                        dn + cfg.v_head)
    k = torch.cat([kv[..., :dn],
                   k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope)], dim=-1)
    return k, kv[..., dn:]


def _prefill_core(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal attention through the flash kernel, v at its own width (the
    view ``kv[..., dn:]``, read in place on the card)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if dv > dqk:
        raise PlanError(f"v_head {dv} wider than qk_nope + qk_rope {dqk}: "
                        "the flash kernel takes v no wider than q")
    return ops.flash_attention(q, k, v, causal=True)


def mla_attention(p: MLA, x: torch.Tensor, cfg: MLAConfig,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None):
    """Returns (out, new_cache).  cache = {"ckv": (B, Smax, kv_lora + dr),
    "len": int}: the step's latents are written into ``ckv`` IN PLACE at
    ``len``, and the returned cache holds the same tensor and the new
    length.  Under a mesh context this rank's heads (see the module's
    docstring)."""
    dn, dr, dv = cfg.qk_nope, cfg.qk_rope, cfg.v_head
    tp = tp_group()
    split = L.heads_split(cfg.n_heads)
    rows = residual_rows()
    if rows and cache is None:
        # the sequence-sharded residual: gathered whole over the sequence
        # (split heads: the gather's backward sums the ranks' parts; whole
        # heads: every rank computes the layer, so the gradient is whole
        # and equal, and the gather's backward takes the rank's rows)
        x = all_gather_seq(x, tp) if split else gather_seq(x, tp)
    elif rows:
        raise PlanError("latent attention decodes on a whole residual")
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    h = L.local_heads(p.wq.w, cfg.n_heads, dn + dr, "mla wq", split)
    L.local_heads(p.wkv_b.w, cfg.n_heads, dn + dv, "mla wkv_b", split)
    col = "col" if split and not rows else None

    q = L.dense(p.wq, x, gather=col).reshape(b, s, h, dn + dr)
    q = torch.cat([q[..., :dn], L.rope(q[..., dn:], positions,
                                       cfg.rope_theta)], dim=-1)
    # the whole latent on every rank: on the gathered rows of split heads
    # its equal gradient reaches the gather's sum once in m
    ckv_full = L.dense(p.wkv_a, scale_grad(x, 1.0 / tp.size)
                       if rows and split else x)         # (B, S, kv_lora+dr)
    if ckv_full.shape[-1] != cfg.kv_lora + dr:
        raise PlanError(f"mla wkv_a: {ckv_full.shape[-1]} columns, not the "
                        f"whole latent {cfg.kv_lora} + {dr} (the working "
                        "copy gathers it over the model axis)")
    c_kv = L.rms_norm(p.kv_norm, ckv_full[..., :cfg.kv_lora])
    k_rope = L.rope(ckv_full[..., None, cfg.kv_lora:], positions,
                    cfg.rope_theta)[..., 0, :]           # (B, S, dr)
    if split:                 # each rank's heads add their part of the grad
        latent = copy_to_tp(torch.cat([c_kv, k_rope], dim=-1), tp)
        c_kv, k_rope = latent[..., :cfg.kv_lora], latent[..., cfg.kv_lora:]
    row = ("scatter" if rows else "row") if split else None

    if cache is None:
        k, v = _expand_kv(p.wkv_b.w, c_kv, k_rope, cfg)
        with attn_core:
            out = _prefill_core(q, k, v)
        new_cache = None
    else:
        idx = int(cache["len"])
        buf = cache["ckv"]
        m = tp.size if tp is not None else 1
        if idx + s > buf.shape[1] * m:
            raise ValueError(f"latent cache full: {idx} + {s} tokens > "
                             f"{buf.shape[1] * m} slots")
        new_cache = {"ckv": buf, "len": idx + s}
        latent = torch.cat([c_kv, k_rope], dim=-1)
        if tp is None:
            buf[:, idx:idx + s] = latent.to(buf.dtype)
            full = buf.to(x.dtype)
            k, v = _expand_kv(p.wkv_b.w, full[..., :cfg.kv_lora],
                              full[..., cfg.kv_lora:], cfg)
            with attn_core:
                out = ref.mha_ref(q, k, v, causal=True, q_offset=idx)
        else:
            pos0 = tp.rank * buf.shape[1]
            L.write_cache(buf, latent, idx, pos0)
            w = p.wkv_b.w
            if split:
                q, = L.gather_heads([q], tp)
                w = gather_seq(w, tp, dim=1)
            full = buf.to(x.dtype)
            k, v = _expand_kv(w, full[..., :cfg.kv_lora],
                              full[..., cfg.kv_lora:], cfg)
            out = L.merged_decode(q, k, v, idx, pos0, True, tp)
            if split:
                out = L.own_heads(out, h, tp)
    out = L.dense(p.wo, out.reshape(b, s, h * dv), gather=row)
    if rows and not split:
        out = split_seq(out, tp)              # the whole layer's rows
    return out, new_cache
