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
from ..launch.op_count import attn_core

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


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


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
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        scale, x, inv = ctx.saved_tensors
        sdy = dy * scale.to(dy.dtype)
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


def _sdpa(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, Hkv, Dh) — GQA by head repetition.
    One device: no mesh is ever active (``sharding.current_ctx()`` is
    None), so this is always the single-device core."""
    return _sdpa_core(q, k, v, causal, q_offset)


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


def attention(p: Attention, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[dict] = None,
              cross_kv: Optional[tuple] = None):
    """Returns (out, new_kv_cache).  kv_cache: {"k","v": (B, Smax, Hkv,
    Dh), "len": int} for decode: the new keys and values are written into
    the cache's tensors IN PLACE at ``len`` (the reference returns new
    arrays), and the returned cache holds the same tensors and the new
    length.  cross_kv for encoder-decoder cross attention."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = dense(p.wq, x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if cross_kv is not None:
        k, v = cross_kv
        out = _sdpa(q, k, v, causal=False)
        return dense(p.wo, out.reshape(b, s, -1)), kv_cache
    k = dense(p.wk, x).reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = dense(p.wv, x).reshape(b, s, cfg.n_kv, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = _sdpa(q, k, v, causal=cfg.causal)
        new_cache = None
    else:
        idx = int(kv_cache["len"])
        ck, cv = kv_cache["k"], kv_cache["v"]
        if idx + s > ck.shape[1]:
            raise ValueError(f"KV cache full: {idx} + {s} tokens > "
                             f"{ck.shape[1]} slots")
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "len": idx + s}
        # mask out cache slots beyond len via causal mask w/ offset
        out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                    q_offset=idx)
    return dense(p.wo, out.reshape(b, s, -1)), new_cache


def cross_kv_init(p: Attention, memory: torch.Tensor, cfg: AttnConfig):
    """Precompute encoder-memory K/V once per sequence (enc-dec decode)."""
    b, sm, _ = memory.shape
    k = dense(p.wk, memory).reshape(b, sm, cfg.n_kv, cfg.head_dim)
    v = dense(p.wv, memory).reshape(b, sm, cfg.n_kv, cfg.head_dim)
    return k, v


# ------------------------------------------------------------------- mlp --
class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, generator=None, device=None):
        super().__init__()
        self.wi = Dense(d_model, d_ff, False, generator, device)
        self.wg = Dense(d_model, d_ff, False, generator, device)
        self.wo = Dense(d_ff, d_model, False, generator, device)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(p.wg, x)) * dense(p.wi, x)
    return dense(p.wo, h)
