"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), forward
only: the port of ``repro.models.mla``.

V2-Lite geometry: no q down-projection, ``kv_lora`` 512, per head
qk_nope 128 / qk_rope 64 / v_head 128, 16 heads.  Decode caches only the
compressed latent ``ckv`` (B, Smax, kv_lora + qk_rope), updated IN PLACE
at ``len`` (a Python int; the reference returns a new array); K and V are
re-expanded from the whole latent every step, as the reference does.

The prefill's attention core (no cache) runs the flash kernel
(``kernels.ops.flash_attention``), as ``layers._sdpa_core`` sends every
full-sequence GQA core: q and k have the head dim qk_nope + qk_rope, and
v (v_head wide) is zero-padded to it and the output sliced back, so the
kernel's scale 1/√Dh is the reference's ``(qk_nope + qk_rope) ** -0.5``.
On the card the kernel launches or raises; it never falls back.  The
decode's core (one query against the cache, offset by its length) is the
reference's materialised softmax, its probabilities rounded to x's dtype
before ``p·v``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops, ref
from ..kernels.build import PlanError
from ..launch.op_count import attn_core
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


def _expand_kv(p: MLA, c_kv: torch.Tensor, k_rope: torch.Tensor,
               cfg: MLAConfig):
    """latent (B, S, kv_lora) + shared rope key (B, S, dr) -> per-head K
    (B, S, H, dn + dr), V (B, S, H, dv)."""
    b, s, _ = c_kv.shape
    h, dn = cfg.n_heads, cfg.qk_nope
    kv = L.dense(p.wkv_b, c_kv).reshape(b, s, h, dn + cfg.v_head)
    k = torch.cat([kv[..., :dn],
                   k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope)], dim=-1)
    return k, kv[..., dn:]


def _prefill_core(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal attention through the flash kernel, v zero-padded to q's
    head dim and the output sliced back."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if dv > dqk:
        raise PlanError(f"v_head {dv} wider than qk_nope + qk_rope {dqk}: "
                        "the flash kernel's scale would not be the "
                        "reference's")
    out = ops.flash_attention(q, k, F.pad(v, (0, dqk - dv)), causal=True)
    return out[..., :dv]


def mla_attention(p: MLA, x: torch.Tensor, cfg: MLAConfig,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None):
    """Returns (out, new_cache).  cache = {"ckv": (B, Smax, kv_lora + dr),
    "len": int}: the step's latents are written into ``ckv`` IN PLACE at
    ``len``, and the returned cache holds the same tensor and the new
    length."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head

    q = L.dense(p.wq, x).reshape(b, s, h, dn + dr)
    q = torch.cat([q[..., :dn], L.rope(q[..., dn:], positions,
                                       cfg.rope_theta)], dim=-1)
    ckv_full = L.dense(p.wkv_a, x)                       # (B, S, kv_lora+dr)
    c_kv = L.rms_norm(p.kv_norm, ckv_full[..., :cfg.kv_lora])
    k_rope = L.rope(ckv_full[..., None, cfg.kv_lora:], positions,
                    cfg.rope_theta)[..., 0, :]           # (B, S, dr)

    if cache is None:
        k, v = _expand_kv(p, c_kv, k_rope, cfg)
        with attn_core:
            out = _prefill_core(q, k, v)
        new_cache = None
    else:
        idx = int(cache["len"])
        buf = cache["ckv"]
        if idx + s > buf.shape[1]:
            raise ValueError(f"latent cache full: {idx} + {s} tokens > "
                             f"{buf.shape[1]} slots")
        buf[:, idx:idx + s] = torch.cat([c_kv, k_rope], dim=-1).to(buf.dtype)
        new_cache = {"ckv": buf, "len": idx + s}
        full = buf.to(x.dtype)
        k, v = _expand_kv(p, full[..., :cfg.kv_lora], full[..., cfg.kv_lora:],
                          cfg)
        with attn_core:
            out = ref.mha_ref(q, k, v, causal=True, q_offset=idx)
    return L.dense(p.wo, out.reshape(b, s, h * dv)), new_cache
