"""Architecture assembly, forward only: the port of
``repro.models.transformer`` for the families this slice serves.

Families:
  dense   — uniform [norm→attn→res, norm→swiglu→res] decoder stack
  ssm     — uniform [norm→SSD→res] stack (attention-free)
  hybrid  — Zamba2: groups of SSD layers + one SHARED attention+MLP block
            applied between groups (same parameters every application,
            its own KV slot each time)
``moe``, ``encdec``, ``vlm`` and latent attention (``mla``) raise
``NotImplementedError``: they wait for their slice (ROADMAP A.11).

The model is an ``nn.Module`` whose parameter names follow the reference's
tree with the stacked layer axis unrolled (``layers.3.ssd.in_proj.w`` is
row 3 of the reference's ``layers/ssd/in_proj/w``); ``models.convert``
carries a reference tree over.  The layer stacks the reference scans run as
Python loops.  The decode cache is a dict of tensors in the reference's
layout (leading layer axis); ``decode_step`` updates its tensors IN PLACE
and returns the same tensors with the new length (the reference returns
new arrays).  ``len`` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from ..kernels.ops import resolve_device
from . import layers as L
from . import ssd as SSD

SUPPORTED = ("dense", "ssm", "hybrid")


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
    mla: Optional[Any] = None     # not ported yet (ROADMAP A.11)
    moe: Optional[Any] = None     # not ported yet (ROADMAP A.11)
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
    if (cfg.family not in SUPPORTED or cfg.attn_type == "mla"
            or cfg.mla is not None or cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (attn {cfg.attn_type!r}, "
            f"moe {cfg.moe is not None}) is not ported yet; the port serves "
            f"{', '.join(SUPPORTED)} (ROADMAP A.11)")
    if cfg.family == "hybrid" and (cfg.shared_every <= 0
                                   or cfg.n_layers % cfg.shared_every):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of {cfg.shared_every}")


# =============================================================== blocks ====
class AttnBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.ln1 = L.param((cfg.d_model,), g, dev, fill=1.0)
        self.ln2 = L.param((cfg.d_model,), g, dev, fill=1.0)
        self.attn = L.Attention(cfg.attn_cfg(), g, dev)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, g, dev)


class SSDBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        self.ln = L.param((cfg.d_model,), generator, device, fill=1.0)
        self.ssd = SSD.SSD(cfg.ssd, generator, device)


def _attn_block_apply(p: AttnBlock, x, cfg: ArchConfig, positions=None,
                      cache=None, causal=True):
    h = L.rms_norm(p.ln1, x)
    a, cache = L.attention(p.attn, h, cfg.attn_cfg(causal=causal),
                           positions=positions, kv_cache=cache)
    x = x + a
    h = L.rms_norm(p.ln2, x)
    x = x + L.swiglu(p.mlp, h)
    return x, cache


def _ssd_block_apply(p: SSDBlock, x, cfg: ArchConfig, state=None):
    h = L.rms_norm(p.ln, x)
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
    and, for the hybrid, the shared attention block."""

    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        g, dev = generator, device
        v, d = cfg.vocab_padded, cfg.d_model
        self.embed = L.param((v, d), g, dev, scale=d ** -0.5)
        self.final_norm = L.param((d,), g, dev, fill=1.0)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.param((d, v), g, dev, scale=d ** -0.5))
        block = AttnBlock if cfg.family == "dense" else SSDBlock
        self.layers = nn.ModuleList(block(cfg, g, dev)
                                    for _ in range(cfg.n_layers))
        self.shared_block = (AttnBlock(cfg, g, dev)
                             if cfg.family == "hybrid" else None)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Model:
    """Fresh weights from the reference's distributions (dense weights
    normal · d_in^-0.5, the embedding normal · d_model^-0.5, conv weights
    normal · 0.1, norms and D ones, biases, A_log and dt_bias zeros), drawn
    from ``generator`` on its own device and placed on ``device`` (the card
    unless the caller names the CPU)."""
    return Model(cfg, generator, resolve_device(device))


def _embed(params: Model, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long()].to(L.COMPUTE_DTYPE)


def _logits(params: Model, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(params.final_norm, x)
    head = params.embed.T if params.lm_head is None else params.lm_head
    return x @ head.to(x.dtype)


def forward(params: Model, batch: dict, cfg: ArchConfig,
            last_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab_padded); with
    ``last_only`` the lm head runs on the final position only (serving
    prefill returns just the next-token distribution)."""
    check_supported(cfg)
    x = _embed(params, batch["tokens"])
    if cfg.family == "dense":
        for p in params.layers:
            x, _ = _attn_block_apply(p, x, cfg)
    elif cfg.family == "ssm":
        for p in params.layers:
            x, _ = _ssd_block_apply(p, x, cfg)
    else:                                               # hybrid
        g = cfg.shared_every
        for i, p in enumerate(params.layers):
            x, _ = _ssd_block_apply(p, x, cfg)
            if (i + 1) % g == 0:
                x, _ = _attn_block_apply(params.shared_block, x, cfg)
    if last_only:
        x = x[:, -1:, :]
    return _logits(params, x)


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
    if cfg.family == "dense":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
        return {"k": leaf(shape, bf16), "v": leaf(shape, bf16), "len": length}
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


def init_cache(cfg: ArchConfig, batch: int, max_len: int, fill_len: int = 0,
               device=None) -> dict:
    """A zeroed cache on ``device`` (the card unless the caller names the
    CPU), ``len`` = ``fill_len``."""
    dev = resolve_device(device)
    return {k: (int(fill_len) if k == "len"
                else torch.zeros(t.shape, dtype=t.dtype, device=dev))
            for k, t in init_cache_abstract(cfg, batch, max_len).items()}


def decode_step(params: Model, batch: dict, cache: dict, cfg: ArchConfig):
    """One-token decode.  batch["tokens"]: (B, 1).  Returns (logits
    (B, 1, vocab), cache): the cache's tensors are updated in place, the
    returned dict holds them and the new length."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = _embed(params, tokens)

    if cfg.family == "dense":
        pos = int(cache["len"])
        positions = torch.full((b, 1), pos, device=x.device)
        for i, p in enumerate(params.layers):
            blk = {"k": cache["k"][i], "v": cache["v"][i], "len": pos}
            x, _ = _attn_block_apply(p, x, cfg, positions=positions,
                                     cache=blk)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": pos + 1}
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
    return _logits(params, x)[..., :cfg.vocab], new_cache
