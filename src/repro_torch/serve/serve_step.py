"""Serving steps: batched one-token decode against a fixed-capacity KV/state
cache, and the serving prefill (one forward, the next-token distribution
out).  The port of ``repro.serve.serve_step``: plain callables (PyTorch runs
eagerly; there is nothing to jit), run under ``torch.inference_mode``.

Each step runs on ``device`` (the card unless the caller names the CPU),
resolved when it is called: the parameters must already be there, and the
tokens are moved there.  ``device="meta"`` runs it on shapes alone, with
no storage and nothing computed (the dry run, ``launch.dryrun``).
"""
from __future__ import annotations

import torch

from ..kernels.ops import resolve_device
from ..models.transformer import (FRONTEND_INPUTS, ArchConfig, decode_step,
                                  forward)
from ..sharding import MeshContext


def _on(device, params, t: torch.Tensor) -> torch.Tensor:
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if params.embed.device.type != dev.type:
        raise ValueError(f"parameters on {params.embed.device}, step on "
                         f"{dev}")
    return t.to(params.embed.device)


def make_serve_step(cfg: ArchConfig, ctx: MeshContext | None = None, *,
                    device=None):
    @torch.inference_mode()
    def serve_step(params, batch: dict):
        """batch = {"tokens": (B,1), "cache": <cache dict>} -> (logits
        (B, 1, vocab), cache); the cache's tensors are updated in place."""
        tokens = _on(device, params, batch["tokens"])
        return decode_step(params, {"tokens": tokens}, batch["cache"], cfg)
    return serve_step


def make_prefill_step(cfg: ArchConfig, ctx: MeshContext | None = None, *,
                      device=None):
    @torch.inference_mode()
    def prefill_step(params, batch: dict):
        """batch = {"tokens": (B, S)} (with "enc_embeds" for ``encdec``,
        "patch_embeds" for ``vlm``) -> logits (B, 1, vocab_padded): the lm
        head runs on the last position only."""
        inputs = {k: _on(device, params, batch[k])
                  for k in ("tokens", *FRONTEND_INPUTS) if k in batch}
        return forward(params, inputs, cfg, last_only=True)
    return prefill_step


def greedy_decode(params, cfg: ArchConfig, ctx: MeshContext | None, prompt,
                  n_steps: int, cache, *, device=None):
    """Simple greedy loop: ``n_steps`` decode steps from the prompt's last
    token.  Returns (tokens (B, n_steps), cache)."""
    step = make_serve_step(cfg, ctx, device=device)
    tok = prompt[:, -1:]
    out = []
    for _ in range(n_steps):
        logits, cache = step(params, {"tokens": tok, "cache": cache})
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1), cache
