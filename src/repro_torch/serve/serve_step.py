"""Serving steps: batched one-token decode against a fixed-capacity KV/state
cache, and the serving prefill (one forward, the next-token distribution
out).  The port of ``repro.serve.serve_step``: plain callables (PyTorch runs
eagerly; there is nothing to jit), run under ``torch.inference_mode``.

Each step runs on ``device`` (the card unless the caller names the CPU),
resolved when it is called: the parameters must already be there, and the
tokens are moved there.  ``device="meta"`` runs it on shapes alone, with
no storage and nothing computed (the dry run, ``launch.dryrun``).

With a mesh context ``ctx`` both steps run under ``mesh_context(ctx)``, as
the reference's do (``src/repro/serve/serve_step.py:20-39``).  Every rank
of the mesh calls them with the same global token batch and takes its
(pod, data) line's rows (every model rank of a line the same rows; a
batch of one row is every rank's), as the train step does
(``train.train_step._rank_rows``).  Parameters laid out by
``sharding.distribute(model, param_specs(cfg), mesh)`` go through the eval
step's working copy (``train.train_step.cast_and_gather_params``) on each
call; plain parameters serve a model axis of 1 as they are.  The decode's
cache is the rank's part (``models.transformer.init_cache(..., ctx=)`` or
``shard_cache``), and so are the results: the prefill returns the logits
of the rank's rows, the decode the logits of its rows and its cache.  On a
model axis above 1 the working copy holds the rank's V/m of the
vocabulary (``train.train_step.working_specs``): the prefill runs on the
sequence-sharded residual where the axis divides the prompt, and both
steps compute the rank's vocabulary columns of the next-token logits and
gather them whole over "model" (``models.transformer._head``), so that
they return (B, 1, vocab_padded) and (B, 1, vocab) as on one device, as
the reference's jitted steps return global arrays.
"""
from __future__ import annotations

import torch

from .. import trace
from ..kernels.ops import resolve_device
from ..models.transformer import (FRONTEND_INPUTS, ArchConfig, decode_step,
                                  forward)
from ..sharding import MeshContext, mesh_context
from ..train.train_step import _rank_rows, _working


def _on(device, params, t: torch.Tensor) -> torch.Tensor:
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if params.embed.device.type != dev.type:
        raise ValueError(f"parameters on {params.embed.device}, step on "
                         f"{dev}")
    return t.to(params.embed.device)


def _rows(t, ctx: MeshContext | None):
    """This rank's rows of a global batch ``t`` (all of them without a
    context or for a single row)."""
    t = torch.as_tensor(t)
    if ctx is None or t.shape[0] == 1:
        return t
    return t[_rank_rows(t.shape[0], 1, (0, 1), (ctx.dp_rank, ctx.dp_size))]


def _params(params, cfg: ArchConfig, ctx: MeshContext | None):
    return params if ctx is None else _working(params, cfg, ctx)


def _decode(work, cfg, ctx, device, tokens, cache):
    """``decode_step`` of this rank's rows' tokens on its cache, with the
    working copy ``work``."""
    tokens = _on(device, work, tokens)
    with mesh_context(ctx):
        return decode_step(work, {"tokens": tokens}, cache, cfg)


def make_serve_step(cfg: ArchConfig, ctx: MeshContext | None = None, *,
                    device=None):
    @torch.inference_mode()
    def serve_step(params, batch: dict):
        """batch = {"tokens": (B,1), "cache": <cache dict>} -> (logits
        (B, 1, vocab), cache); the cache's tensors are updated in place.
        With ``ctx``: the rank's rows of the tokens, its cache, its rows'
        logits."""
        return _decode(_params(params, cfg, ctx), cfg, ctx, device,
                       _rows(batch["tokens"], ctx), batch["cache"])
    return serve_step


def make_prefill_step(cfg: ArchConfig, ctx: MeshContext | None = None, *,
                      device=None):
    @torch.inference_mode()
    def prefill_step(params, batch: dict):
        """batch = {"tokens": (B, S)} (with "enc_embeds" for ``encdec``,
        "patch_embeds" for ``vlm``) -> logits (B, 1, vocab_padded): the lm
        head runs on the last position only.  With ``ctx`` the logits of
        the rank's rows.  A ``serve.prefill`` span (attributes ``b``,
        ``s``: the batch's shape) covers the call."""
        b, s = batch["tokens"].shape
        with trace.span("serve.prefill", b=b, s=s):
            work = _params(params, cfg, ctx)
            inputs = {k: _on(device, work, _rows(batch[k], ctx))
                      for k in ("tokens", *FRONTEND_INPUTS) if k in batch}
            with mesh_context(ctx):
                return forward(work, inputs, cfg, last_only=True)
    return prefill_step


@torch.inference_mode()
def greedy_decode(params, cfg: ArchConfig, ctx: MeshContext | None, prompt,
                  n_steps: int, cache, *, device=None):
    """Simple greedy loop: ``n_steps`` decode steps from the prompt's last
    token.  Returns (tokens (B, n_steps), cache); with ``ctx`` the prompt
    is the global batch, the cache the rank's, and the tokens its rows'."""
    work = _params(params, cfg, ctx)
    tok = _rows(prompt, ctx)[:, -1:]
    out = []
    for _ in range(n_steps):
        logits, cache = _decode(work, cfg, ctx, device, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1), cache
