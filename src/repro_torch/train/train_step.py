"""Training step: microbatched gradient accumulation + AdamW, the port of
``repro.train.train_step`` on one device.

The engine is versioning-UNAWARE: batches arrive as plain (tokens, labels),
numpy or tensors; the paper's machinery lives entirely in ``repro_torch.data``.
The step runs eagerly (there is nothing to jit) on the device that holds
the parameters, which must require gradients (``init_params(...,
trainable=True)``).

The reference's int8 error-feedback compression rides the cross-pod
gradient reduction, which needs a "pod" mesh axis; one card has none, so
``grad_compress=True`` gives the plain step, as the reference's does on a
host mesh.  ``quantize_int8`` and ``ef_init`` are here for that later
multi-card slice (ROADMAP A.11f), as are the reference's FSDP helpers
(``cast_and_gather_params``), which are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from ..models.transformer import FRONTEND_INPUTS, ArchConfig, Model, loss_fn
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


def _loss_and_grads(params: Model, named: dict, batch: dict,
                    cfg: ArchConfig):
    with record_function("train.forward"):
        loss = loss_fn(params, batch, cfg)
    with record_function("train.backward"):
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def accumulate_grads(params: Model, batch: dict, cfg: ArchConfig):
    """(mean loss, grads by parameter name) over ``cfg.microbatches``
    sequential microbatches (the batch's rows split in order), the
    gradients summed in float32 and scaled by 1/n, as the reference's scan
    does."""
    named = _trainable(params)
    batch = _to_device(batch, params.embed.device)
    n = cfg.microbatches
    if n <= 1:
        return _loss_and_grads(params, named, batch, cfg)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=params.embed.device)
    for i in range(n):
        rows = slice(i * (b // n), (i + 1) * (b // n))
        loss, grads = _loss_and_grads(
            params, named, {k: t[rows] for k, t in batch.items()}, cfg)
        for k, g in grads.items():
            gsum[k] += g.float()
        lsum = lsum + loss
    inv = 1.0 / n
    return lsum * inv, {k: g * inv for k, g in gsum.items()}


# ------------------------------------------------ int8 EF compression ------
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): x ≈ q · scale, |q| ≤ 127, half to even."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_init(params, npods: int) -> dict:
    """Per-pod error-feedback residuals, stacked on a leading pod axis."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else dict(params))
    return {n: torch.zeros((npods, *p.shape), dtype=torch.float32,
                           device=p.device) for n, p in named.items()}


# ----------------------------------------------------------- train step ----
def make_train_step(cfg: ArchConfig, opt: Optional[AdamW] = None,
                    grad_compress: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``grad_norm`` (before clipping) and
    ``step`` as 0-d device tensors.  The parameters and the optimizer
    state are updated in place.  ``grad_compress`` has no cross-pod hop to
    compress on one card and gives the same plain step."""
    opt = opt or AdamW()
    del grad_compress                    # one card: no "pod" axis

    def train_step(params: Model, opt_state: AdamWState, batch: dict):
        loss, grads = accumulate_grads(params, batch, cfg)
        with record_function("train.optimizer"):
            params, new_state, gnorm = opt.update(grads, opt_state, params)
        metrics = {"loss": loss.float(), "grad_norm": gnorm.float(),
                   "step": new_state.step}
        return params, new_state, metrics
    return train_step


def make_eval_step(cfg: ArchConfig):
    """Returns ``eval_step(params, batch) -> loss`` (no gradients)."""
    @torch.no_grad()
    def eval_step(params: Model, batch: dict):
        return loss_fn(params, _to_device(batch, params.embed.device), cfg)
    return eval_step
