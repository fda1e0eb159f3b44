"""Mixture-of-Experts: the port of ``repro.models.moe`` on one rank's
tokens.

The reference dispatches inside a ``shard_map`` over its mesh, once per
(pod, data) shard, its expert exchange an explicit ``all_to_all`` pair on
the "model" axis.  A model axis of size 1 (all this port runs) makes both
exchanges the identity; that computation is what is ported here, and
``forward`` and ``decode_step`` run it for every MoE block.  The data axes
need nothing more: a data-parallel train step (``train.train_step``) runs
the forward on each rank's own rows, so the capacity C is taken over a
rank's tokens, as the reference takes it over a (pod, data) shard's
(``moe.py:82-94``), and results depend on the data axis as the
reference's do:

    tokens (T, d) --route in float32, top-k, renormalise-->
      stable sort of the (token, k) slots by expert, rank within the
      expert, slots past the capacity C dropped --> buf (E, C, d)
      --the experts' SwiGLU as batched products--> (E, C, d)
      --combine through the same slots, weighted--> (T, d) (+ shared expert)

Which slots drop depends on order, so the order is the reference's: the
top-k in descending probability, ties to the lower expert (a stable
descending sort, as ``jax.lax.top_k`` orders them), and a stable sort of
the slots by expert over the slot index t·k + j.  Dropped slots land in a drop row at E
of an (E + 1, C, d) buffer that is sliced off, so no slot wraps.  The
expert products are ``torch.bmm`` (no Pallas kernel in the JAX package
either).

``moe_ffn_local`` is the reference's dense oracle (its
``transformer._moe_ffn_local``): every expert on every token, the top-k
selected, no capacity.  The tests use it; no path runs it.

Inside ``with counting_drops() as drops:`` each ``moe_ffn`` call appends
the routed slots its dispatch dropped to ``drops`` (a 0-d tensor on x's
device, so counting never waits for the device); ``drop_counts(drops)``
reads them as ints, one per call in call order.  Outside such a block
``moe_ffn`` counts nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import resolve_device
from . import layers as L

# the list of the innermost counting_drops() block, None outside any
_COUNTING = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts
    d_ff_shared: int = 0       # width of the fused shared expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


class MoE(nn.Module):
    """The reference's leaves: ``router.w`` (d, E), ``wi``/``wg`` (E, d, f),
    ``wo`` (E, f, d) and, with shared experts, ``shared`` (one SwiGLU of
    ``d_ff_shared`` or ``n_shared · d_ff_expert``)."""

    def __init__(self, cfg: MoEConfig, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        self.router = L.Dense(d, e, False, g, dev)
        self.wi = L.param((e, d, f), g, dev, scale=d ** -0.5)
        self.wg = L.param((e, d, f), g, dev, scale=d ** -0.5)
        self.wo = L.param((e, f, d), g, dev, scale=f ** -0.5)
        self.shared = (L.SwiGLU(d, cfg.d_ff_shared or f * cfg.n_shared, g, dev)
                       if cfg.n_shared else None)


def moe_param_specs(cfg: MoEConfig) -> dict:
    """Specs by ``MoE``'s parameter names (the reference's ``moe.py:67``):
    the experts sharded over the model axis (EP)."""
    p = {"router.w": (None, None),
         "wi": ("model", None, None),
         "wg": ("model", None, None),
         "wo": ("model", None, None)}
    if cfg.n_shared:
        p.update({"shared.wi.w": (None, "model"),
                  "shared.wg.w": (None, "model"),
                  "shared.wo.w": ("model", None)})
    return p


def moe_init(generator: torch.Generator, cfg: MoEConfig, device=None) -> MoE:
    """Fresh weights (normal · d_in^-0.5) drawn from ``generator``, on
    ``device`` (the card unless the caller names the CPU)."""
    return MoE(cfg, generator, resolve_device(device))


@contextlib.contextmanager
def counting_drops():
    """Yields a list to which each ``moe_ffn`` call inside the block
    appends its dropped routed slots; the enclosing block's list, if any,
    counts again after it."""
    global _COUNTING
    outer, _COUNTING = _COUNTING, []
    try:
        yield _COUNTING
    finally:
        _COUNTING = outer


def drop_counts(drops: list) -> list:
    """A ``counting_drops`` list as ints (this waits for the device)."""
    return [int(n) for n in drops]


def _capacity(t_loc: int, cfg: MoEConfig) -> int:
    c = math.ceil(t_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)   # round up to sublane multiple


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """x (T, d) -> (top_w (T, k) float32 renormalised, top_e (T, k)), the
    experts in descending probability, the lower index first among equal
    ones (``jax.lax.top_k``'s order: a stable descending sort)."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.top_k], top_e[:, :cfg.top_k]
    return top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def _dispatch(x: torch.Tensor, top_e: torch.Tensor, cfg: MoEConfig):
    """The sort-based slotting: (buf (E, C, d), order, dest_e, dest_c,
    keep), the slots in expert order; dropped slots go to row E."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(t, cfg)
    sorted_e, order = torch.sort(top_e.reshape(-1), stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device,
                                                       dtype=sorted_e.dtype))
    rank = torch.arange(t * k, device=x.device) - starts[sorted_e]
    keep = rank < c
    dest_e = torch.where(keep, sorted_e, e)                 # e = drop row
    dest_c = rank.clamp(0, c - 1)
    buf = x.new_zeros((e + 1, c, d))
    buf.index_put_((dest_e, dest_c), x[order // k])
    return buf[:e], order, dest_e, dest_c, keep


def _experts(buf: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its C rows: (E, C, d) -> (E, C, d)."""
    dt = buf.dtype
    h = F.silu(torch.bmm(buf, wg.to(dt))) * torch.bmm(buf, wi.to(dt))
    return torch.bmm(h, wo.to(dt))


def _combine(out: torch.Tensor, order, dest_e, dest_c, keep,
             top_w: torch.Tensor) -> torch.Tensor:
    """Each slot's expert output back in (token, k) order, weighted and
    summed over k: (T, d); a dropped slot gives zero."""
    e = out.shape[0]
    t, k = top_w.shape
    y_sorted = out[dest_e.clamp(max=e - 1), dest_c] * keep[:, None].to(out.dtype)
    y_flat = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    return (y_flat.reshape(t, k, -1) * top_w[..., None].to(out.dtype)).sum(1)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the routed experts through the
    capacity-bounded dispatch over all B·S tokens at once, plus the shared
    expert."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    top_w, top_e = _route(xt, p.router.w, cfg)
    buf, order, dest_e, dest_c, keep = _dispatch(xt, top_e, cfg)
    out = _experts(buf, p.wi, p.wg, p.wo)
    y = _combine(out, order, dest_e, dest_c, keep, top_w).reshape(b, s, d)
    if _COUNTING is not None:
        _COUNTING.append((~keep).sum())
    if p.shared is not None:
        y = y + L.swiglu(p.shared, x)
    return y


def moe_ffn_local(p: MoE, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The dense oracle: every expert on every token, the top-k outputs
    weighted, nothing dropped (for the tests)."""
    b, s, d = x.shape
    top_w, top_e = _route(x.reshape(b * s, d), p.router.w, cfg)
    top_w, top_e = top_w.reshape(b, s, -1), top_e.reshape(b, s, -1)
    h = torch.einsum("bsd,edf->bsef", x, p.wg.to(x.dtype))
    h = F.silu(h) * torch.einsum("bsd,edf->bsef", x, p.wi.to(x.dtype))
    out_all = torch.einsum("bsef,efd->bsed", h, p.wo.to(x.dtype))
    sel = torch.take_along_dim(out_all, top_e[..., None], dim=2)
    y = (sel * top_w[..., None].to(x.dtype)).sum(dim=2)
    if p.shared is not None:
        y = y + L.swiglu(p.shared, x)
    return y
