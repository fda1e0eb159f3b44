"""Mixture-of-Experts with expert parallelism: the port of
``repro.models.moe``.

The reference dispatches inside a ``shard_map`` over its mesh, once per
(pod, data) shard, its expert exchange an explicit ``all_to_all`` pair on
the "model" axis (``moe.py:87-131``).  The port runs the same computation
on each rank's rows.  Without a mesh context (serving, the one-device
step) the exchange is the identity, as on the reference's model axis of 1.
Under one (``sharding.mesh_context``, as the train and eval steps run the
forward) the rank holds its E/m experts (``moe_param_specs``: the expert
leaves' rows over "model") and, at every model-axis size, 1 included:

* on the sequence-sharded residual (``sharding.residual_rows``, a model axis
  above 1), the block's input is already the rank's S/m rows: it routes
  them as they come, at the capacity ``_capacity(B·S/m)``, with the router
  through ``copy_to_tp``, no ``split_seq`` and no ``gather_seq``, and the
  shared expert gathers and reduce-scatters as ``layers.swiglu`` does;
* the token-parallel split (``moe.py:134-168``): when S > 1 and S % m ==
  0 on a whole residual, each model rank takes its
  S/m slice of its rows (``split_seq``) and
  routes those B·S/m tokens with the capacity ``_capacity(B·S/m)``, so
  results depend on the model axis as the reference's do; the router's
  weights are replicated but each rank routes other tokens, so they pass
  ``copy_to_tp`` (their gradient summed over "model"), and the slices come
  back through ``gather_seq`` (whose backward is a slice: the gradient of
  the whole output is the same on every rank);
* otherwise (decode, or S that does not divide) every model rank dispatches
  all its rows (``moe.py:140-143``): its buffer's rows for rank j's experts
  reach rank j from every rank, so in the backward the routed path's
  gradient is scaled by 1/m and the input and the router pass
  ``copy_to_tp``, which sums the m equal parts back to one;

then, per rank:

    tokens (T, d) --route in float32, top-k, renormalise-->
      stable sort of the (token, k) slots by expert, rank within the
      expert, slots past the capacity C dropped --> buf (E, C, d)
      --expert_exchange (split E, concat C)--> (E/m, C·m, d)
      --the local experts' SwiGLU as batched products--> (E/m, C·m, d)
      --expert_return--> (E, C, d)
      --combine through the same slots, weighted--> (T, d)

plus the shared expert, tensor-parallel as ``layers.swiglu`` (its
``wi``/``wg`` columns and ``wo`` rows over "model").  Capacity is taken
over a rank's tokens, as the reference takes it over a (pod, data, model)
shard's, so results depend on the data and model axes as the
reference's do.

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
``moe_ffn`` counts nothing.  Under a mesh context each rank counts its own
dispatch's drops: a layer's drops over the whole batch are the sum over
the batch axes and, in the token-parallel split, over "model" too (each
model rank routes other tokens); in the replicated dispatch every model
rank counts the same drops, so one rank's count is the line's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.build import PlanError
from ..kernels.ops import resolve_device
from ..sharding import (copy_to_tp, expert_exchange, expert_return,
                        gather_seq, scale_grad, residual_rows, split_seq,
                        tp_group)
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
    h = F.silu(torch.bmm(buf, L.cast_weight(wg, dt))) * torch.bmm(
        buf, L.cast_weight(wi, dt))
    return torch.bmm(h, L.cast_weight(wo, dt))


def _combine(out: torch.Tensor, order, dest_e, dest_c, keep,
             top_w: torch.Tensor) -> torch.Tensor:
    """Each slot's expert output back in (token, k) order, weighted and
    summed over k: (T, d); a dropped slot gives zero."""
    e = out.shape[0]
    t, k = top_w.shape
    y_sorted = out[dest_e.clamp(max=e - 1), dest_c] * keep[:, None].to(out.dtype)
    y_flat = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    return (y_flat.reshape(t, k, -1) * top_w[..., None].to(out.dtype)).sum(1)


def _dispatch_combine(x: torch.Tensor, router_w: torch.Tensor,
                      wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                      cfg: MoEConfig, tp=None):
    """The reference's ``_dispatch_combine`` (``moe.py:87-131``) on one
    rank's tokens x (T, d) with its local experts (wi/wg (E/m, d, f), wo
    (E/m, f, d)); ``tp`` the model axis (``sharding.tp_group``) or None
    for the one-device identity exchange.  Returns (y (T, d), keep (T·k,)
    in expert-sorted slot order)."""
    top_w, top_e = _route(x, router_w, cfg)
    buf, order, dest_e, dest_c, keep = _dispatch(x, top_e, cfg)
    if tp is not None:
        buf = expert_exchange(buf, tp)                  # (E/m, C·m, d)
    out = _experts(buf, wi, wg, wo)
    if tp is not None:
        out = expert_return(out, tp)                    # (E, C, d)
    return _combine(out, order, dest_e, dest_c, keep, top_w), keep


def moe_ffn(p: MoE, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the routed experts through the
    capacity-bounded dispatch, plus the shared expert.  Without a mesh
    context all B·S tokens at once; under one the token-parallel split or
    the replicated dispatch across "model" (the module's docstring); on
    the sequence-sharded residual x is this rank's rows, which it routes
    as they come."""
    b, s, d = x.shape
    tp = tp_group()
    if tp is None:
        y, keep = _dispatch_combine(x.reshape(b * s, d), p.router.w, p.wi,
                                    p.wg, p.wo, cfg)
        y = y.reshape(b, s, d)
    else:
        m = tp.size
        if cfg.n_experts % m or p.wi.shape[0] * m != cfg.n_experts:
            raise PlanError(f"moe: {p.wi.shape[0]} local experts are not "
                            f"1/{m} of {cfg.n_experts} (the expert leaves "
                            "are each rank's rows over the model axis)")
        router_w = copy_to_tp(p.router.w, tp)
        rows = residual_rows()                  # x is the rank's S/m rows
        if rows or (s > 1 and s % m == 0):              # token-parallel
            xs = x if rows else split_seq(x, tp)        # (B, S/m, d)
            y, keep = _dispatch_combine(xs.reshape(-1, d), router_w, p.wi,
                                        p.wg, p.wo, cfg, tp)
            y = y.reshape(xs.shape)
            if not rows:
                y = gather_seq(y, tp)
        else:                                           # replicated
            y, keep = _dispatch_combine(copy_to_tp(x, tp).reshape(b * s, d),
                                        router_w, p.wi, p.wg, p.wo, cfg, tp)
            y = scale_grad(y, 1.0 / m).reshape(b, s, d)
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
    h = torch.einsum("bsd,edf->bsef", x, L.cast_weight(p.wg, x.dtype))
    h = F.silu(h) * torch.einsum("bsd,edf->bsef", x,
                                 L.cast_weight(p.wi, x.dtype))
    out_all = torch.einsum("bsef,efd->bsed", h,
                           L.cast_weight(p.wo, x.dtype))
    sel = torch.take_along_dim(out_all, top_e[..., None], dim=2)
    y = (sel * top_w[..., None].to(x.dtype)).sum(dim=2)
    if p.shared is not None:
        y = y + L.swiglu(p.shared, x)
    return y
