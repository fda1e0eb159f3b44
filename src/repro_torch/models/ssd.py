"""Mamba2 SSD block (state-space duality): the port of
``repro.models.ssd``.

Train and prefill path: the chunked SSD scan — intra-chunk quadratic term
plus the inter-chunk state recurrence — is ONE ``kernels.ops.ssd_scan``
call (the reference runs it as a ``lax.scan`` over chunks; its TPU target
runs it in the Pallas SSD kernel).  Its backward recomputes the chunks
through ``chunk_step``, the reference's training math, and differentiates
that (the reference runs ``chunk_step`` under ``jax.checkpoint``).  The
D skip term, the ``silu(z)`` gate, the RMS norm and ``out_proj`` stay
outside the kernel, as in the reference.
Decode path: the O(1) single-step state update in plain tensor code.

Under a mesh context (the train, eval and serve steps) the SSD heads split
over "model", as the reference's shard constraints on ``xs`` and ``dt``
split them (``src/repro/models/ssd.py:119-127``, ``:170``): each rank runs
``ssd_scan`` on its H/m heads with B and C whole.  Its working copy
(``train.train_step.cast_and_gather_params``) holds, of ``in_proj``, the
columns of its heads' ``z``, ``x`` and ``dt`` and the whole ``B`` and
``C`` columns (``head_columns``; the reference stores the concatenated
``[z | x B C | dt]`` columns split contiguously, which cuts across the
segments), of ``conv_w``/``conv_b`` its heads' ``x`` channels and the
whole ``B`` and ``C`` ones, and its heads' slices of ``A_log``,
``dt_bias``, ``D``, ``norm`` and ``out_proj``'s rows.  The input passes
``copy_to_tp`` (a column-parallel product) and so do the shared ``B``/``C``
columns' weights, whose gradient each rank holds a part of; the gated
norm runs over the whole ``d_inner`` through ``layers.rms_norm_split``
(the sum of squares over "model"); ``out_proj`` is row-parallel, then
``reduce_from_tp``.  On the sequence-sharded residual
(``sharding.residual_rows``) the input is the rank's S/m rows, gathered
over the sequence by ``all_gather_seq`` (whose backward sums the ranks'
parts, in place of ``copy_to_tp``), and ``out_proj``'s sums are
reduce-scattered back to the rows.  The decode keeps each rank's heads of the state
``h`` and the whole conv state on every rank: the new ``x`` row is
gathered over "model" (``gather_seq``) so that every rank's copy of the
conv state stays equal.

Geometry: d_inner = 2*d_model, headdim P, nheads H = d_inner/P, state N,
ngroups G = 1 (B/C shared across heads), conv width 4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.build import PlanError
from ..launch.op_count import attn_core
from ..sharding import (all_gather_seq, copy_to_tp, gather_seq, residual_rows,
                        tp_group)
from .layers import (Dense, cast_weight, dense, param, rms_norm,
                     rms_norm_split)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128          # N
    headdim: int = 64           # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state   # x, B, C share the conv

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads


class SSD(nn.Module):
    """The reference's ``ssd_init`` parameters, under its names."""

    def __init__(self, cfg: SSDConfig, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.in_proj = Dense(cfg.d_model, cfg.d_in_proj, False, g, dev)
        self.conv_w = param((cfg.conv_width, cfg.conv_dim), g, dev, scale=0.1)
        self.conv_b = param((cfg.conv_dim,), g, dev, fill=0.0)
        self.A_log = param((cfg.n_heads,), g, dev, fill=0.0)
        self.D = param((cfg.n_heads,), g, dev, fill=1.0)
        self.dt_bias = param((cfg.n_heads,), g, dev, fill=0.0)
        self.norm = param((cfg.d_inner,), g, dev, fill=1.0)
        self.out_proj = Dense(cfg.d_inner, cfg.d_model, False, g, dev)


def ssd_init(cfg: SSDConfig, generator: torch.Generator,
             device=None) -> SSD:
    return SSD(cfg, generator, device)


def head_columns(cfg: SSDConfig, m: int, r: int, leaf: str) -> torch.Tensor:
    """The columns of rank ``r`` of ``m`` in the working copy of
    ``in_proj.w`` (``leaf="in_proj"``: its heads' z and x, the whole B and
    C, its heads' dt) or of ``conv_w``/``conv_b`` (``leaf="conv"``: its
    heads' x channels, the whole B and C), as indices into the stored
    leaf's last dim, in that order."""
    di, n, h = cfg.d_inner // m, cfg.d_state, cfg.n_heads // m
    ar = torch.arange
    bc = ar(2 * n) + cfg.d_inner
    if leaf == "conv":
        return torch.cat([ar(di) + r * di, bc])
    return torch.cat([ar(di) + r * di, ar(di) + cfg.d_inner + r * di,
                      bc + cfg.d_inner,
                      ar(h) + 2 * cfg.d_inner + 2 * n + r * h])


def _geometry(cfg: SSDConfig):
    """(the model group or None, this rank's heads, its d_inner)."""
    tp = tp_group()
    m = tp.size if tp is not None else 1
    if cfg.n_heads % m:
        raise PlanError(f"{cfg.n_heads} SSD heads do not split over a model "
                        f"axis of {m}")
    return tp, cfg.n_heads // m, cfg.d_inner // m


def _shared(t: torch.Tensor, lo: int, hi: int, tp) -> torch.Tensor:
    """``t`` with its last-dim columns [lo, hi) (the whole B and C every
    rank holds) through ``copy_to_tp``, their gradient summed over the
    ranks that each use them for their own heads."""
    return torch.cat([t[..., :lo], copy_to_tp(t[..., lo:hi], tp),
                      t[..., hi:]], dim=-1)


def _split_proj(p: SSD, x: torch.Tensor, cfg: SSDConfig,
                gathered: bool = False):
    """(z, xBC, dt) of this rank's heads (all of them without a context);
    ``gathered``: x came through ``all_gather_seq``, whose backward sums
    the ranks' parts, so it skips ``copy_to_tp``."""
    tp, _, di = _geometry(cfg)
    if tp is None:
        zxbcdt = dense(p.in_proj, x)
    else:
        w = _shared(p.in_proj.w, 2 * di, 2 * di + 2 * cfg.d_state, tp)
        zxbcdt = (x if gathered else copy_to_tp(x, tp)) @ cast_weight(
            w, x.dtype)
    conv_dim = di + 2 * cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + conv_dim]
    dt = zxbcdt[..., di + conv_dim:]
    return z, xbc, dt


def _conv_weights(p: SSD, cfg: SSDConfig, dtype):
    tp, _, di = _geometry(cfg)
    w, b = p.conv_w, p.conv_b
    if tp is not None:
        hi = di + 2 * cfg.d_state
        w, b = _shared(w, di, hi, tp), _shared(b, di, hi, tp)
    return cast_weight(w, dtype), cast_weight(b, dtype)


def _causal_conv(p: SSD, xbc: torch.Tensor, cfg: SSDConfig,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv; xbc (B, L, conv_dim)."""
    w, bias = _conv_weights(p, cfg, xbc.dtype)          # (W, C), (C,)
    width = cfg.conv_width
    if conv_state is not None:
        buf = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        buf = F.pad(xbc, (0, 0, width - 1, 0))
    new_state = buf[:, -(width - 1):]
    out = sum(buf[:, i:i + xbc.shape[1]] * w[i] for i in range(width))
    out = out + bias
    return F.silu(out), new_state


def _gated_norm(p: SSD, y: torch.Tensor, cfg: SSDConfig) -> torch.Tensor:
    """The norm over the whole ``d_inner``: split over "model" under a
    context, whole without one."""
    tp = tp_group()
    if tp is None:
        return rms_norm(p.norm, y)
    return rms_norm_split(p.norm, y, cfg.d_inner, tp)


def chunk_step(h_prev, xs_c, b_c, c_c, dt_c, a, out_dtype):
    """One chunk of the reference's ``chunk_step``: the state entering the
    chunk ``h_prev`` (B, H, P, N) float32 and the chunk's xs (B, Q, H, P),
    B and C (B, Q, N), dt (B, Q, H) -> (the state it hands on, y (B, Q,
    H, P) in ``out_dtype``), float32 inside.  The decay matrix's upper
    triangle is masked in the exponent (``exp(-inf) = 0``), not after it,
    so that its overflow cannot reach the gradient as 0 · inf."""
    xs_c, b_c, c_c, dt_c = (t.float() for t in (xs_c, b_c, c_c, dt_c))
    q = xs_c.shape[1]
    mask = torch.ones((q, q), dtype=torch.bool, device=xs_c.device).tril()
    cum = torch.cumsum(dt_c * a, dim=1)                          # (B,Q,H)
    # intra-chunk (attention dual): L[i,j] = exp(cum_i - cum_j), i>=j
    seg = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
        ~mask[None, :, :, None], float("-inf"))
    lmat = torch.exp(seg)
    cb = torch.einsum("bin,bjn->bij", c_c, b_c)                  # (B,Q,Q)
    att = cb[..., None] * lmat * dt_c[:, None, :, :]             # (B,Q,Q,H)
    y_c = torch.einsum("bijh,bjhp->bihp", att, xs_c)
    # inter-chunk: contribution of the state entering this chunk
    y_c = y_c + torch.einsum("bin,bih,bhpn->bihp", c_c, torch.exp(cum),
                             h_prev)
    # state update: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)               # (B,Q,H)
    s_c = torch.einsum("bjh,bjn,bjhp->bhpn", decay_to_end * dt_c, b_c, xs_c)
    h_new = h_prev * torch.exp(cum[:, -1])[..., None, None] + s_c
    return h_new, y_c.to(out_dtype)


def chunk_scan(xs, bmat, cmat, dt, a, chunk: int):
    """``chunk_step`` over the chunks of ``min(chunk, L)`` from a zero
    state: (y (B, L, H, P) in xs's dtype, the final state (B, H, P, N)
    float32), differentiable by autograd.  ``kernels.ops.ssd_scan``'s
    backward runs it; the forward is the kernel."""
    b, l, h, pdim = xs.shape
    q = min(chunk, l)
    state = torch.zeros((b, h, pdim, bmat.shape[-1]), device=xs.device)
    ys = []
    for c0 in range(0, l, q):
        sl = slice(c0, c0 + q)
        state, y_c = chunk_step(state, xs[:, sl], bmat[:, sl], cmat[:, sl],
                                dt[:, sl], a, xs.dtype)
        ys.append(y_c)
    return torch.cat(ys, dim=1), state


def ssd_forward(p: SSD, x: torch.Tensor, cfg: SSDConfig):
    """Train and prefill path.  x: (B, L, d_model), L a multiple of
    ``min(chunk, L)`` (pad upstream; PlanError otherwise).  Returns
    (y, final_state) — final_state (B, H, P, N) float32.  On the
    sequence-sharded residual x and y are this rank's rows: x is gathered
    over the sequence, and ``out_proj``'s sums reduce-scattered back."""
    tp, h, di = _geometry(cfg)
    rows = residual_rows()
    if rows:
        x = all_gather_seq(x, tp)
    b, l, _ = x.shape
    pdim, n = cfg.headdim, cfg.d_state

    z, xbc, dt_raw = _split_proj(p, x, cfg, gathered=rows)
    xbc, _ = _causal_conv(p, xbc, cfg)
    xs = xbc[..., :di].reshape(b, l, h, pdim)
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)                 # (B, L, H)
    a = -torch.exp(p.A_log)                                     # (H,)
    # dt reaches the scan rounded to the compute dtype, as the reference's
    # scan carries it
    with attn_core:                 # the reference's chunk_step scope
        y, h_final = ops.ssd_scan(xs, bmat, cmat, dt.to(x.dtype), a,
                                  chunk=cfg.chunk)
    y = y + cast_weight(p.D, x.dtype)[None, None, :, None] * xs
    y = y.reshape(b, l, di)
    y = y * F.silu(z)
    return dense(p.out_proj, _gated_norm(p, y, cfg),
                 gather="scatter" if rows else "row"), h_final


def ssd_decode_step(p: SSD, x: torch.Tensor, cfg: SSDConfig, state: dict):
    """O(1) decode.  x: (B, 1, d_model); state = {"h": (B,H,P,N) f32,
    "conv": (B, W-1, conv_dim)}: under a mesh context ``h`` holds this
    rank's heads and ``conv`` every channel (the new x row is gathered over
    "model", so every rank's copy stays equal).  Returns (y, new state);
    the new state's tensors are new (the caller stores them)."""
    b = x.shape[0]
    tp, h, di = _geometry(cfg)
    pdim, n = cfg.headdim, cfg.d_state
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    if tp is None:
        xbc, conv_state = _causal_conv(p, xbc, cfg, conv_state=state["conv"])
    else:
        whole = torch.cat([gather_seq(xbc[..., :di], tp, dim=-1),
                           xbc[..., di:]], dim=-1)
        cols = head_columns(cfg, tp.size, tp.rank, "conv").to(x.device)
        conv_state = _conv_state(state["conv"], whole, cfg)
        xbc, _ = _causal_conv(p, xbc, cfg,
                              conv_state=state["conv"][..., cols])
    xs = xbc[:, 0, :di].reshape(b, h, pdim)
    bvec = xbc[:, 0, di:di + n]
    cvec = xbc[:, 0, di + n:]
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)          # (B, H)
    a = -torch.exp(p.A_log)
    da = torch.exp(dt * a)                                      # (B, H)
    hs = state["h"] * da[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bvec.float(), xs.float())
    y = torch.einsum("bn,bhpn->bhp", cvec.float(), hs)
    y = y + p.D[None, :, None] * xs.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = y * F.silu(z)
    return (dense(p.out_proj, _gated_norm(p, y, cfg), gather="row"),
            {"h": hs, "conv": conv_state})


def _conv_state(conv_state: torch.Tensor, xbc: torch.Tensor,
                cfg: SSDConfig) -> torch.Tensor:
    """The conv state ``_causal_conv`` leaves, on every channel, without
    the convolution."""
    buf = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    return buf[:, -(cfg.conv_width - 1):]
