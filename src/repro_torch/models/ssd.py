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
from ..launch.op_count import attn_core
from .layers import Dense, dense, param, rms_norm


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


def _split_proj(p: SSD, x: torch.Tensor, cfg: SSDConfig):
    zxbcdt = dense(p.in_proj, x)
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    return z, xbc, dt


def _causal_conv(p: SSD, xbc: torch.Tensor, cfg: SSDConfig,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv; xbc (B, L, conv_dim)."""
    w = p.conv_w.to(xbc.dtype)                  # (W, C)
    width = cfg.conv_width
    if conv_state is not None:
        buf = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        buf = F.pad(xbc, (0, 0, width - 1, 0))
    new_state = buf[:, -(width - 1):]
    out = sum(buf[:, i:i + xbc.shape[1]] * w[i] for i in range(width))
    out = out + p.conv_b.to(xbc.dtype)
    return F.silu(out), new_state


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
    (y, final_state) — final_state (B, H, P, N) float32."""
    b, l, _ = x.shape
    h, pdim, n = cfg.n_heads, cfg.headdim, cfg.d_state

    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc, _ = _causal_conv(p, xbc, cfg)
    xs = xbc[..., :cfg.d_inner].reshape(b, l, h, pdim)
    bmat = xbc[..., cfg.d_inner:cfg.d_inner + n]
    cmat = xbc[..., cfg.d_inner + n:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)                 # (B, L, H)
    a = -torch.exp(p.A_log)                                     # (H,)
    # dt reaches the scan rounded to the compute dtype, as the reference's
    # scan carries it
    with attn_core:                 # the reference's chunk_step scope
        y, h_final = ops.ssd_scan(xs, bmat, cmat, dt.to(x.dtype), a,
                                  chunk=cfg.chunk)
    y = y + p.D.to(x.dtype)[None, None, :, None] * xs
    y = y.reshape(b, l, cfg.d_inner)
    y = y * F.silu(z)
    y = rms_norm(p.norm, y)
    return dense(p.out_proj, y), h_final


def ssd_decode_step(p: SSD, x: torch.Tensor, cfg: SSDConfig, state: dict):
    """O(1) decode.  x: (B, 1, d_model); state = {"h": (B,H,P,N) f32,
    "conv": (B, W-1, conv_dim)}.  Returns (y, new state); the new state's
    tensors are new (the caller stores them)."""
    b = x.shape[0]
    h, pdim, n = cfg.n_heads, cfg.headdim, cfg.d_state
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(p, xbc, cfg, conv_state=state["conv"])
    xs = xbc[:, 0, :cfg.d_inner].reshape(b, h, pdim)
    bvec = xbc[:, 0, cfg.d_inner:cfg.d_inner + n]
    cvec = xbc[:, 0, cfg.d_inner + n:]
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)          # (B, H)
    a = -torch.exp(p.A_log)
    da = torch.exp(dt * a)                                      # (B, H)
    hs = state["h"] * da[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bvec.float(), xs.float())
    y = torch.einsum("bn,bhpn->bhp", cvec.float(), hs)
    y = y + p.D[None, :, None] * xs.float()
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(p.norm, y)
    return dense(p.out_proj, y), {"h": hs, "conv": conv_state}
