"""The Mamba2 SSD chunk scan (state-space duality): for each (batch, head),
chunk by chunk,

    cum   = cumsum(dt · a)                               (Q,)
    L     = tril(exp(cum_i − cum_j))                     (Q, Q)
    y     = ((C Bᵀ) ∘ L ∘ dt_j) x + (C ∘ exp(cum)) stateᵀ  (Q, P)
    state = state · exp(cum_Q) + xᵀ (exp(cum_Q − cum) · dt ∘ B)

with the (P, N) float32 state carried from chunk to chunk.  xs is
(B, L, H, P); B and C are (B, L, N), shared by the heads; dt is (B, L, H)
after the softplus; a is (H,) float32 (``-exp(A_log)``).  xs, B, C and dt
share float32 or bfloat16; everything is float32 inside; y comes back in
xs's dtype, and the final state (B, H, P, N) in float32 beside it.

A CUDA tensor launches the hand-written kernel (``csrc/ssd_scan.cu``):
bfloat16 runs the chunk-parallel design on the tensor cores, three passes
on one stream (chunk states, state passing, chunk outputs) counted as one
launch, with the chunk states in a float32 scratch the wrapper allocates;
float32 runs one block per (batch, head) that walks its chunks with float32
FMAs.  A CPU tensor runs ``ssd_scan_plain``, the same three passes in
float32 torch, and so does a ``meta`` tensor (shape and dtype, no storage:
the dry run's ``launch.op_count`` counts it, its products keyed by xs's
dtype, which the kernel runs them in).

The contract is the TPU kernel's (``repro.kernels.ssd_scan``): L is a
multiple of the chunk ``Q = min(chunk, L)``; and the CUDA kernel's
shared-memory plan bounds P ≤ 64, N ≤ 128 and Q ≤ 1024 (every
configuration of the port is inside).  The wrapper refuses anything else
with ``PlanError`` on either device, before anything launches.
"""
from __future__ import annotations

import torch

from ..launch.op_count import plain_kernel
from . import build
from .build import PlanError

MAX_HEADDIM = 64
MAX_STATE = 128
MAX_CHUNK = 1024

# CUDA launches of ``ssd_scan`` in this process; the plain torch version
# never counts
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(xs, bmat, cmat, dt, a, chunk: int) -> int:
    """The chunk Q the scan runs at, after checking the operands meet the
    kernel's contract (PlanError otherwise)."""
    if xs.ndim != 4:
        raise PlanError(f"xs must be (B, L, H, P), got {tuple(xs.shape)}")
    b, l, h, p = xs.shape
    if bmat.ndim != 3 or bmat.shape[:2] != (b, l) or cmat.shape != bmat.shape:
        raise PlanError(f"B and C must be ({b}, {l}, N) alike, got "
                        f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    n = bmat.shape[2]
    if dt.shape != (b, l, h) or a.shape != (h,):
        raise PlanError(f"dt must be ({b}, {l}, {h}) and a ({h},), got "
                        f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if min(b, l, h, p, n, chunk) <= 0:
        raise PlanError("every dim and the chunk must be positive")
    if p > MAX_HEADDIM or n > MAX_STATE:
        raise PlanError(f"headdim {p} > {MAX_HEADDIM} or d_state {n} > "
                        f"{MAX_STATE}")
    q = min(chunk, l)
    if l % q or q > MAX_CHUNK:
        raise PlanError(f"L={l} must be a multiple of the chunk {q} "
                        f"(at most {MAX_CHUNK}; pad upstream)")
    if xs.dtype not in _DTYPES or any(t.dtype != xs.dtype
                                      for t in (bmat, cmat, dt)):
        raise PlanError(f"xs, B, C, dt must share float32 or bfloat16, got "
                        f"{xs.dtype}, {bmat.dtype}, {cmat.dtype}, {dt.dtype}")
    if a.dtype != torch.float32:
        raise PlanError(f"a must be float32, got {a.dtype}")
    if any(t.device != xs.device for t in (bmat, cmat, dt, a)):
        raise PlanError("xs, B, C, dt and a must share one device")
    return q


def _chunks(xs, bmat, cmat, dt, a, q: int):
    """The operands in float32, cut into chunks: x (B, nc, Q, H, P), B and
    C (B, nc, Q, N), dt (B, nc, Q, H), and cum = cumsum(dt · a) within each
    chunk (B, nc, Q, H)."""
    b, l, h, p = xs.shape
    n = bmat.shape[-1]
    nc = l // q
    x = xs.float().reshape(b, nc, q, h, p)
    bm = bmat.float().reshape(b, nc, q, n)
    cm = cmat.float().reshape(b, nc, q, n)
    d = dt.float().reshape(b, nc, q, h)
    cum = torch.cumsum(d * a.float(), dim=2)
    return x, bm, cm, d, cum


def chunk_states(x, bm, d, cum) -> torch.Tensor:
    """Pass 1: each chunk's own contribution to the state it hands on,
    s_c = xᵀ (exp(cum_Q − cum) · dt ∘ B), (B, nc, H, P, N) float32."""
    w = torch.exp(cum[:, :, -1:, :] - cum) * d                  # (B,nc,Q,H)
    return torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, bm, x)


def state_passing(s_c, cum) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: the state entering each chunk, S_in[c] = S before chunk c,
    with S = S · exp(cum_Q[c]) + s_c from zero; returns (S_in (B, nc, H, P,
    N), the final state (B, H, P, N))."""
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]        # (B,nc,H,1,1)
    state = torch.zeros_like(s_c[:, 0])
    s_in = torch.empty_like(s_c)
    for c in range(s_c.shape[1]):
        s_in[:, c] = state
        state = state * decay[:, c] + s_c[:, c]
    return s_in, state


def chunk_outputs(x, bm, cm, d, cum, s_in) -> torch.Tensor:
    """Pass 3: y = ((C Bᵀ) ∘ L ∘ dt_j) x + (C ∘ exp(cum)) S_inᵀ chunk by
    chunk (the (B, Q, Q, H) quadratics of one chunk are the largest
    temporaries); (B, nc, Q, H, P) float32."""
    q = x.shape[2]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(x.shape[1]):
        x1, b1, c1, d1, cum1 = x[:, c], bm[:, c], cm[:, c], d[:, c], cum[:, c]
        lmat = torch.where(mask[None, :, :, None],
                           torch.exp(cum1[:, :, None, :] - cum1[:, None, :, :]),
                           0.0)
        cb = torch.einsum("bin,bjn->bij", c1, b1)
        att = cb[..., None] * lmat * d1[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", att, x1)
        ys.append(y + torch.einsum("bin,bih,bhpn->bihp", c1, torch.exp(cum1),
                                   s_in[:, c]))
    return torch.stack(ys, dim=1)


def ssd_scan_plain(xs, bmat, cmat, dt, a, chunk: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version, in float32, as the bf16 kernel's three
    passes: chunk states, state passing, chunk outputs.  Returns (y in xs's
    dtype, final state (B, H, P, N) float32).  The CPU tests run it, and
    the card compares the kernel with it."""
    b, l, h, p = xs.shape
    x, bm, cm, d, cum = _chunks(xs, bmat, cmat, dt, a, min(chunk, l))
    s_in, state = state_passing(chunk_states(x, bm, d, cum), cum)
    y = chunk_outputs(x, bm, cm, d, cum, s_in).reshape(b, l, h, p)
    return y.to(xs.dtype), state


def ssd_scan(xs, bmat, cmat, dt, a, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, L, H, P) in xs's dtype, final state (B, H, P, N) float32) on
    xs's device, ONE launch: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU or meta tensor."""
    q = check_operands(xs, bmat, cmat, dt, a, chunk)
    if xs.device.type in ("cpu", "meta"):
        return plain_kernel(ssd_scan_plain, xs.dtype, xs, bmat, cmat, dt, a,
                            q)
    if xs.device.type != "cuda":
        raise PlanError(f"ssd_scan runs on cuda, cpu or meta, not {xs.device}")
    return _launch(*(t.contiguous() for t in (xs, bmat, cmat, dt, a)), q)


def _launch(xs, bmat, cmat, dt, a, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One counted CUDA launch on contiguous operands (``chip_smoke.py``
    times the kernel through this)."""
    global LAUNCHES
    q = check_operands(xs, bmat, cmat, dt, a, chunk)
    if not all(t.is_contiguous() for t in (xs, bmat, cmat, dt, a)):
        raise PlanError("xs, B, C, dt and a must be contiguous")
    b, l, h, p = xs.shape
    n = bmat.shape[2]
    y = torch.empty_like(xs)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xs.device)
    scratch = [None, None]            # the float32 instance needs none
    if xs.dtype == torch.bfloat16:
        scratch = [torch.empty((b, l // q, h, p, n), dtype=torch.float32,
                               device=xs.device),
                   torch.empty((b, l // q, h), dtype=torch.float32,
                               device=xs.device)]
    fn = build.ssd_fn()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = fn(xs.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 dt.data_ptr(), a.data_ptr(), y.data_ptr(), state.data_ptr(),
                 *(t.data_ptr() if t is not None else None for t in scratch),
                 b, l, h, p, n, q, _DTYPES[xs.dtype], stream)
    build.check_launch(err, "ssd_scan")
    LAUNCHES += 1
    return y, state
