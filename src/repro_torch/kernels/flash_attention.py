"""Flash attention (forward): ``softmax(q kᵀ / √Dh, causal) v`` without the
(Sq, Sk) matrix ever reaching device memory.

q is (B, Sq, H, Dh); k and v are (B, Sk, Hkv, Dh) with H a multiple of Hkv
(grouped-query attention: query head h reads kv head ``h // (H/Hkv)``).
float32 or bfloat16, float32 inside; the output has q's shape and dtype.

A CUDA tensor launches the hand-written kernel (``csrc/flash_attention.cu``:
one block per (batch·head, query tile) that walks its key tiles with the
online-softmax state on chip), in one of three instances that ``instance``
names by dtype and Dh alone: ``"wgmma"`` (bfloat16 with Dh a multiple of
16 up to 128: wgmma products, K/V tiles by TMA in a pipelined ring),
``"mma_sync"`` (the other bfloat16 head dims) or ``"fma"`` (float32 on the
CUDA cores).  TMA reads from 16-byte boundaries, so the wrapper copies an
operand that starts off one.  A CPU tensor runs
``flash_attention_plain``, the materialised softmax in float32.  All keep
the probabilities in float32 for ``p·v``, as the TPU kernel does (the bf16
instances carry them as a hi + lo pair of bf16 terms, 16 significant
bits); the JAX package's model code rounds them to bf16 first.  Sums run
in other orders in each, so a bf16 model agrees with the reference within
bf16's rounding, not bit for bit.

Any Sq and Sk: the kernel masks the ragged last tiles, so the port serves
every length the reference's ``forward`` serves (the TPU kernel needs
multiples of its 128-row tiles).  Dh is at most 256, the widest the
reference sweeps.  The wrapper refuses anything else with ``PlanError`` on
either device, before anything launches.
"""
from __future__ import annotations

import torch

from . import build
from .build import PlanError

MAX_HEAD_DIM = 256
NEG_INF = -1e30

# CUDA launches of ``flash_attention`` in this process; the plain torch
# version never counts
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """PlanError unless (q, k, v) meet the kernel's contract."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise PlanError(f"q must be (B, Sq, H, Dh) and k, v (B, Sk, Hkv, Dh) "
                        f"alike; got {tuple(q.shape)}, {tuple(k.shape)}, "
                        f"{tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise PlanError(f"k, v {tuple(k.shape)} do not match q "
                        f"{tuple(q.shape)}")
    sk, hkv = k.shape[1], k.shape[2]
    if min(b, sq, sk, h, hkv, dh) <= 0 or h % hkv:
        raise PlanError(f"H={h} must be a positive multiple of Hkv={hkv}, "
                        f"every dim positive")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise PlanError(f"head_dim {dh} outside (0, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise PlanError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise PlanError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The plain torch version: the materialised softmax in float32 with the
    probabilities kept in float32, one batch row at a time (the (H, Sq, Sk)
    logits of one row are the largest temporary).  The CPU tests run it, and
    the card compares the kernel with it."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    mask = None
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
    rows = []
    for i in range(b):
        qg = q[i].float().reshape(sq, hkv, group, dh)
        logits = torch.einsum("qhgd,khd->hgqk", qg, k[i].float()) * dh ** -0.5
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("hgqk,khd->qhgd", probs, v[i].float())
        rows.append(out.reshape(sq, h, dh))
    return torch.stack(rows).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, Dh) attention output on q's device, ONE launch: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    check_operands(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise PlanError(f"flash_attention runs on cuda or cpu, not "
                        f"{q.device}")
    return _launch(_aligned(q), _aligned(k), _aligned(v), causal)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary: a view that
    starts off one is copied into a fresh allocation."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


INSTANCES = {0: "fma", 1: "mma_sync", 2: "wgmma"}


def instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The CUDA instance a launch on these operands runs, by the kernel
    library's own rule (``instance_of`` in the source: dtype and Dh)."""
    check_operands(q, k, v)
    code = build.flash_instance_fn()(q.shape[3], _DTYPES[q.dtype])
    return INSTANCES[code]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """One counted CUDA launch on contiguous (B, S, H, Dh) operands that
    start on 16-byte boundaries (``chip_smoke.py`` times the kernel
    through this)."""
    global LAUNCHES
    check_operands(q, k, v)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise PlanError("q, k, v must be contiguous (B, S, H, Dh) and start "
                        "on 16-byte boundaries")
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.flash_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, hkv, dh, int(causal), _DTYPES[q.dtype], stream)
    build.check_launch(err, "flash_attention")
    LAUNCHES += 1
    return out
