"""Flash attention (forward): ``softmax(q kᵀ / √Dqk, causal) v`` without
the (Sq, Sk) matrix ever reaching device memory.

q is (B, Sq, H, Dqk), k (B, Sk, Hkv, Dqk) and v (B, Sk, Hkv, Dv) with
0 < Dv ≤ Dqk and H a multiple of Hkv (grouped-query attention: query head
h reads kv head ``h // (H/Hkv)``).  The scale is the q·k width's, whatever
v's: latent attention (DeepSeek-V2: q·k 128 + 64, v 128) is one call.
float32 or bfloat16, float32 inside; the output is (B, Sq, H, Dv) in q's
dtype.

A CUDA tensor launches the hand-written kernel (``csrc/flash_attention.cu``:
one block per (batch·head, query tile) that walks its key tiles with the
online-softmax state on chip), in one of three instances that ``instance``
names by dtype and the two widths alone: ``"wgmma"`` (bfloat16 with
(Dqk, Dv) = (Dh, Dh), Dh a multiple of 16 up to 128, or (192, 128): wgmma
products, K/V tiles by TMA in a pipelined ring), ``"mma_sync"`` (the other
bfloat16 head dims) or ``"fma"`` (float32 on the CUDA cores).  Where no
instance takes (Dqk, Dv) as they are (a v narrower than q outside
(192, 128)), the wrapper zero-pads v to Dqk, runs the instance of
(Dqk, Dqk) and slices the output: the instance is fixed by dtype and
widths, and a failed build or launch raises ``KernelError`` all the same.
TMA reads from 16-byte boundaries, so the wrapper copies an operand that
starts off one; the wgmma instance reads a v whose rows lie evenly
further apart than Dv (``kv[..., dn:]`` of a (B, S, H, dn + Dv) tensor,
as latent attention makes it) in place, and the other instances get v
contiguous.  A CPU tensor runs
``flash_attention_plain``, the materialised softmax in float32, and so
does a ``meta`` tensor (shape and dtype, no storage: the dry run's
``launch.op_count`` counts it, its products keyed by the operands' dtype,
which the kernel runs them in).  All keep
the probabilities in float32 for ``p·v``, as the TPU kernel does (the bf16
instances carry them as a hi + lo pair of bf16 terms, 16 significant
bits); the JAX package's model code rounds them to bf16 first.  Sums run
in other orders in each, so a bf16 model agrees with the reference within
bf16's rounding, not bit for bit.

The backward (``flash_backward``, ``csrc/flash_backward.cu``) is a
kernel too where ``takes_backward`` holds: CUDA bf16 at (Dh, Dh), Dh a
multiple of 16 up to 128.  It reads the row logsumexp that
``flash_attention(..., lse=True)``'s one forward launch writes beside its
output (the wgmma instance's final row max and sum; float32, (B, H, Sq)
rows padded to ``lse_pitch(Sq)``), so that the one name covers every
forward launch, with the lse or without.  The backward's source owns its
layout (the lse's pitch, the dq workspace's size).  ``BWD_LAUNCHES``
counts its launches.

Any Sq and Sk: the kernel masks the ragged last tiles, so the port serves
every length the reference's ``forward`` serves (the TPU kernel needs
multiples of its 128-row tiles).  Dqk is at most 256, the widest the
reference sweeps.  The wrapper refuses anything else with ``PlanError`` on
either device, before anything launches.
"""
from __future__ import annotations

import functools

import torch

from ..launch.op_count import plain_kernel
from . import build
from .build import PlanError

MAX_HEAD_DIM = 256
NEG_INF = -1e30

# CUDA launches of ``flash_attention`` and of ``flash_backward`` in this
# process; the plain torch versions never count
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """PlanError unless (q, k, v) meet the kernel's contract."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise PlanError(f"q must be (B, Sq, H, Dqk), k (B, Sk, Hkv, Dqk) and "
                        f"v (B, Sk, Hkv, Dv); got {tuple(q.shape)}, "
                        f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dqk = q.shape
    if k.shape[0] != b or k.shape[3] != dqk:
        raise PlanError(f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                        f"match q {tuple(q.shape)}")
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if min(b, sq, sk, h, hkv, dqk) <= 0 or h % hkv:
        raise PlanError(f"H={h} must be a positive multiple of Hkv={hkv}, "
                        f"every dim positive")
    if not 0 < dqk <= MAX_HEAD_DIM:
        raise PlanError(f"head_dim {dqk} outside (0, {MAX_HEAD_DIM}]")
    if not 0 < dv <= dqk:
        raise PlanError(f"v's head_dim {dv} outside (0, {dqk}]: v may not "
                        f"be wider than q")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise PlanError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise PlanError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The plain torch version: the materialised softmax in float32 with the
    probabilities kept in float32, one batch row at a time (the (H, Sq, Sk)
    logits of one row are the largest temporary); (B, Sq, H, Dv).  The CPU
    tests run it, and the card compares the kernel with it."""
    b, sq, h, dqk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    mask = None
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
    rows = []
    for i in range(b):
        qg = q[i].float().reshape(sq, hkv, group, dqk)
        logits = torch.einsum("qhgd,khd->hgqk", qg, k[i].float()) * dqk ** -0.5
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("hgqk,khd->qhgd", probs, v[i].float())
        rows.append(out.reshape(sq, h, dv))
    return torch.stack(rows).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, lse: bool = False):
    """(B, Sq, H, Dv) attention output on q's device, ONE launch: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU or meta tensor.
    With ``lse``, (out, lse): where ``takes_backward`` holds, the same
    launch writes each row's natural-log logsumexp beside the output for
    the backward kernel (float32 (B, H, Sq), its rows ``lse_pitch(Sq)``
    apart); elsewhere lse is None and the backward stays plain."""
    check_operands(q, k, v)
    if q.device.type in ("cpu", "meta"):
        out = plain_kernel(flash_attention_plain, q.dtype, q, k, v, causal)
        return (out, None) if lse else out
    if q.device.type != "cuda":
        raise PlanError(f"flash_attention runs on cuda, cpu or meta, not "
                        f"{q.device}")
    rows = None
    if lse and takes_backward(q, k, v):
        b, sq, h, _ = q.shape
        rows = torch.empty((b, h, lse_pitch(sq)), dtype=torch.float32,
                           device=q.device)
    dv = v.shape[3]
    code, padded = _plan(q, v)
    if padded:
        # no instance takes this v as it is: zero-padded to q's width
        v = torch.nn.functional.pad(v, (0, q.shape[3] - dv))
    v = _v_operand(v) if INSTANCES[code] == "wgmma" else _aligned(v)
    out = _launch(_aligned(q), _aligned(k), v, causal, rows)
    out = out[..., :dv] if padded else out
    if not lse:
        return out
    return out, None if rows is None else rows[..., :q.shape[1]]


def lse_pitch(sq: int) -> int:
    """The row pitch of the (B, H, Sq) float32 lse and delta, as the
    backward's library gives it (``flash_backward_lse_pitch``: each row
    starts on 16 bytes, as TMA reads it)."""
    return build.flash_bwd_layout_fns()[0](sq)


def takes_backward(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> bool:
    """Whether ``flash_backward`` takes these operands: CUDA tensors in
    bfloat16 at widths the backward kernel takes (its library's
    ``flash_backward_instance``: (Dh, Dh), Dh a multiple of 16 up to 128).
    Everything else keeps the plain backward, on the card too."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and _bwd_widths(q.shape[3], v.shape[3], _DTYPES[q.dtype]))


@functools.lru_cache(maxsize=None)
def _bwd_widths(dqk: int, dv: int, dt: int) -> bool:
    return bool(build.flash_bwd_instance_fn()(dqk, dv, dt))


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                   causal: bool = True):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) with output ``o``
    and cotangent ``do``, in ONE counted launch of the backward kernel
    (``csrc/flash_backward.cu``: delta, the products, dq's conversion),
    from the lse ``flash_attention(..., lse=True)`` wrote.  The outputs
    and the float32 workspace and delta are allocated here, at the sizes
    the library gives; nothing else runs in torch.  For operands
    ``takes_backward`` accepts."""
    global BWD_LAUNCHES
    check_operands(q, k, v)
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if not takes_backward(q, k, v) or o.shape != q.shape \
            or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or lse.shape != (b, h, sq) \
            or lse.dtype != torch.float32 \
            or lse.stride() != (h * lse_pitch(sq), lse_pitch(sq), 1):
        raise PlanError(f"flash_backward takes CUDA bf16 (Dh, Dh) operands, "
                        f"o and do of q's shape and dtype and the lse "
                        f"flash_attention wrote; got q {tuple(q.shape)} "
                        f"{q.dtype}, o {tuple(o.shape)}, do "
                        f"{tuple(do.shape)}, lse {tuple(lse.shape)} "
                        f"{lse.dtype}")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty(build.flash_bwd_layout_fns()[1](b, h, sq, dh),
                     dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, lse_pitch(sq)), dtype=torch.float32,
                        device=q.device)
    fn = build.flash_bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), ws.data_ptr(), delta.data_ptr(), b, sq, sk, h,
                 hkv, dh, int(causal), stream)
    build.check_launch(err, "flash_backward")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary: a view that
    starts off one is copied into a fresh allocation."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def v_pitch(v: torch.Tensor) -> int | None:
    """The elements between one (position, head) row of v and the next, if
    v's rows lie evenly that far apart with unit column stride (a
    contiguous v: Dv; the view ``kv[..., dn:]``: kv's row), else None."""
    b, sk, hkv, dv = v.shape
    if v.is_contiguous():
        return dv
    ld = v.stride(2)
    if (v.stride(3) == 1 and ld >= dv and v.stride(1) == hkv * ld
            and v.stride(0) == sk * hkv * ld):
        return ld
    return None


def _v_operand(v: torch.Tensor) -> torch.Tensor:
    """v as the wgmma instance reads it: a view with evenly spaced rows, a
    pitch of 16 bytes' multiple and a start on 16 bytes is read in place;
    anything else is copied as ``_aligned`` copies (the other instances
    take a contiguous v)."""
    ld = v_pitch(v)
    if ld is not None and (ld * v.element_size()) % 16 == 0 \
            and v.data_ptr() % 16 == 0:
        return v
    return _aligned(v)


INSTANCES = {0: "fma", 1: "mma_sync", 2: "wgmma"}


def _plan(q: torch.Tensor, v: torch.Tensor) -> tuple:
    """(the instance code a launch runs, whether v is zero-padded to q's
    width first), by the kernel library's own rule (``instance_of``):
    where no instance takes (Dqk, Dv) as they are, the (Dqk, Dqk) one."""
    return _plan_widths(q.shape[3], v.shape[3], _DTYPES[q.dtype])


@functools.lru_cache(maxsize=None)
def _plan_widths(dqk: int, dv: int, dt: int) -> tuple:
    """``_plan`` by widths and dtype code, asked of the library once for
    each (a launch makes no ctypes call for it after the first)."""
    fn = build.flash_instance_fn()
    code = fn(dqk, dv, dt)
    if code >= 0:
        return code, False
    return fn(dqk, dqk, dt), True


def instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The CUDA instance a launch on these operands runs, by the kernel
    library's own rule (``instance_of`` in the source: dtype, Dqk and
    Dv)."""
    check_operands(q, k, v)
    return INSTANCES[_plan(q, v)[0]]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, lse: torch.Tensor | None = None) -> torch.Tensor:
    """One counted CUDA launch on contiguous (B, S, H, Dqk) q and k and a v
    with evenly spaced rows (``v_pitch``; contiguous but for the wgmma
    instance, or the entry point refuses it), all starting on 16-byte
    boundaries, at widths an instance takes as they are (``chip_smoke.py``
    times the kernel through this).  A float32 (B, H, lse_pitch(Sq))
    ``lse`` gets the rows' logsumexp (the wgmma instance alone writes it;
    the entry point refuses it for another)."""
    global LAUNCHES
    check_operands(q, k, v)
    ld = v_pitch(v)
    if not (all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k))
            and ld is not None and v.data_ptr() % 16 == 0):
        raise PlanError("q, k must be contiguous (B, S, H, Dqk), v's rows "
                        "evenly spaced, all starting on 16-byte boundaries")
    b, sq, h, dqk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    fn = build.flash_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, sq, sk, h, hkv, dqk, dv, ld, int(causal),
                 _DTYPES[q.dtype], stream)
    build.check_launch(err, "flash_attention")
    LAUNCHES += 1
    return out
