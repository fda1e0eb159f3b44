"""Public wrappers for the kernels: device resolution, padding to the tile
multiples, and plan upload, so callers can pass ragged store shapes.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain torch version (the port's counterpart of the
JAX package's interpret mode).  Nothing falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..launch.op_count import attn_core, replay
from . import build as _build
from . import checkout_batched as _cb
from . import checkout_gather as _cg
from . import flash_attention as _fa
from . import segment_append as _sa
from . import segment_move as _sm
from . import ssd_scan as _ss
from . import version_agg as _va
from . import vlist_membership as _vm


def _on_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    the CPU.  Raises when CUDA is asked for (explicitly or by default) and
    there is none — no silent CPU run."""
    if device is None:
        if not _on_cuda():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run the kernels' plain torch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not _on_cuda():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def as_tensor(data, device=None) -> torch.Tensor:
    """``data`` as a torch tensor on the resolved device (a tensor keeps its
    own device unless ``device`` names another)."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(resolve_device(device))
    host = torch.from_numpy(np.ascontiguousarray(data))
    return host.to(resolve_device(device))


def _pad_axis(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _lane_pad(data: torch.Tensor, block_d: int) -> torch.Tensor:
    """``data`` with D padded to the lane tile ``min(block_d, max(128,
    D))``, as the JAX package pads, and then to a whole number of 16-byte
    words a row, which the CUDA gathers copy in (a D of 257 int32 becomes
    260; the callers cut the output back to D)."""
    d = data.shape[1]
    padded = _pad_axis(data, min(block_d, max(128, d)), axis=1)
    return _pad_axis(padded, max(1, 16 // data.element_size()), axis=1)


def _validate_rlist(rids, *, sort: bool = True
                    ) -> tuple[np.ndarray, np.ndarray | None]:
    """Entry-point rlist validation for the tiled/batched checkout paths.

    Returns (sorted_rids, order) where ``order`` is the stable argsort
    applied (None when already sorted).  Duplicates are a caller bug — a
    version is a SET of records — and raise a clear error."""
    rids = np.asarray(rids)
    if rids.ndim != 1:
        raise ValueError(f"rlist must be 1-D, got shape {rids.shape}")
    order = None
    if len(rids) > 1 and np.any(np.diff(rids) < 0):
        if not sort:
            raise ValueError("rlist must be sorted")
        order = np.argsort(rids, kind="stable")
        rids = rids[order]
    if len(rids) > 1 and np.any(np.diff(rids) == 0):
        raise ValueError(
            "rlist contains duplicate rids — a version is a set of records; "
            "deduplicate (np.unique) before checkout")
    return rids, order


def _upload_plan(device: torch.device, *arrays) -> list[torch.Tensor]:
    """The plan arrays as int32 tensors on ``device``: ONE host->device copy
    of their concatenation, split into views."""
    arrays = [np.asarray(a, np.int32).reshape(-1) for a in arrays]
    buf = torch.from_numpy(np.concatenate(arrays)).to(device)
    return list(torch.split(buf, [len(a) for a in arrays]))


def checkout_gather(data, rids, *, block_d: int = _cg.DEFAULT_BD,
                    device=None) -> torch.Tensor:
    """Materialize a version: the rows of ``data`` named by ``rids`` (any
    order), in ONE ``gather_rows`` launch on ``data``'s device (a numpy
    ``data`` is uploaded to ``device`` first).  D is padded to the lane
    tile ``min(block_d, max(128, D))`` and to 16-byte rows (``_lane_pad``)
    and cut back after the gather.  PlanError for a rid outside
    ``[0, R)``."""
    data = as_tensor(data, device)
    d = data.shape[1]
    return _cg.gather_rows(_lane_pad(data, block_d).contiguous(), rids)[:, :d]


def checkout_gather_tiled(data, rids, *, block_n: int = _cg.DEFAULT_BN,
                          block_d: int = _cg.DEFAULT_BD, device=None):
    """Ranged/tiled checkout for sorted rlists: the BN-row tiles the rlist
    touches, in ONE ``gather_row_tiles`` launch on ``data``'s device.

    Accepts unsorted (but duplicate-free) rlists: sorted here, and ``perm``
    is composed so packed_rows[perm] == data[rids] for the rids AS GIVEN.
    The rlist is validated on the host before anything is uploaded
    (ValueError for duplicates, PlanError for a rid outside ``[0, R)``).

    Returns (packed_rows tensor, perm, waste) — packed_rows[perm] ==
    data[rids]."""
    rids_sorted, order = _validate_rlist(rids)
    _cg.check_indices(rids_sorted, data.shape[0], "rid")
    tiles, perm, waste = _cg.plan_tiles(rids_sorted, block_n=block_n)
    if order is not None:   # packed[perm][i] == data[rids_sorted[i]]
        unsorted_perm = np.empty_like(perm)
        unsorted_perm[order] = perm
        perm = unsorted_perm
    data = as_tensor(data, device)
    d = data.shape[1]
    padded = _pad_axis(_lane_pad(data, block_d), block_n, axis=0)
    out = _cg.gather_row_tiles(padded.contiguous(), tiles, block_n=block_n)
    return out[:, :d], perm, waste


def checkout_batched(data, rlists, *, block_n: int = _cg.DEFAULT_BN,
                     block_d: int = _cg.DEFAULT_BD,
                     density_threshold: float = 0.05, device=None):
    """Fused multi-version checkout: K rlists, ONE launch.

    Plans the concatenation of the rlists with ``plan_batched`` — per-tile
    run copies where the rlist is dense, row copies where it is scattered —
    executes the whole wave in a single launch on ``data``'s device (a numpy
    ``data`` is moved to ``device`` first), and splits the packed output back
    into per-version numpy blocks.  Row k's block is data[rlists[k]] exactly.

    Returns (list of (n_k, D) arrays in request order, BatchedPlan)."""
    data = as_tensor(data, device)
    rls = []
    for rl in rlists:
        rl = np.asarray(rl)
        if rl.ndim != 1:
            raise ValueError(f"rlist must be 1-D, got shape {rl.shape}")
        rls.append(rl)
    plan = _cb.plan_batched(rls, block_n=block_n,
                            density_threshold=density_threshold)
    d = data.shape[1]
    if plan.n_tiles == 0:
        empty = torch.empty((0, d), dtype=data.dtype).numpy()
        return [empty for _ in rls], plan
    bd = min(block_d, max(128, d))
    padded = _pad_axis(data, bd, axis=1)
    if padded.shape[0] < block_n:
        # runs only fire on consecutive REAL rids, so the pad rows that make
        # the block one row tile tall are never addressed
        padded = _pad_axis(padded, block_n, axis=0)
    starts, mode = _upload_plan(padded.device, plan.starts, plan.mode)
    packed = _cb.checkout_batched(padded.contiguous(), starts, mode,
                                  block_n=block_n)
    packed = packed.cpu().numpy()[:, :d]
    return [packed[plan.segment(k, block_n)] for k in range(len(rls))], plan


def checkout_wave(data: torch.Tensor, starts, mode, hi, *,
                  block_n: int = _cg.DEFAULT_BN,
                  block_d: int = _cg.DEFAULT_BD) -> torch.Tensor:
    """Cross-partition fused checkout: a whole multi-partition wave, ONE
    launch over a pre-padded superblock tensor.  The superblock
    (``core.checkout.build_superblock``) is already padded to the lane tile
    and BN-aligned per partition segment, so no padding happens here; this
    only uploads the plan (once per wave) and launches."""
    d = data.shape[1]
    bd = min(block_d, max(128, d))
    if d % bd:
        raise ValueError(
            f"superblock D={d} not a multiple of the lane tile {bd} — build "
            "it with core.checkout.build_superblock (which pre-pads)")
    starts, mode, hi = _upload_plan(data.device, starts, mode, hi)
    return _cb.checkout_wave(data, starts, mode, hi, block_n=block_n)


def _segment_delta(src: torch.Tensor, delta, block_n: int, bd: int,
                   what: str) -> torch.Tensor:
    """The lane-tile check both segment wrappers make, and the delta
    operand on src's device: uploaded when the host has one, else a zero
    tile allocated on the device (nothing crosses the link)."""
    d = src.shape[1]
    if d % bd:
        raise _build.PlanError(
            f"superblock D={d} not a multiple of the lane tile {bd} — "
            f"{what} (which pre-pads)")
    if delta is None:
        return src.new_zeros((block_n, d))
    return as_tensor(delta, src.device)


def segment_move(src: torch.Tensor, delta, sel, starts, *,
                 block_n: int = _cg.DEFAULT_BN,
                 block_d: int = _cg.DEFAULT_BD) -> torch.Tensor:
    """Incremental superblock migration: assemble the post-migration
    superblock in ONE launch, reusing BN-aligned tiles of the OLD
    device-resident superblock (sel 0) and pulling only changed tiles from a
    small host delta (sel 1; ``delta=None`` when every tile is reused).
    The host plan is checked, then uploaded in one copy, by the kernel
    wrapper."""
    bd = min(block_d, max(128, src.shape[1]))
    delta = _segment_delta(src, delta, block_n, bd,
                           "migrate via core.checkout.migrate_superblock")
    return _sm.segment_move(src, delta, sel, starts, block_n=block_n)


def segment_append(src: torch.Tensor, delta, sel, starts, *,
                   block_n: int = _cg.DEFAULT_BN,
                   block_d: int = _cg.DEFAULT_BD) -> torch.Tensor:
    """In-place superblock append for a commit wave: assemble the grown
    superblock in ONE launch, reusing BN-aligned tiles of the OLD
    device-resident superblock (sel 0), uploading only the new BN-aligned
    tiles from a small host delta (sel 1; ``delta=None`` when there are
    none), and zero-filling alignment-slack tiles on the device (sel 2).
    The host plan is checked, then uploaded in one copy, by the kernel
    wrapper."""
    bd = min(block_d, max(128, src.shape[1]))
    delta = _segment_delta(
        src, delta, block_n, bd,
        "extend via core.checkout.refresh_superblocks_after_commit")
    return _sa.segment_append(src, delta, sel, starts, block_n=block_n)


def as_bitmap(bitmap, device=None) -> torch.Tensor:
    """A (R, W) bitset (``build_bitmap``'s uint32 numpy, or a uint32/int32
    tensor) as the int32 word tensor the bitmap kernels take, on the
    resolved device: a numpy bitmap is viewed as int32 on the host and
    uploaded once."""
    if not isinstance(bitmap, torch.Tensor):
        bitmap = np.ascontiguousarray(bitmap)
        if bitmap.dtype not in (np.uint32, np.int32) or bitmap.ndim != 2:
            raise _build.PlanError(f"bitmap must be (R, W) uint32, got "
                                   f"{bitmap.dtype} {bitmap.shape}")
        bitmap = bitmap.view(np.int32)
    return _vm.as_words(as_tensor(bitmap, device))


def membership_scan(bitmap, vid: int, *, block_r: int = _vm.DEFAULT_BR,
                    device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask (R,) int32, per-block counts (R_pad/br,) int32) for version
    ``vid`` over the bitset vlists, ONE launch, with the JAX package's
    padding rule ``br = min(block_r, max(8, R))``: R_pad is R rounded up to
    br, and the rows past R count as zero rows (they are not copied).
    PlanError for a vid outside the bitmap.  A numpy bitmap is uploaded
    row-major, as ``as_bitmap`` does; a tensor is read in the layout it
    has.  Only a caller that holds the ``word_major`` view (made once, read
    by many scans) gets the kernel's contiguous reads."""
    words = as_bitmap(bitmap, device)
    br = min(block_r, max(8, words.shape[0]))
    return _vm.membership_scan(words, vid, block_r=br)


def version_aggregate(bitmap, values, *, block_r: int = _va.DEFAULT_BR,
                      device=None) -> torch.Tensor:
    """Per-version sums of ``values`` over the bitset vlists: the whole
    (W*32,) float32 output, of which the (n_versions,) prefix is the
    meaningful part.  Rows padded as in ``membership_scan``; the values
    are cast to float32 (on the host when they come as numpy) and uploaded
    to the bitmap's device."""
    words = as_bitmap(bitmap, device)
    if not isinstance(values, torch.Tensor):
        values = np.asarray(values, dtype=np.float32)
    values = as_tensor(values, words.device)
    br = min(block_r, max(8, words.shape[0]))
    return _va.version_aggregate(words, values, block_r=br)


# ------------------------------------------------------------------------
# the differentiable model kernels: the hand-written kernel is the forward
# on the card (the plain version on the CPU), as in the reference, whose
# Pallas kernels are forward-only and whose backward passes are jnp
# ------------------------------------------------------------------------
LSE_BLOCK_K = 512       # key block of the streamed lse and the backward


def _key_blocks(sk: int, block_k: int = LSE_BLOCK_K):
    """(start, stop) of each key block: ``block_k`` keys a block, the last
    one ragged (the reference halves the block until it divides Sk; the
    two agree wherever Sk is at most 512 or a multiple of it)."""
    return [(j, min(j + block_k, sk)) for j in range(0, sk, block_k)]


def _block_logits(qg, k_c, kpos, qpos, causal: bool) -> torch.Tensor:
    """Scaled logits of one key block in float32, (B, Sq, Hkv, G, BK),
    masked to -1e30 above the diagonal when causal."""
    dh = qg.shape[-1]
    s_c = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_c.float()) * dh ** -0.5
    if causal:
        mask = kpos[None, :] <= qpos[:, None]                    # (Sq, BK)
        s_c = s_c.masked_fill(~mask[None, :, None, None, :], _fa.NEG_INF)
    return s_c


def _row_lse(q, k, causal: bool, block_k: int = LSE_BLOCK_K) -> torch.Tensor:
    """logsumexp of the scaled (causal) logits rows, streamed over key
    blocks with a running max: (B, Sq, H) float32.  The port of the
    reference's ``_row_lse``; the logits are float32 products of the
    float32 operands, as the kernel forms them (the reference rounds a
    bf16 product to bf16 first)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, dh)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, sq, hkv, h // hkv), _fa.NEG_INF, device=q.device)
    l_run = torch.zeros_like(m)
    for j0, j1 in _key_blocks(sk, block_k):
        s_c = _block_logits(qg, k[:, j0:j1],
                            torch.arange(j0, j1, device=q.device), qpos,
                            causal)
        m_new = torch.maximum(m, s_c.amax(dim=-1))
        l_run = l_run * torch.exp(m - m_new) + \
            torch.exp(s_c - m_new[..., None]).sum(dim=-1)
        m = m_new
    return (m + torch.log(l_run.clamp_min(1e-30))).reshape(b, sq, h)


def _flash_bwd(q, k, v, o, do, causal: bool, block_k: int = LSE_BLOCK_K):
    """The reference's ``_flash_bwd_rule``: for each key block, rebuild P
    from (q, k, lse) and accumulate dq; dk and dv are that block's own.
    float32 throughout; dq, dk, dv in the inputs' dtypes.  Live memory
    O(Sq · BK)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = dh ** -0.5
    qg = q.float().reshape(b, sq, hkv, g, dh)
    dog = do.float().reshape(b, sq, hkv, g, dh)
    lseg = _row_lse(q, k, causal, block_k).reshape(b, sq, hkv, g)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b, sq, hkv, g)
    qpos = torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, hkv, g, dh), device=q.device)
    dk = torch.empty((b, sk, hkv, dh), device=q.device)
    dv = torch.empty_like(dk)
    for j0, j1 in _key_blocks(sk, block_k):
        k_c, v_c = k[:, j0:j1].float(), v[:, j0:j1].float()
        s_c = _block_logits(qg, k_c, torch.arange(j0, j1, device=q.device),
                            qpos, causal)
        p = torch.exp(s_c - lseg[..., None])             # (B,Sq,Hkv,G,BK)
        dov = torch.einsum("bqhgd,bkhd->bqhgk", dog, v_c)
        ds = p * (dov - delta[..., None]) * scale
        dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, k_c)
        dk[:, j0:j1] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg)
        dv[:, j0:j1] = torch.einsum("bqhgk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Forward: ``flash_attention``'s one launch (the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor), saving (q, k, v, o).
    Backward: ``_flash_bwd`` in plain torch, with the row lse streamed from
    (q, k) there (the reference's forward rule computes it; under remat the
    forward runs twice a step and the lse is needed once)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o = _fa.flash_attention(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with attn_core:
            return (*replay(_flash_bwd, q, k, v, o, do, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention, (B, Sq, H, Dh) on q's device: the
    kernel's forward (``kernels.flash_attention``) and the reference's
    blockwise backward.  The kernel stays the only forward on the card,
    with gradients on or off."""
    return _FlashAttention.apply(q, k, v, causal)


class _SSDScan(torch.autograd.Function):
    """Forward: ``ssd_scan``'s one launch, saving its inputs.  Backward:
    the chunk recurrence recomputed through ``models.ssd.chunk_scan`` (the
    reference's ``chunk_step``, the training math it runs under
    ``jax.checkpoint``) and differentiated by ``torch.autograd.grad``."""

    @staticmethod
    def forward(ctx, xs, bmat, cmat, dt, a, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(xs, bmat, cmat, dt, a)
        return _ss.ssd_scan(xs, bmat, cmat, dt, a, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        with attn_core:
            return (*replay(_ssd_bwd, *ctx.saved_tensors, ctx.chunk,
                            ctx.needs_input_grad[:5], dy, dstate), None)


def _ssd_bwd(xs, bmat, cmat, dt, a, chunk: int, need: tuple, dy, dstate):
    """The gradients of ``(xs, bmat, cmat, dt, a)`` (None where ``need``
    says none is wanted) from the cotangents of y and the final state:
    ``models.ssd.chunk_scan`` recomputed and differentiated."""
    from ..models.ssd import chunk_scan
    inputs = [t.detach().requires_grad_(n)
              for t, n in zip((xs, bmat, cmat, dt, a), need)]
    with torch.enable_grad():
        y, state = chunk_scan(*inputs, chunk)
    outs = [(t, g) for t, g in ((y, dy), (state, dstate)) if g is not None]
    wrt = [t for t, n in zip(inputs, need) if n]
    grads = iter(torch.autograd.grad([t for t, _ in outs], wrt,
                                     [g for _, g in outs],
                                     allow_unused=True))
    return tuple(next(grads) if n else None for n in need)


def ssd_scan(xs, bmat, cmat, dt, a, chunk: int = 256):
    """Differentiable SSD scan: (y (B, L, H, P) in xs's dtype, final state
    (B, H, P, N) float32) on xs's device from ``kernels.ssd_scan``'s one
    launch, and the chunk recurrence's backward."""
    return _SSDScan.apply(xs, bmat, cmat, dt, a, chunk)


build_bitmap = _vm.build_bitmap
word_major = _vm.word_major
plan_tiles = _cg.plan_tiles
plan_batched = _cb.plan_batched
