"""Public wrappers for the kernels: device resolution, padding to the tile
multiples, and plan upload, so callers can pass ragged store shapes.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain torch version (the port's counterpart of the
JAX package's interpret mode).  Nothing falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

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
    tile ``min(block_d, max(128, D))`` and cut back after the gather.
    PlanError for a rid outside ``[0, R)``."""
    data = as_tensor(data, device)
    d = data.shape[1]
    bd = min(block_d, max(128, d))
    padded = _pad_axis(data, bd, axis=1).contiguous()
    return _cg.gather_rows(padded, rids)[:, :d]


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
    bd = min(block_d, max(128, d))
    padded = _pad_axis(_pad_axis(data, bd, axis=1), block_n, axis=0)
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
    PlanError for a vid outside the bitmap."""
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


# forward only: the reference's blockwise flash backward is training
flash_attention = _fa.flash_attention
ssd_scan = _ss.ssd_scan
build_bitmap = _vm.build_bitmap
plan_tiles = _cg.plan_tiles
plan_batched = _cb.plan_batched
