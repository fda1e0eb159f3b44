"""In-place superblock append for a commit wave: T output tiles, ONE launch.

``PartitionedCVD.commit_many`` grows the touched partitions of a superblock:
existing rows keep their bytes, new rows land at the tail of each partition
segment.  Every BN-row tile of the grown superblock comes from one of three
sources, chosen per tile by the host plan ``(sel, starts)``::

    sel[t] == 0  ->  rows [starts[t], starts[t]+BN) of the OLD superblock
                     (device to device; never crosses the host link)
    sel[t] == 1  ->  rows [starts[t], starts[t]+BN) of the small delta block
                     the host uploaded (the only bytes a commit wave sends)
    sel[t] == 2  ->  zeros (alignment slack; no source read at all)

``core.checkout.extend_superblock_after_commit`` builds the plan.  A CUDA
tensor launches the hand-written kernel (``csrc/segment_append.cu``); a CPU
tensor runs ``segment_append_plain``.  The plan is host numpy, so the
wrapper checks on the host, before the upload, that every sel 0/1 run lies
inside its source: the kernel would read past the buffer without a word.
Every refusal and failure raises ``build.PlanError`` (a ValueError) or
``build.KernelError``, which the write path never absorbs.

``segment_move`` (the migration kernel) is this kernel without sel 2 and
shares the plan checks and the plain version's row map defined here.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .build import PlanError
from .checkout_gather import DEFAULT_BN

# CUDA launches of ``segment_append`` in this process; the plain torch
# version never counts
LAUNCHES = 0


def check_plan(sel, starts, n_src: int, n_delta: int, *, block_n: int,
               pad: bool) -> tuple[np.ndarray, np.ndarray]:
    """The host plan as int32 numpy arrays, after checking that it is one
    the kernel can run: ``sel`` and ``starts`` 1-D of one length, ``sel`` in
    {0, 1, 2} (``pad``) and every sel 0/1 run ``[starts[t], starts[t]+BN)``
    inside its source (``n_src`` or ``n_delta`` rows).  Without ``pad``
    (``segment_move``) any nonzero ``sel`` names the delta.  Raises
    PlanError naming the first bad tile."""
    sel, starts = np.asarray(sel), np.asarray(starts)
    if sel.ndim != 1 or starts.shape != sel.shape:
        raise PlanError(f"sel and starts must be 1-D of one length, got "
                        f"{sel.shape} and {starts.shape}")
    sel = sel.astype(np.int32, copy=False)
    starts = starts.astype(np.int32, copy=False)
    if pad and len(sel) and (sel.min() < 0 or sel.max() > 2):
        t = int(np.flatnonzero((sel < 0) | (sel > 2))[0])
        raise PlanError(f"tile {t}: sel {int(sel[t])} is not 0 (src), "
                        "1 (delta) or 2 (zeros)")
    from_delta = (sel == 1) if pad else (sel != 0)
    limit = np.where(from_delta, n_delta, n_src)
    reads = (sel != 2) if pad else np.ones(len(sel), bool)
    s0 = starts.astype(np.int64)
    bad = reads & ((s0 < 0) | (s0 + block_n > limit))
    if bad.any():
        t = int(np.flatnonzero(bad)[0])
        src = "delta" if from_delta[t] else "src"
        raise PlanError(
            f"tile {t}: run [{int(s0[t])}, {int(s0[t]) + block_n}) lies "
            f"outside {src} ({int(limit[t])} rows)")
    return sel, starts


def source_rows(sel: torch.Tensor, starts: torch.Tensor, n_src: int,
                n_delta: int, *, block_n: int, pad: bool) -> torch.Tensor:
    """Each output row's row in ``cat([src, delta, zeros(BN)])``: the run
    ``starts[t] + i`` in src or delta, or the zero tile's row i (sel 2)."""
    sel = sel.long()
    base = starts.long()
    from_delta = (sel == 1) if pad else (sel != 0)
    base = torch.where(from_delta, n_src + base, base)
    if pad:
        base = torch.where(sel == 2, torch.full_like(base, n_src + n_delta),
                           base)
    return (base[:, None]
            + torch.arange(block_n, device=base.device)).reshape(-1)


def plain(src: torch.Tensor, delta: torch.Tensor, sel, starts, *,
          block_n: int, pad: bool) -> torch.Tensor:
    """The tile copy written with ``torch.cat`` and indexing."""
    rows = source_rows(torch.as_tensor(sel, device=src.device),
                       torch.as_tensor(starts, device=src.device),
                       src.shape[0], delta.shape[0], block_n=block_n, pad=pad)
    zeros = src.new_zeros((block_n, src.shape[1]))
    return torch.cat([src, delta, zeros])[rows]


def segment_append_plain(src: torch.Tensor, delta: torch.Tensor, sel,
                         starts, *, block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The plain torch version of ``segment_append``: the same function
    as the kernel.  The CPU tests run it, and the card compares the kernel
    with it."""
    return plain(src, delta, sel, starts, block_n=block_n, pad=True)


def check_sources(src: torch.Tensor, delta: torch.Tensor) -> None:
    if src.ndim != 2 or delta.ndim != 2 or src.shape[1] != delta.shape[1]:
        raise PlanError(f"src {tuple(src.shape)} and delta "
                        f"{tuple(delta.shape)} must be 2-D of one width")
    if src.dtype != delta.dtype or src.device != delta.device:
        raise PlanError(f"src ({src.dtype}, {src.device}) and delta "
                        f"({delta.dtype}, {delta.device}) differ")
    if src.device.type not in ("cuda", "cpu"):
        raise PlanError(f"segment kernels run on cuda or cpu, not "
                        f"{src.device}")


def upload(device: torch.device, sel: np.ndarray, starts: np.ndarray
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The checked plan on ``device``: ONE host->device copy of its
    concatenation, split into views."""
    buf = torch.from_numpy(np.concatenate([sel, starts])).to(device)
    return buf[:len(sel)], buf[len(sel):]


def segment_append(src: torch.Tensor, delta: torch.Tensor, sel, starts, *,
                   block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Extend a superblock in place: T output tiles, ONE launch.

    src:    (R_old, D) the pre-commit superblock.
    delta:  (R_delta, D) the new rows, BN-tile packed, on src's device.
    sel:    (T,) host plan (numpy or CPU tensor): 0 = src, 1 = delta,
            2 = zeros.
    starts: (T,) host plan: the first source row of each tile (ignored for
            sel 2).
    Returns (T*block_n, D) on src's device.  The plan is checked on the host
    (PlanError on a run outside its source), then uploaded in one copy.  A
    CUDA tensor launches the CUDA kernel (or raises); a CPU tensor runs
    ``segment_append_plain``."""
    check_sources(src, delta)
    sel, starts = check_plan(sel, starts, src.shape[0], delta.shape[0],
                             block_n=block_n, pad=True)
    sel_d, starts_d = upload(src.device, sel, starts)
    if src.device.type == "cpu":
        return segment_append_plain(src, delta, sel_d, starts_d,
                                    block_n=block_n)
    return _launch(src, delta, sel_d, starts_d, block_n)


def launch(name: str, src, delta, sel, starts, block_n: int) -> torch.Tensor:
    """Launch kernel ``name`` on a device plan already checked by
    ``check_plan``.  Raises PlanError on what the kernel does not take and
    KernelError when the launch fails."""
    row_bytes = src.shape[1] * src.element_size()
    for what, x in (("src", src), ("delta", delta), ("sel", sel),
                    ("starts", starts)):
        if not x.is_contiguous():
            raise PlanError(f"{what} must be contiguous")
        if x.device != src.device:
            raise PlanError(f"{what} on {x.device}, src on {src.device}")
    if sel.dtype != torch.int32 or starts.dtype != torch.int32:
        raise PlanError("sel and starts must be int32")
    if row_bytes % 16 or src.data_ptr() % 16 or delta.data_ptr() % 16:
        raise PlanError(f"rows must be 16-byte multiples and aligned "
                        f"(row_bytes={row_bytes})")
    t = sel.shape[0]
    out = torch.empty((t * block_n, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if t == 0:
        return out
    fn = build.kernel_fn(name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), delta.data_ptr(), sel.data_ptr(),
                 starts.data_ptr(), out.data_ptr(), t, block_n, row_bytes,
                 stream)
    build.check_launch(err, name)
    return out


def _launch(src, delta, sel, starts, block_n: int) -> torch.Tensor:
    """One counted CUDA launch on a device plan that ``check_plan`` passed
    (``chip_smoke.py`` times the kernel through this)."""
    global LAUNCHES
    out = launch("segment_append", src, delta, sel, starts, block_n)
    LAUNCHES += 1
    return out
