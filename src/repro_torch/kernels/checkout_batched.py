"""Batched multi-version checkout: K versions, ONE kernel launch.

Data flow (the same plan as the JAX package's Pallas kernel)::

    rlists (K versions, sorted rids each)
      └─ plan_batched                       [host, vectorized numpy]
           chunks each rlist into BN-row output tiles and classifies every
           tile by measured run density:
             mode 1 — the BN rids are consecutive -> ONE contiguous run copy
             mode 0 — scattered rids           -> BN row copies
           emits (starts, mode, tile_offsets): a flat tile plan whose
           concatenation covers every requested version back to back
      └─ checkout_wave / checkout_batched   [device, ONE launch]
           CUDA tensor: the hand-written Hopper kernel
           (``csrc/checkout_wave.cu``); CPU tensor: ``checkout_wave_plain``,
           the plain torch version of the same function
      └─ split per version                  [host, zero-copy slices]
           out[k] = packed[tile_offsets[k]*BN : tile_offsets[k]*BN + n_k]

Cross-partition waves add a per-tile bound ``hi``: ``core.checkout.plan_wave``
rebases every version's local rlist by its partition's row offset inside the
device-resident superblock and promotes consecutive tail chunks to runs; a
run copy only fires when ``start + BN <= hi[t]``, so a stale plan degrades to
row gathers instead of reading past a partition segment.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build
from .checkout_gather import DEFAULT_BN

# CUDA launches of ``checkout_wave`` in this process; the plain torch
# version never counts
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class BatchedPlan:
    """Host-side gather plan for one fused multi-version checkout."""

    starts: np.ndarray        # (T*BN,) int32 — source rid per packed output row
    mode: np.ndarray          # (T,) int32 — 1 = run copy, 0 = per-row copies
    tile_offsets: np.ndarray  # (K+1,) int64 — version k owns tiles [k, k+1)
    n_rows: np.ndarray        # (K,) int64 — valid rows per version
    density: np.ndarray       # (K,) float — fraction of full-run tiles

    @property
    def n_tiles(self) -> int:
        return len(self.mode)

    def segment(self, k: int, block_n: int) -> slice:
        s = int(self.tile_offsets[k]) * block_n
        return slice(s, s + int(self.n_rows[k]))


def plan_batched(rlists, block_n: int = DEFAULT_BN,
                 density_threshold: float = 0.05) -> BatchedPlan:
    """Chunk K rlists into a flat adaptive tile plan.

    Rids are planned AS GIVEN (output row i of version k is
    data[rlists[k][i]]); run copies only fire on exactly-consecutive chunks,
    so unsorted or duplicate rids simply fall back to row copies.

    Per version, the measured run density (fraction of BN-row chunks whose
    rids are consecutive) picks the gather mode: above ``density_threshold``
    the consecutive chunks go out as single run copies; below it every chunk
    uses row copies.

    Vectorized across versions: one flat padded rid array, one diff pass,
    one segment reduction — no per-version python work (the plan runs on the
    serve host thread under the previous wave's in-flight kernel).
    ``plan_batched_loop`` keeps the per-version original as the oracle."""
    k_total = len(rlists)
    rls = [np.asarray(rl, dtype=np.int64) for rl in rlists]
    n_rows = np.fromiter((len(rl) for rl in rls), np.int64, k_total)
    t_per = -(-n_rows // block_n)
    tile_offsets = np.zeros(k_total + 1, np.int64)
    np.cumsum(t_per, out=tile_offsets[1:])
    total = int(tile_offsets[-1]) * block_n
    if total == 0:
        return BatchedPlan(starts=np.zeros(0, np.int32),
                           mode=np.zeros(0, np.int32),
                           tile_offsets=tile_offsets, n_rows=n_rows,
                           density=np.zeros(k_total, np.float64))
    # flat padded rids: init every slot to its version's LAST rid (padding
    # repeats it, so a padded tail can never appear consecutive), then
    # scatter the valid rids over the prefix of each version's segment
    last = np.fromiter((rl[-1] if len(rl) else 0 for rl in rls),
                       np.int64, k_total)
    flat = np.repeat(last, t_per * block_n)
    valid = np.concatenate([rl for rl in rls if len(rl)]) if n_rows.any() \
        else np.zeros(0, np.int64)
    row0 = np.concatenate([[0], np.cumsum(n_rows)[:-1]])
    flat_idx = np.repeat(tile_offsets[:-1] * block_n - row0, n_rows) \
        + np.arange(len(valid))
    flat[flat_idx] = valid
    chunks = flat.reshape(-1, block_n)
    # a chunk is a run iff its rids are consecutive
    runs = np.all(np.diff(chunks, axis=1) == 1, axis=1) if block_n > 1 \
        else np.ones(len(chunks), bool)
    rsum = np.concatenate([[0], np.cumsum(runs)])
    per_version = (rsum[tile_offsets[1:]]
                   - rsum[tile_offsets[:-1]]).astype(np.float64)
    density = np.divide(per_version, t_per, out=np.zeros(k_total, np.float64),
                        where=t_per > 0)
    # below-threshold versions demote every chunk to row copies
    runs &= np.repeat(density >= density_threshold, t_per)
    return BatchedPlan(starts=flat.astype(np.int32),
                       mode=runs.astype(np.int32),
                       tile_offsets=tile_offsets, n_rows=n_rows,
                       density=density)


def plan_batched_loop(rlists, block_n: int = DEFAULT_BN,
                      density_threshold: float = 0.05) -> BatchedPlan:
    """The original per-version planning loop — the oracle
    ``plan_batched``'s vectorization is tested against."""
    starts_parts: list[np.ndarray] = []
    mode_parts: list[np.ndarray] = []
    tile_offsets = np.zeros(len(rlists) + 1, np.int64)
    n_rows = np.zeros(len(rlists), np.int64)
    density = np.zeros(len(rlists), np.float64)
    for k, rl in enumerate(rlists):
        rl = np.asarray(rl, dtype=np.int64)
        n = len(rl)
        n_rows[k] = n
        t = -(-n // block_n) if n else 0
        tile_offsets[k + 1] = tile_offsets[k] + t
        if n == 0:
            continue
        pad = t * block_n - n
        padded = np.concatenate([rl, np.full(pad, rl[-1], np.int64)]) if pad \
            else rl
        chunks = padded.reshape(t, block_n)
        runs = np.all(np.diff(chunks, axis=1) == 1, axis=1) if block_n > 1 \
            else np.ones(t, bool)
        density[k] = float(runs.mean())
        if density[k] < density_threshold:
            runs = np.zeros(t, bool)
        starts_parts.append(padded.astype(np.int32))
        mode_parts.append(runs.astype(np.int32))
    starts = np.concatenate(starts_parts) if starts_parts \
        else np.zeros(0, np.int32)
    mode = np.concatenate(mode_parts) if mode_parts else np.zeros(0, np.int32)
    return BatchedPlan(starts=starts, mode=mode, tile_offsets=tile_offsets,
                       n_rows=n_rows, density=density)


def source_rows(starts: torch.Tensor, mode: torch.Tensor, hi: torch.Tensor,
                *, block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The superblock row each packed output row is copied from: ``s0 + i``
    in a run tile (``mode == 1`` and ``s0 + BN <= hi``), ``starts`` itself
    in a row tile."""
    t = mode.shape[0]
    rows = starts.reshape(t, block_n).long()
    s0 = rows[:, :1]
    run = (mode == 1) & (s0[:, 0] + block_n <= hi.long())
    run_rows = s0 + torch.arange(block_n, device=rows.device)
    return torch.where(run[:, None], run_rows, rows).reshape(-1)


def checkout_wave_plain(data: torch.Tensor, starts: torch.Tensor,
                        mode: torch.Tensor, hi: torch.Tensor, *,
                        block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The plain torch version of ``checkout_wave``: the same function as
    the kernel, written with tensor indexing.  The CPU tests run it, and the
    card compares the kernel with it."""
    return data[source_rows(starts, mode, hi, block_n=block_n)]


def _check(data, starts, mode, hi, block_n) -> None:
    if data.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {tuple(data.shape)}")
    t = mode.shape[0]
    for name, x, n in (("starts", starts, t * block_n), ("mode", mode, t),
                       ("hi", hi, t)):
        if x.dtype != torch.int32 or x.ndim != 1 or x.shape[0] != n:
            raise ValueError(f"{name} must be int32 of shape ({n},), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != data.device:
            raise ValueError(f"{name} on {x.device}, data on {data.device}")


def checkout_wave(data: torch.Tensor, starts: torch.Tensor,
                  mode: torch.Tensor, hi: torch.Tensor, *,
                  block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Execute a cross-partition ``plan_wave`` plan: ONE launch for a wave
    spanning any number of partitions.

    data:   (R, D) superblock — every partition's rows concatenated, D
            padded at superblock build so that a row is a 16-byte multiple
            (the kernel copies bytes and needs no other lane tile).
    starts: (T*block_n,) int32 superblock rids (rebased by partition offset).
    mode:   (T,) int32 per-tile gather mode (1 = run candidate).
    hi:     (T,) int32 per-tile exclusive row bound for run copies.
    Returns (T*block_n, D) packed rows on data's device.

    A CUDA tensor launches the CUDA kernel (or raises); a CPU tensor runs
    ``checkout_wave_plain``."""
    _check(data, starts, mode, hi, block_n)
    if data.device.type == "cpu":
        return checkout_wave_plain(data, starts, mode, hi, block_n=block_n)
    if data.device.type != "cuda":
        raise ValueError(f"checkout_wave runs on cuda or cpu, not "
                         f"{data.device}")
    return _launch(data, starts, mode, hi, block_n)


def _launch(data, starts, mode, hi, block_n) -> torch.Tensor:
    global LAUNCHES
    row_bytes = data.shape[1] * data.element_size()
    for name, x in (("data", data), ("starts", starts), ("mode", mode),
                    ("hi", hi)):
        if not x.is_contiguous():
            raise build.PlanError(f"{name} must be contiguous")
    if row_bytes % 16 or data.data_ptr() % 16:
        raise build.PlanError(f"rows must be 16-byte multiples and aligned "
                              f"(row_bytes={row_bytes})")
    t = mode.shape[0]
    out = torch.empty((t * block_n, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    if t == 0:
        return out
    fn = build.kernel_fn("checkout_wave")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), starts.data_ptr(), mode.data_ptr(),
                 hi.data_ptr(), out.data_ptr(), t, block_n, row_bytes,
                 stream)
    build.check_launch(err, "checkout_wave")
    LAUNCHES += 1
    return out


def checkout_batched(data: torch.Tensor, starts: torch.Tensor,
                     mode: torch.Tensor, *,
                     block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Execute a ``plan_batched`` plan: ONE launch for the whole wave.

    The single-block special case of ``checkout_wave``: ``plan_batched``
    only marks exactly-consecutive chunks as runs, so every run copy is
    in bounds by construction and the per-tile bound is the block's row
    count."""
    hi = torch.full(mode.shape, data.shape[0], dtype=torch.int32,
                    device=data.device)
    return checkout_wave(data, starts, mode, hi, block_n=block_n)
