"""Per-version aggregates over bitset vlists — the cross-version analytics
of paper §2.2 ("aggregate count of protein-protein tuples with confidence
> 0.9, for each version") as a bitmap matvec:

    out[v] = Σ_r  bit(r, v) · values[r]

over the (R, W) bitmap of ``vlist_membership`` (int32 words carrying the
uint32 bits), with out of shape (32·W,) float32; mask ``values`` upstream
for a predicate, pass ones for COUNT.

A CUDA tensor launches the hand-written kernel (``csrc/version_aggregate.cu``:
the sums as a bits-times-values product on the tensor cores, each value
split exactly into three bf16 parts (``split_bf16x3``), per-chunk partials
of ``CHUNK_ROWS`` rows, then a fixed-order sum, so the result is the same
on every run); a CPU tensor runs ``version_aggregate_plain``.  The two sum
in different orders (as the JAX package's Pallas kernel and its einsum
oracle do), so float results agree within a tolerance and integer-valued
sums below 2^24 exactly; NaN and inf land where the plain version puts
them.  Rows past R count as zero rows (the reference pads to a multiple of
BR with zeros).  ``block_r`` sets the reference's summation order only:
any positive value is accepted, and the kernel chunks rows its own way.
"""
from __future__ import annotations

import torch

from . import build
from .build import PlanError
from .vlist_membership import as_words

DEFAULT_BR = 1024   # record rows per block
# record rows of the CUDA kernel's chunk, one partial sum a version each (a
# multiple of its 64-row stage; the launcher refuses others)
CHUNK_ROWS = 1024

# CUDA launches of ``version_aggregate`` in this process; the plain torch
# version never counts
LAUNCHES = 0


def version_aggregate_plain(bitmap: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``version_aggregate``: per word, the
    (R, 32) bits times the values, summed over the rows in float32 (as the
    Pallas kernel's body does; no matrix product, so no TF32 question)."""
    words = as_words(bitmap)
    vals = values.to(torch.float32)
    if words.shape[1] == 0:
        return vals.new_zeros(0)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return torch.cat([
        (((words[:, k, None] >> shifts) & 1).float() * vals[:, None]).sum(0)
        for k in range(words.shape[1])])


def split_bf16x3(values: torch.Tensor) -> tuple:
    """The kernel's exact split of float32 ``values`` into three parts,
    each exactly a bf16 (returned as float32): hi = v with its low 16 bits
    cleared, r = v - hi (exact), mid = r with its low 16 bits cleared,
    lo = bf16(r - mid).  hi + mid + lo == v bit for bit for every finite v
    with |v| >= 2^-102; a non-finite v splits as (v, 0, 0), a NaN as the
    canonical one.  Used by the tests only: the kernel splits on the
    card."""
    v = values.to(torch.float32)
    finite = torch.isfinite(v)
    hi = (v.view(torch.int32) & -65536).view(torch.float32)
    r = torch.where(finite, v - hi, torch.zeros_like(v))
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    lo = (r - mid).to(torch.bfloat16).to(torch.float32)
    hi = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), hi)
    return hi, mid, lo


def _check_values(words: torch.Tensor, values: torch.Tensor) -> None:
    r = words.shape[0]
    if not isinstance(values, torch.Tensor) or values.shape != (r,):
        raise PlanError(f"values must be a ({r},) tensor")
    if values.device != words.device:
        raise PlanError(f"values on {values.device}, bitmap on "
                        f"{words.device}")


def _check_row_major(words: torch.Tensor) -> None:
    """The kernel reads every word of a row: it takes the contiguous (R, W)
    bitmap only, and refuses the word-major view on both devices."""
    if not words.is_contiguous():
        kind = ("a word_major view" if words.stride(0) == 1
                else "a non-contiguous tensor")
        raise PlanError(f"version_aggregate reads the contiguous row-major "
                        f"(R, W) bitmap, not {kind}: pass the row-major "
                        f"tensor")


def version_aggregate(bitmap: torch.Tensor, values: torch.Tensor, *,
                      block_r: int = DEFAULT_BR) -> torch.Tensor:
    """Per-version sums (32·W,) float32 of ``values`` (R,) over a (R, W)
    bitmap tensor, on its device (the CUDA kernel's two passes).
    ``block_r`` must be positive; on the card it does not change the
    result."""
    words = as_words(bitmap)
    _check_values(words, values)
    if block_r <= 0:
        raise PlanError(f"block_r must be positive, got {block_r}")
    _check_row_major(words)
    if words.device.type == "cpu":
        return version_aggregate_plain(words, values)
    if words.device.type != "cuda":
        raise PlanError(f"version_aggregate runs on cuda or cpu, not "
                        f"{words.device}")
    return _launch(words, values.to(torch.float32).contiguous(), block_r)


def _launch(words: torch.Tensor, values: torch.Tensor,
            block_r: int) -> torch.Tensor:
    """One counted CUDA launch on float32 values (``chip_smoke.py`` times
    the kernel through this)."""
    global LAUNCHES
    _check_values(words, values)
    _check_row_major(words)
    if not values.is_contiguous():
        raise PlanError("values must be contiguous")
    if values.dtype != torch.float32:
        raise PlanError("values must be float32")
    if block_r <= 0:
        raise PlanError(f"block_r must be positive, got {block_r}")
    r, w = words.shape
    out = torch.empty(32 * w, dtype=torch.float32, device=words.device)
    if r == 0 or w == 0:
        return out.zero_()
    partials = torch.empty((-(-r // CHUNK_ROWS), 32 * w),
                           dtype=torch.float32, device=words.device)
    fn = build.bitmap_fn("version_aggregate")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), values.data_ptr(), partials.data_ptr(),
                 out.data_ptr(), r, w, CHUNK_ROWS, 0, stream)
    build.check_launch(err, "version_aggregate")
    LAUNCHES += 1
    return out
