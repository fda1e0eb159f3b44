"""Version-membership bitmap scan — the paper's ``ARRAY[v] <@ vlist``
containment scan (combined-table / split-by-vlist checkout, Table 1) and
version-predicate queries, over bitset vlists.

Representation: ``bitmap`` is (R, W) 32-bit words with W = ceil(n_versions
/ 32); bit v % 32 of word v // 32 is set iff record r is in version v
(``build_bitmap``).  Torch has no shift on ``uint32``, so the port keeps the
words in an int32 tensor (the same bits; ``as_words`` views a ``uint32``
tensor so) and the kernels read them as ``uint32_t``.  ``(x >> b) & 1`` is
the right bit for every b in 0..31 under the arithmetic shift too.

``membership_scan`` emits a per-row 0/1 mask for one version and a per-block
popcount of BR rows each.  A CUDA tensor launches the hand-written kernel
(``csrc/membership_scan.cu``); a CPU tensor runs ``membership_scan_plain``.
Rows past R count as zero rows, so the counts equal the reference's on a
bitmap zero-padded to a multiple of BR without the bitmap being copied.
The wrapper checks ``0 <= vid < 32 * W`` on the host (PlanError).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .build import PlanError

DEFAULT_BR = 1024   # rows per block

# CUDA launches of ``membership_scan`` in this process; the plain torch
# version never counts
LAUNCHES = 0


def as_words(bitmap: torch.Tensor) -> torch.Tensor:
    """A (R, W) bitmap tensor of 32-bit words as int32 (a ``uint32``
    tensor is viewed, not copied); PlanError for anything else."""
    if not isinstance(bitmap, torch.Tensor) or bitmap.ndim != 2:
        raise PlanError("bitmap must be a 2-D tensor of 32-bit words")
    if bitmap.dtype == torch.uint32:
        return bitmap.view(torch.int32)
    if bitmap.dtype != torch.int32:
        raise PlanError(f"bitmap words must be uint32 or int32, not "
                        f"{bitmap.dtype}")
    return bitmap


def check_vid(vid, n_words: int) -> int:
    vid = int(vid)
    if not 0 <= vid < 32 * n_words:
        raise PlanError(f"vid {vid} lies outside the bitmap's "
                        f"{32 * n_words} version bits")
    return vid


def membership_scan_plain(bitmap: torch.Tensor, vid: int, *,
                          block_r: int = DEFAULT_BR
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of ``membership_scan``."""
    words = as_words(bitmap)
    r = words.shape[0]
    mask = (words[:, vid // 32] >> (vid % 32)) & 1
    n_blocks = -(-r // block_r)
    padded = torch.cat([mask, mask.new_zeros(n_blocks * block_r - r)])
    cnt = padded.reshape(n_blocks, block_r).sum(dim=1, dtype=torch.int32)
    return mask, cnt


def membership_scan(bitmap: torch.Tensor, vid: int, *,
                    block_r: int = DEFAULT_BR
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask (R,) int32, per-block counts (ceil(R/BR),) int32) for version
    ``vid`` over a (R, W) bitmap tensor, in ONE launch on its device."""
    words = as_words(bitmap)
    vid = check_vid(vid, words.shape[1])
    if block_r <= 0:
        raise PlanError(f"block_r must be positive, got {block_r}")
    if words.device.type == "cpu":
        return membership_scan_plain(words, vid, block_r=block_r)
    if words.device.type != "cuda":
        raise PlanError(f"membership_scan runs on cuda or cpu, not "
                        f"{words.device}")
    return _launch(words, vid, block_r)


def _launch(words: torch.Tensor, vid: int, block_r: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One counted CUDA launch on a checked vid (``chip_smoke.py`` times
    the kernel through this)."""
    global LAUNCHES
    if not words.is_contiguous():
        raise PlanError("bitmap must be contiguous")
    r, w = words.shape
    mask = torch.empty(r, dtype=torch.int32, device=words.device)
    cnt = torch.empty(-(-r // block_r), dtype=torch.int32, device=words.device)
    if r == 0:
        return mask, cnt
    fn = build.bitmap_fn("membership_scan")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), None, mask.data_ptr(), cnt.data_ptr(), r,
                 w, block_r, vid, stream)
    build.check_launch(err, "membership_scan")
    LAUNCHES += 1
    return mask, cnt


def build_bitmap(rlists, n_records: int) -> np.ndarray:
    """Host-side: CSR rlists -> (R, W) uint32 bitset (numpy)."""
    n_versions = len(rlists)
    w = (n_versions + 31) // 32
    bm = np.zeros((n_records, w), dtype=np.uint32)
    for v, rl in enumerate(rlists):
        bm[np.asarray(rl), v // 32] |= np.uint32(1 << (v % 32))
    return bm
