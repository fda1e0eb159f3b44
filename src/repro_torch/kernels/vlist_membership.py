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

Layouts.  The scan reads one word of every row.  Row-major, those words lie
4·W bytes apart, so the card moves a 32-byte sector for each 4 useful bytes.
``word_major`` makes a copy whose storage is (W, Rp), Rp = R rounded up to
a multiple of 4, and returns it as an (R, W) view with strides (1, Rp): the
same shape, values and semantics, so every function here (and the plain
version) takes it, and a version's words are one contiguous run that the
kernel moves 16 bytes a thread.  ``layout`` names the two layouts the
kernel reads; any other raises PlanError on both devices.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .build import PlanError

DEFAULT_BR = 1024   # rows per block
# bytes of the row-major bitmap that ``word_major`` transposes a copy at a
# time: the copy reads each row's W words at once only through the L2, so
# a chunk well inside the card's 50 MB L2 is read from device memory once
WORD_MAJOR_CHUNK_BYTES = 16 << 20

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


def word_major(words: torch.Tensor) -> torch.Tensor:
    """A word-major copy of a (R, W) bitmap tensor, on its device: an
    (R, W) int32 view with strides (1, Rp) over fresh (W, Rp) storage, Rp
    = R rounded up to a multiple of 4.  Equal to ``words`` element for
    element; the Rp - R padding rows of the storage are never read.  The
    transpose is torch's strided copy, ``WORD_MAJOR_CHUNK_BYTES`` of rows
    at a time (layout preparation, made once per bitmap)."""
    words = as_words(words)
    r, w = words.shape
    storage = torch.empty((w, -(-r // 4) * 4), dtype=torch.int32,
                          device=words.device)
    step = max(4, WORD_MAJOR_CHUNK_BYTES // (4 * max(w, 1)))
    for a in range(0, r, step):
        b = min(a + step, r)
        storage[:, a:b].copy_(words[a:b].t())
    return storage[:, :r].t()


def layout(words: torch.Tensor) -> tuple[int, int]:
    """(row stride, word stride) in elements of a (R, W) bitmap tensor in a
    layout the kernel reads: row-major (``stride(1) == 1``, ``stride(0) >=
    W``, the contiguous tensor among them) or word-major (``stride(0) ==
    1``, ``stride(1) >= R``, the view ``word_major`` makes).  A tensor of
    no elements is in either.  PlanError for any other."""
    r, w = words.shape
    s0, s1 = words.stride()
    if (s1 == 1 and s0 >= w) or (s0 == 1 and s1 >= r) or not r * w:
        return s0, s1
    raise PlanError(f"bitmap strides {(s0, s1)} for shape {(r, w)} are "
                    "neither row-major nor word-major: pass a contiguous "
                    "tensor or its word_major view")


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
    ``vid`` over a (R, W) bitmap tensor, row-major or word-major, in ONE
    launch on its device."""
    words = as_words(bitmap)
    vid = check_vid(vid, words.shape[1])
    if block_r <= 0:
        raise PlanError(f"block_r must be positive, got {block_r}")
    layout(words)
    if words.device.type == "cpu":
        return membership_scan_plain(words, vid, block_r=block_r)
    if words.device.type != "cuda":
        raise PlanError(f"membership_scan runs on cuda or cpu, not "
                        f"{words.device}")
    return _launch(words, vid, block_r)


def instance(words: torch.Tensor, vid: int, block_r: int) -> str:
    """The kernel instance a launch on these operands runs, by the kernel
    library's own rule: ``vec4`` (16-byte loads and stores, 4 rows a
    thread) for a word-major run that starts 16-byte aligned with
    ``block_r % 4 == 0``, ``strided`` for every other case."""
    rs, ws = layout(words)
    fn = build.membership_instance_fn()
    return "vec4" if fn(words.data_ptr(), rs, ws, block_r, vid) else \
        "strided"


def _launch(words: torch.Tensor, vid: int, block_r: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One counted CUDA launch on a checked vid (``chip_smoke.py`` times
    the kernel through this)."""
    global LAUNCHES
    rs, ws = layout(words)
    r, w = words.shape
    mask = torch.empty(r, dtype=torch.int32, device=words.device)
    cnt = torch.empty(-(-r // block_r), dtype=torch.int32, device=words.device)
    if r == 0:
        return mask, cnt
    fn = build.membership_fn()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), mask.data_ptr(), cnt.data_ptr(), r, w, rs,
                 ws, block_r, vid, stream)
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
