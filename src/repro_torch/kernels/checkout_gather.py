"""Single-version checkout gathers, their tile constants and host planner.

``checkout v`` gathers the rows named by v's rlist out of the partition's
data block.  Two kernels, as in the JAX package:

* ``gather_rows``      — ``out[i] = data[rids[i]]`` for any rid order;
* ``gather_row_tiles`` — rlists are sorted, so ``plan_tiles`` turns one into
                         the BN-row tiles it touches and the kernel copies
                         whole tiles: ``out[t*BN + i] = data[tile_idx[t]*BN
                         + i]``.  Checkout has set semantics, so the packed
                         output needs no reordering; ``perm`` from the
                         planner exists for oracle comparison.

A CUDA tensor launches the hand-written kernel (``csrc/checkout_gather.cu``,
one library with both entry points); a CPU tensor runs the plain torch
version.  The indices are host numpy: the wrappers check on the host, before
the upload, that every rid lies in ``[0, R)`` and every tile index in
``[0, R/BN)`` and raise ``build.PlanError`` otherwise, since the kernels
would read past the buffer without a word.

``DEFAULT_BN``/``DEFAULT_BD`` keep the JAX package's values, so wave plans,
superblock byte counts and tile counters equal the reference's exactly.
Retuning the tile shape for Hopper is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .build import PlanError
from .ref import gather_row_tiles_ref, gather_rows_ref

DEFAULT_BD = 512   # feature-tile width (lanes); multiple of 128
DEFAULT_BN = 8     # rows per tile (sublane multiple)

# CUDA launches of each kernel in this process; the plain torch versions
# never count
LAUNCHES = {"gather_rows": 0, "gather_row_tiles": 0}


def gather_rows_plain(data: torch.Tensor, rids: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``gather_rows`` (the oracle's indexing).
    The CPU tests run it, and the card compares the kernel with it."""
    return gather_rows_ref(data, rids)


def gather_row_tiles_plain(data: torch.Tensor, tile_idx: torch.Tensor, *,
                           block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The plain torch version of ``gather_row_tiles`` (the oracle's)."""
    return gather_row_tiles_ref(data, tile_idx, block_n)


def check_indices(idx, limit: int, what: str) -> np.ndarray:
    """``idx`` as int32 numpy after checking it is 1-D and inside
    ``[0, limit)``; PlanError names the first index outside."""
    idx = np.asarray(idx)
    if idx.ndim != 1:
        raise PlanError(f"{what}s must be 1-D, got shape {idx.shape}")
    if len(idx):
        bad = (idx < 0) | (idx >= limit)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise PlanError(f"{what} {int(idx[i])} at position {i} lies "
                            f"outside [0, {limit})")
    return idx.astype(np.int32)


def _check_data(data: torch.Tensor) -> None:
    if data.ndim != 2:
        raise PlanError(f"data must be 2-D, got shape {tuple(data.shape)}")
    if data.device.type not in ("cuda", "cpu"):
        raise PlanError(f"checkout gathers run on cuda or cpu, not "
                        f"{data.device}")


def gather_rows(data: torch.Tensor, rids, *,
                block_n: int = DEFAULT_BN) -> torch.Tensor:
    """``out[i] = data[rids[i]]``: a version's rows in ONE launch.

    data: (R, D) on the device that runs the gather.
    rids: (N,) host rids (numpy or CPU tensor), any order.
    Returns (N, D) on data's device.  The rids are checked on the host
    (PlanError outside ``[0, R)``); the kernel copies BN-row output tiles, so
    they are padded to a multiple of BN with a valid rid before the one
    upload and the leading N rows are returned as a view."""
    _check_data(data)
    rids = check_indices(rids, data.shape[0], "rid")
    if data.device.type == "cpu":
        return gather_rows_plain(data, torch.from_numpy(rids))
    n = len(rids)
    fill = np.full((-n) % block_n, rids[0] if n else 0, np.int32)
    rids_d = torch.from_numpy(np.concatenate([rids, fill])).to(data.device)
    return _launch("gather_rows", data, rids_d, len(rids_d) // block_n,
                   block_n)[:n]


def gather_row_tiles(data: torch.Tensor, tile_idx, *,
                     block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Output tile t = rows ``[tile_idx[t]*BN, (tile_idx[t]+1)*BN)`` of
    ``data``: ONE launch.

    data: (R, D), R a multiple of BN (pad upstream).
    tile_idx: (T,) host tile indices from ``plan_tiles``.
    Returns (T*BN, D) packed tiles on data's device.  The indices are
    checked on the host (PlanError outside ``[0, R/BN)``), then uploaded."""
    _check_data(data)
    if block_n <= 0 or data.shape[0] % block_n:
        raise PlanError(f"data rows {data.shape[0]} are not a multiple of "
                        f"BN={block_n}; pad upstream")
    tile_idx = check_indices(tile_idx, data.shape[0] // block_n,
                             "tile index")
    idx = torch.from_numpy(tile_idx).to(data.device)
    if data.device.type == "cpu":
        return gather_row_tiles_plain(data, idx, block_n=block_n)
    return _launch("gather_row_tiles", data, idx, len(idx), block_n)


def _launch(name: str, data: torch.Tensor, idx: torch.Tensor, n_tiles: int,
            block_n: int) -> torch.Tensor:
    """One counted CUDA launch of kernel ``name`` over ``n_tiles`` BN-row
    output tiles, on device indices that the wrapper checked
    (``chip_smoke.py`` times the kernels through this): ``idx`` holds one
    rid per output row (``gather_rows``) or one tile index per output tile
    (``gather_row_tiles``)."""
    row_bytes = data.shape[1] * data.element_size()
    for what, x in (("data", data), ("indices", idx)):
        if not x.is_contiguous():
            raise PlanError(f"{what} must be contiguous")
        if x.device != data.device:
            raise PlanError(f"{what} on {x.device}, data on {data.device}")
    if idx.dtype != torch.int32:
        raise PlanError("indices must be int32")
    if row_bytes % 16 or data.data_ptr() % 16:
        raise PlanError(f"rows must be 16-byte multiples and aligned "
                        f"(row_bytes={row_bytes})")
    need = n_tiles * block_n if name == "gather_rows" else n_tiles
    if idx.ndim != 1 or idx.shape[0] != need:
        raise PlanError(f"{name} needs {need} indices, got "
                        f"{tuple(idx.shape)}")
    out = torch.empty((n_tiles * block_n, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    if n_tiles == 0:
        return out
    fn = build.kernel_fn("checkout_gather", f"{name}_launch")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), idx.data_ptr(), None, None, out.data_ptr(),
                 n_tiles, block_n, row_bytes, stream)
    build.check_launch(err, name)
    LAUNCHES[name] += 1
    return out


def plan_tiles(rids, block_n: int = DEFAULT_BN):
    """Host-side planner: the set of BN-row tiles covering a sorted rlist.

    Returns (tile_idx, perm, waste):
      * tile_idx — sorted unique tiles (row // BN) the rlist touches;
      * perm     — rlist position -> packed-output row, so
                   packed[perm] == data[rids] (oracle comparison only;
                   production checkout keeps set semantics);
      * waste    — fraction of gathered rows that are not in the rlist.
    """
    rids = np.asarray(rids)
    if len(rids) and np.any(np.diff(rids) < 1):
        raise ValueError(
            "plan_tiles requires a sorted, duplicate-free rlist (a version "
            "is a SET of records); sort/validate at the checkout entry "
            "point first")
    tile_of = rids // block_n
    tiles = np.unique(tile_of).astype(np.int32)
    perm = np.searchsorted(tiles, tile_of) * block_n + rids % block_n
    waste = 1.0 - len(rids) / max(len(tiles) * block_n, 1)
    return tiles, perm.astype(np.int64), waste
