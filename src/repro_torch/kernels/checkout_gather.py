"""Tile constants and the host tile planner shared by the checkout kernels.

``DEFAULT_BN``/``DEFAULT_BD`` keep the JAX package's values, so wave plans,
superblock byte counts and tile counters equal the reference's exactly.
Retuning the tile shape for Hopper is later work.

The single-version gather kernels of the JAX package (``gather_rows``,
``gather_row_tiles``) are not ported yet; ``plan_tiles`` is their host
planner and is kept here already because it is plain numpy.
"""
from __future__ import annotations

import numpy as np

DEFAULT_BD = 512   # feature-tile width (lanes); multiple of 128
DEFAULT_BN = 8     # rows per tile (sublane multiple)


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
