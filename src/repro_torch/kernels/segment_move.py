"""Incremental superblock migration: T output tiles, ONE launch.

``PartitionedCVD.apply_migration`` changes the partition layout and so the
superblock's row layout, but most BN-row tiles of the post-migration
superblock are byte-identical to tiles of the PRE-migration one, which is
already on the device.  Every output tile comes from one of two sources,
chosen per tile by the host plan ``(sel, starts)``::

    sel[t] == 0  ->  rows [starts[t], starts[t]+BN) of the OLD superblock
                     (device to device; never crosses the host link)
    sel[t] != 0  ->  rows [starts[t], starts[t]+BN) of the small delta block
                     the host uploaded (only the changed tiles)

``core.checkout.migrate_superblock`` builds the plan.  It is
``segment_append`` without the zero-fill mode and shares that module's plan
checks and row map.  A CUDA tensor launches the hand-written kernel
(``csrc/segment_move.cu``); a CPU tensor runs ``segment_move_plain``.
"""
from __future__ import annotations

import torch

from . import segment_append as _sa
from .checkout_gather import DEFAULT_BN

# CUDA launches of ``segment_move`` in this process; the plain torch version
# never counts
LAUNCHES = 0


def segment_move_plain(src: torch.Tensor, delta: torch.Tensor, sel, starts,
                       *, block_n: int = DEFAULT_BN) -> torch.Tensor:
    """The plain torch version of ``segment_move``: the same function as
    the kernel.  The CPU tests run it, and the card compares the kernel
    with it."""
    return _sa.plain(src, delta, sel, starts, block_n=block_n, pad=False)


def segment_move(src: torch.Tensor, delta: torch.Tensor, sel, starts, *,
                 block_n: int = DEFAULT_BN) -> torch.Tensor:
    """Assemble a migrated superblock: T output tiles, ONE launch.

    src:    (R_old, D) the pre-migration superblock.
    delta:  (R_delta, D) the changed rows, BN-tile packed, on src's device.
    sel:    (T,) host plan (numpy or CPU tensor): 0 = src, else delta.
    starts: (T,) host plan: the first source row of each tile.
    Returns (T*block_n, D) on src's device.  The plan is checked on the host
    (PlanError on a run outside its source), then uploaded in one copy.  A
    CUDA tensor launches the CUDA kernel (or raises); a CPU tensor runs
    ``segment_move_plain``."""
    _sa.check_sources(src, delta)
    sel, starts = _sa.check_plan(sel, starts, src.shape[0], delta.shape[0],
                                 block_n=block_n, pad=False)
    sel_d, starts_d = _sa.upload(src.device, sel, starts)
    if src.device.type == "cpu":
        return segment_move_plain(src, delta, sel_d, starts_d,
                                  block_n=block_n)
    return _launch(src, delta, sel_d, starts_d, block_n)


def _launch(src, delta, sel, starts, block_n: int) -> torch.Tensor:
    """One counted CUDA launch on a device plan that ``check_plan`` passed
    (``chip_smoke.py`` times the kernel through this)."""
    global LAUNCHES
    out = _sa.launch("segment_move", src, delta, sel, starts, block_n)
    LAUNCHES += 1
    return out
