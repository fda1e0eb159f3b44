"""Hopper kernels for the CVD hot paths.  ``ops`` holds the public
wrappers, ``ref`` the plain oracles, ``build`` the nvcc build of the CUDA
sources under ``repro_torch/csrc``.

The names the JAX package exports are exported here too, except the
wrappers ``checkout_batched``, ``checkout_gather``, ``flash_attention`` and
``ssd_scan``: their names are the kernel modules', which stay importable as
modules (``ops.<name>`` are the wrappers)."""
from . import (checkout_batched, checkout_gather, flash_attention, ops, ref,
               segment_append, segment_move, ssd_scan, version_agg,
               vlist_membership)
from .ops import (build_bitmap, checkout_gather_tiled, membership_scan,
                  plan_batched, plan_tiles, version_aggregate)

__all__ = ["checkout_batched", "checkout_gather", "flash_attention", "ops",
           "ref", "segment_append", "segment_move", "ssd_scan", "version_agg",
           "vlist_membership", "build_bitmap", "checkout_gather_tiled",
           "membership_scan", "plan_batched", "plan_tiles",
           "version_aggregate"]
