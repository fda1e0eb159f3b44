"""Hopper kernels for the CVD hot paths.  ``ops`` holds the public
wrappers, ``ref`` the plain oracles, ``build`` the nvcc build of the CUDA
sources under ``repro_torch/csrc``.  (The wrappers are not re-exported
here: their names would shadow the kernel modules of the same name.)"""
from . import (checkout_batched, checkout_gather, ops, ref, segment_append,
               segment_move)
from .checkout_batched import plan_batched
from .checkout_gather import plan_tiles

__all__ = ["checkout_batched", "checkout_gather", "ops", "ref",
           "segment_append", "segment_move", "plan_batched", "plan_tiles"]
