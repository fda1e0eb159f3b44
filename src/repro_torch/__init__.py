"""OrpheusDB on PyTorch and CUDA: the port of the JAX package ``repro`` to
one NVIDIA H100.

It mirrors ``repro``'s layout (``repro_torch.core.checkout`` is the port of
``repro.core.checkout``, and so on), imports torch and numpy, and never
imports jax or anything of ``repro``.  Entry points run on the card unless
the caller passes ``device="cpu"``; every Pallas kernel of a ported path is a
hand-written Hopper kernel under ``repro_torch/csrc`` with a plain torch
version beside it.  See ROADMAP.md for what is ported so far.
"""
