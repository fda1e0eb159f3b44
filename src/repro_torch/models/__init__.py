"""The model side of the port, forward only: layers, the SSD block, the
architecture assembly for the dense, ssm and hybrid families, and the weight
carry from the JAX package's parameter trees."""
from .convert import from_reference
from .transformer import (ArchConfig, Model, decode_step, forward,
                          init_cache, init_cache_abstract, init_params)

__all__ = ["ArchConfig", "Model", "decode_step", "forward", "from_reference",
           "init_cache", "init_cache_abstract", "init_params"]
