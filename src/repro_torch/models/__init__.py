"""The model side of the port: layers, the SSD block, the mixture-of-experts
FFN and latent attention, the architecture assembly for the dense, moe, ssm,
hybrid, encdec and vlm families with its training loss, and the weight carry
to and from the JAX package's parameter trees."""
from .convert import (from_reference, load_reference, reference_like,
                      to_reference)
from .transformer import (ArchConfig, Model, decode_step, forward,
                          init_cache, init_cache_abstract, init_params,
                          loss_fn)

__all__ = ["ArchConfig", "Model", "decode_step", "forward", "from_reference",
           "init_cache", "init_cache_abstract", "init_params",
           "load_reference", "loss_fn", "reference_like", "to_reference"]
