"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""
BF16_FLOPS = 989e12        # bf16 and fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of bf16 operations
    over the peak rate and bytes over the memory bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
