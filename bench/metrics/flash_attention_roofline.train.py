"""The flash-attention forward kernel's share of its roofline in the
traced window: for each launch the least time its shapes allow (the
larger of the causal pairs' FLOPs over the bf16 peak and q, k, v and
the output once over the memory bandwidth; ``counts.flash``), summed,
over the kernel's device time from the trace."""
from bench import peaks
from bench.counts import flash

PATTERN = r"flash_fwd"


def read(run):
    t = run.get("trace")
    if t is None:
        return None
    kernel_s = t.kernel_seconds(PATTERN)
    c = run["config"]
    h, kv, dh = c["n_heads"], c["n_kv"], c["head_dim"]
    bound = sum(r["flash"] * peaks.bound_s(
        flash.flops(r["b"], r["s"], h, dh, dh),
        flash.nbytes(r["b"], r["s"], h, kv, dh, dh))
        for r in run["traced"])
    if kernel_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / kernel_s
