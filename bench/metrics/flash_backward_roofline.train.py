"""The flash-attention backward kernel's share of its roofline in the
traced window: for each of the program's ``attn.backward`` spans that ran
the kernel (attribute ``path`` "kernel", with the call's shape in the
others; ``kernels/ops.py``), the least time its shape allows (the larger
of the five products' FLOPs over the bf16 peak and its bytes over the
memory bandwidth; ``counts.flash_bwd``), summed, over the device time of
the kernels whose names hold ``flash_bwd``. None without a trace, or
without such spans (a program whose backward is plain torch)."""
from bench import peaks
from bench.counts import flash_bwd

PATTERN = r"flash_bwd"


def read(run):
    t = run.get("trace")
    if t is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    bound = 0.0
    for s in trace.spans():
        a = s.attrs
        if s.name != "attn.backward" or a.get("path") != "kernel":
            continue
        bound += peaks.bound_s(
            flash_bwd.flops(a["b"], a["sq"], a["sk"], a["h"], a["dqk"],
                            a["dv"], a["causal"]),
            flash_bwd.nbytes(a["b"], a["sq"], a["sk"], a["h"], a["hkv"],
                             a["dqk"], a["dv"]))
    kernel_s = t.kernel_seconds(PATTERN)
    if bound <= 0 or kernel_s <= 0:
        return None
    return 100.0 * bound / kernel_s
