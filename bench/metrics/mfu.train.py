"""Model FLOPs of every optimizer step of the window (closed form:
``counts.model.train_flops``, the matmuls' 6·N·T and causal attention's
pairs; recomputation is not counted) over the steps' time, against the
card's bf16 peak."""
from bench import peaks
from bench.counts import model


def read(run):
    steps = run.get("steps")
    secs = run["spans"].seconds("step")
    if not steps or not secs:
        return None
    flops = sum(model.train_flops(run["config"], s["b"], s["s"])
                for s in steps)
    return 100.0 * flops / sum(secs) / peaks.BF16_FLOPS
