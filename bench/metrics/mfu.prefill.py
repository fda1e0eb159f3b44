"""Model FLOPs of every prefill of the run, the window and the queue
served after it (closed form from the configuration's sizes,
``counts.model.prefill_flops``), over the time of those prefills (each
from its call to its tokens on the host), against the card's bf16
peak."""
from bench import peaks
from bench.counts import model


def read(run):
    batches = run.get("batches")
    secs = run["spans"].seconds("prefill")
    if not batches or not secs:
        return None
    flops = sum(model.prefill_flops(run["config"], r["b"], r["len"])
                for r in batches)
    return 100.0 * flops / sum(secs) / peaks.BF16_FLOPS
