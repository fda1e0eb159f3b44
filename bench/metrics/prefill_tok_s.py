"""Prompt tokens of every batch the server started within the window,
over the window's whole time: from the open to the first tokens of the
last such batch on the host."""
from bench.stats import rate


def read(run):
    batches = [b for b in run.get("batches") or () if b.get("in_window")]
    if not batches:
        return None
    return rate(sum(b["b"] * b["len"] for b in batches), run["window_s"])
