"""Tokens of every optimizer step completed in the window (its loss on
the host), over the window's whole time."""
from bench.stats import rate


def read(run):
    steps = run.get("steps")
    if not steps:
        return None
    return rate(sum(s["tokens"] for s in steps), run["window_s"])
