"""The comparisons that decide ``correct``: each gives one number, held
against its limit from ``limits/<workload>.json``."""
from __future__ import annotations

import numpy as np


def row_mismatches(got: list, want: list) -> int:
    """Rows served that differ in any token from the generated record they
    stand for (exact)."""
    return sum(int(not np.array_equal(g, w)) for g, w in zip(got, want))


def token_gaps(ref_logits, tokens) -> list:
    """Per request: how far the served token's logit lies below the
    reference's best (0 where the reference puts it first)."""
    ref = ref_logits.float()
    best = ref.max(dim=-1).values
    got = ref.gather(-1, tokens.long().view(-1, 1))[:, 0]
    return (best - got).tolist()


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def leaf_gap(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between two norms of each leaf, the program's
    ``got`` and the reference's ``want``: |got - want| over the larger of
    the reference's norm of that leaf and of the median leaf.  ``keep``
    names the leaves compared (all by default).  -> (gap, leaf)."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    worst, at = 0.0, ""
    for n in names:
        g = abs(got[n] - want[n]) / max(want[n], med)
        if g > worst:
            worst, at = g, n
    return worst, at


def moving_leaves(grad_norms: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's.  AdamW moves the others by
    round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return {n for n, g in grad_norms.items() if g >= share * med}
