"""Closed-form work of one causal flash-attention forward: the (query,
key) pairs the causal mask keeps, Q·Kᵀ over the q·k width and P·V over
the v width; q, k and v read once and the output written once."""


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def flops(b: int, s: int, heads: int, dqk: int, dv: int) -> int:
    return 2 * b * heads * causal_pairs(s) * (dqk + dv)


def nbytes(b: int, s: int, heads: int, kv_heads: int, dqk: int, dv: int,
           elem: int = 2) -> int:
    return (b * s * heads * (dqk + dv) + b * s * kv_heads * (dqk + dv)) * elem
