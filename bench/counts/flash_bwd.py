"""Closed-form work of one flash-attention backward: five products over
the (query, key) pairs the mask keeps (S = Q·Kᵀ and dS·K and dSᵀ·Q over
the q·k width; dP = dO·Vᵀ and Pᵀ·dO over the v width); q, k, v, o and dO
read, dq, dk and dv written once in the operands' type, and the row lse
and delta once in float32."""


def pairs(sq: int, sk: int, causal: bool) -> int:
    """The pairs a query row i sees: keys 0 .. min(i, Sk - 1) causal, all
    Sk otherwise."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


def flops(b: int, sq: int, sk: int, heads: int, dqk: int, dv: int,
          causal: bool) -> int:
    return 2 * b * heads * pairs(sq, sk, causal) * (3 * dqk + 2 * dv)


def nbytes(b: int, sq: int, sk: int, heads: int, kv_heads: int, dqk: int,
           dv: int, elem: int = 2) -> int:
    rows_q = b * sq * heads * (2 * dqk + 2 * dv)      # q, dq; o, dO
    rows_kv = b * sk * kv_heads * 2 * (dqk + dv)      # k, v; dk, dv
    return (rows_q + rows_kv) * elem + 2 * 4 * b * heads * sq
