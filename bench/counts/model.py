"""Closed-form model FLOPs of the dense decoder from a configuration's
sizes: twice the multiply-adds of every weight a token passes through,
plus causal attention's (query, key) pairs.  A serving prefill runs the
LM head on the last position only; training counts the forward and a
backward of twice its work (the matmuls' 6·N·T), and recomputation is
not model work."""
from . import flash


def attn_weights(c: dict) -> int:
    d, hd = c["d_model"], c["head_dim"]
    return d * hd * (2 * c["n_heads"] + 2 * c["n_kv"])


def mlp_weights(c: dict) -> int:
    return 3 * c["d_model"] * c["d_ff"]


def vocab_padded(c: dict) -> int:
    return -(-c["vocab"] // 512) * 512


def body_weights(c: dict) -> int:
    """Weights a token passes through below the LM head."""
    if c["family"] != "dense":
        raise ValueError(f"family {c['family']!r}: this count is the dense "
                         "decoder's")
    return c["n_layers"] * (attn_weights(c) + mlp_weights(c))


def forward_flops(c: dict, b: int, s: int, head_positions: int) -> int:
    """One forward of B sequences of S tokens, the LM head on
    ``head_positions`` positions a sequence."""
    out = 2 * body_weights(c) * b * s
    out += 2 * c["d_model"] * vocab_padded(c) * b * head_positions
    out += c["n_layers"] * flash.flops(b, s, c["n_heads"], c["head_dim"],
                                       c["head_dim"])
    return out


def prefill_flops(c: dict, b: int, s: int) -> int:
    return forward_flops(c, b, s, head_positions=1)


def train_flops(c: dict, b: int, s: int) -> int:
    return 3 * forward_flops(c, b, s, head_positions=s)
