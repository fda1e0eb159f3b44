"""The plain reference of the dense decoder family, in float32 and plain
PyTorch, with no kernel, cache or batching.

It follows the architecture the configuration file states (``assumed``
in each file lists where the program, and so this, departs from the
published model): ``n_layers`` of [RMS norm -> GQA attention with RoPE
(``rope_theta``) -> residual, RMS norm -> SwiGLU -> residual], a final
RMS norm and an LM head of its own, or the embedding's transpose where
``tie_embeddings`` is set.  RMS norms take ``norm_eps``.

The weights are a dict of float32 tensors by the leaf names of
``schema``: a stacked leaf (``layers/...``) holds every layer on a
leading axis.  ``Ops`` rounds both operands of every product (the
projections, Q·Kᵀ, P·V and the LM head) before it where given a
rounding, as a lower-precision kernel would: the control's path.  Every
matmul runs in float32 with TF32 off (``no_tf32``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def vocab_padded(c: dict) -> int:
    """Embedding rows: the vocabulary padded to a multiple of 512 (the
    padded rows are live logits)."""
    return -(-c["vocab"] // 512) * 512


def _attn_schema(c: dict, prefix: str, lead: tuple) -> dict:
    d, hd = c["d_model"], c["head_dim"]
    hq, hkv = c["n_heads"] * hd, c["n_kv"] * hd
    out = {f"{prefix}ln1": (lead + (d,), "ones", 0.0),
           f"{prefix}ln2": (lead + (d,), "ones", 0.0)}
    for name, din, dout in (("attn/wq/w", d, hq), ("attn/wk/w", d, hkv),
                            ("attn/wv/w", d, hkv), ("attn/wo/w", hq, d),
                            ("mlp/wi/w", d, c["d_ff"]),
                            ("mlp/wg/w", d, c["d_ff"]),
                            ("mlp/wo/w", c["d_ff"], d)):
        out[prefix + name] = (lead + (din, dout), "normal", din ** -0.5)
    return out


def schema(c: dict) -> dict:
    """Leaf name -> (shape, init, scale): dense weights normal · d_in^-0.5,
    the embedding and an untied LM head normal · d_model^-0.5, norm
    scales ones."""
    if c["family"] != "dense":
        raise ValueError(f"family {c['family']!r}: this reference is the "
                         "dense decoder's")
    d, L = c["d_model"], c["n_layers"]
    out = {"embed": ((vocab_padded(c), d), "normal", d ** -0.5),
           "final_norm": ((d,), "ones", 0.0)}
    if not c["tie_embeddings"]:
        out["lm_head"] = ((d, vocab_padded(c)), "normal", d ** -0.5)
    out.update(_attn_schema(c, "layers/", (L,)))
    return out


def rms_norm(scale, x, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """Rotate the two halves of each head: x (B, S, H, Dh)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Ops:
    """The products, plain or with both operands rounded by ``quant``."""

    def __init__(self, quant: Optional[Callable] = None):
        self.q = quant or (lambda t: t)

    def mm(self, x, w):
        return self.q(x) @ self.q(w)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def attention(w: dict, p: str, x, c: dict, ops: Ops, i=None,
              block: int = 1024):
    """Causal GQA self-attention on x (B, S, d); ``w[p + leaf]`` (row
    ``i`` of a stacked leaf) the weights; queries in blocks of ``block``
    rows."""
    def leaf(name):
        t = w[p + name]
        return t if i is None else t[i]
    b, s, _ = x.shape
    hd, h, hkv = c["head_dim"], c["n_heads"], c["n_kv"]
    pos = torch.arange(s, device=x.device)
    q = rope(ops.mm(x, leaf("attn/wq/w")).view(b, s, h, hd), pos,
             c["rope_theta"])
    k = rope(ops.mm(x, leaf("attn/wk/w")).view(b, s, hkv, hd), pos,
             c["rope_theta"])
    v = ops.mm(x, leaf("attn/wv/w")).view(b, s, hkv, hd)
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    outs = []
    for q0 in range(0, s, block):
        qb = q[:, q0:q0 + block]
        logits = ops.einsum("bqhd,bkhd->bhqk", qb, k) * hd ** -0.5
        qpos = torch.arange(q0, q0 + qb.shape[1], device=x.device)
        logits = logits.masked_fill(pos[None, :] > qpos[:, None],
                                    float("-inf"))
        outs.append(ops.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v))
    out = torch.cat(outs, dim=1).reshape(b, s, h * hd)
    return ops.mm(out, leaf("attn/wo/w"))


def swiglu(w: dict, p: str, x, ops: Ops, i=None):
    def leaf(name):
        t = w[p + name]
        return t if i is None else t[i]
    return ops.mm(F.silu(ops.mm(x, leaf("mlp/wg/w")))
                  * ops.mm(x, leaf("mlp/wi/w")), leaf("mlp/wo/w"))


def attn_block(w: dict, p: str, x, c: dict, ops: Ops, i=None):
    def leaf(name):
        t = w[p + name]
        return t if i is None else t[i]
    eps = c["norm_eps"]
    x = x + attention(w, p, rms_norm(leaf("ln1"), x, eps), c, ops, i)
    return x + swiglu(w, p, rms_norm(leaf("ln2"), x, eps), ops, i)


def hidden(w: dict, tokens, c: dict, ops: Ops, layer_fn=None):
    """The residual stream after the last block, (B, S, d).  ``layer_fn(f,
    x)`` wraps each block's call ``f(x)`` (training checkpoints it)."""
    run = layer_fn or (lambda f, x: f(x))
    x = w["embed"][tokens.long()]
    for i in range(c["n_layers"]):
        x = run(lambda h, i=i: attn_block(w, "layers/", h, c, ops, i), x)
    return x


def logits(w: dict, x, c: dict, ops: Ops):
    """The LM head on the final norm: (..., vocab_padded)."""
    head = w["embed"].t() if c["tie_embeddings"] else w["lm_head"]
    return ops.mm(rms_norm(w["final_norm"], x, c["norm_eps"]), head)


def last_logits(w: dict, tokens, c: dict, ops: Optional[Ops] = None):
    """The next-token logits at the last position, (B, vocab_padded)."""
    ops = ops or Ops()
    with torch.no_grad():
        return logits(w, hidden(w, tokens, c, ops)[:, -1], c, ops)


def loss(w: dict, tokens, labels, c: dict, ops: Optional[Ops] = None,
         layer_fn=None):
    """Mean next-token cross-entropy over every position and the padded
    vocabulary."""
    ops = ops or Ops()
    lg = logits(w, hidden(w, tokens, c, ops, layer_fn), c, ops)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1).long())


def fp8_e4m3(t):
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto 448), returned in float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def fp8_ste(t):
    """``fp8_e4m3`` in the forward, the identity in the backward."""
    return t + (fp8_e4m3(t) - t).detach()


def control_ops() -> Ops:
    """The control: every product's operands in float8 e4m3, the step
    below the configuration's stated bfloat16."""
    return Ops(fp8_ste)

