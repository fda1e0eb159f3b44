"""Plain AdamW with decoupled weight decay and global-norm clipping, in
float32: m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², with g the gradient
scaled by min(1, clip / ‖g‖) over every leaf; p ← p − lr·(m̂/(√v̂ + eps) +
wd·p), m̂ and v̂ bias-corrected."""
from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, clip_norm: float):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> dict:
        """One update from the leaves' ``.grad`` (cleared after); returns
        the clipped gradients."""
        self.t += 1
        grads = {n: p.grad for n, p in self.params.items()}
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-9), max=1.0)
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for n, p in self.params.items():
            g = grads[n] * scale
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).add_(g.square(), alpha=1 - self.b2)
            upd = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))
            p.grad = None
            out[n] = g
        return out
