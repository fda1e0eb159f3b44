"""AdamW with decoupled weight decay, global-norm clipping, and schedules:
the port of ``repro.train.optimizer``.

The reference's own arithmetic, leaf by leaf in float32: the global-norm
clip, the moments, the bias correction as ``mh / (sqrt(vh) + eps)`` and
weight decay on every leaf (``torch.optim.AdamW`` rounds differently).  The
parameters are a ``Model`` (or a dict of tensors by name); ``update``
writes the new parameters and moments IN PLACE (the reference returns new
trees) and returns them with the new state.  Step, learning rate and
global norm stay 0-d device tensors, so a step never waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    m: dict                     # parameter name -> float32 first moment
    v: dict                     # parameter name -> float32 second moment


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        named = _named(params)
        dev = next(iter(named.values())).device
        # a DTensor parameter gets moments laid out as it is
        zeros = {n: torch.zeros_like(p.detach(), dtype=torch.float32,
                                     memory_format=torch.contiguous_format)
                 for n, p in named.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=zeros,
                          v={n: torch.zeros_like(z) for n, z in zeros.items()})

    def state_specs(self, param_specs: dict) -> AdamWState:
        """The state's specs (the reference's ``optimizer.py:43``): the
        moments laid out as the parameters, the step replicated."""
        return AdamWState(step=(), m=param_specs, v=param_specs)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params,
               gnorm: torch.Tensor | None = None):
        """(params, new state, global grad norm) after one step on
        ``grads`` (name -> gradient); the parameters and moments change in
        place.  A sharded step passes each rank's shards of the three and
        the global norm ``gnorm``, which only it can take."""
        named = _named(params)
        step = state.step + 1
        stepf = step.float()
        lr = self.lr(step) if callable(self.lr) else self.lr

        # global-norm clip
        if gnorm is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[n].float()))
                                   for n in named))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

        c1 = 1.0 - self.b1 ** stepf
        c2 = 1.0 - self.b2 ** stepf
        for n, p in named.items():
            g = grads[n].float() * scale
            m, v = state.m[n], state.v[n]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            mh = m / c1
            vh = v / c2
            delta = mh / (torch.sqrt(vh) + self.eps) \
                + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor · peak`` at ``total``; the step is a 0-d tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr
