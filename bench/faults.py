"""Faults planted in the program's timed path, by name, for the check
that ``correct`` comes out false (``control.py --fault``, the tests).
Each takes a cell runner's state before its set-up steps."""
from __future__ import annotations

import torch


def alter_token(state) -> None:
    """Each request of a prefill serves another token than its best."""
    fn = state.prefill
    vocab = state.c["vocab"]

    def prefill(model, batch):
        lg = fn(model, batch).clone()
        rows = torch.arange(lg.shape[0], device=lg.device)
        other = (lg[:, -1, :vocab].argmax(-1) + 1) % vocab
        lg[rows, -1, other] = lg[:, -1].max(-1).values + 1.0
        return lg
    state.prefill = prefill


def alter_prompt(state) -> None:
    """Every checked-out row comes back with one token changed."""
    for srv in state.servers.values():
        def result(ticket, fn=srv.result):
            rows = fn(ticket).copy()
            rows[:, 1] = (rows[:, 1] + 1) % state.c["vocab"]
            return rows
        srv.result = result


def half_batch(state) -> None:
    """Each step's loss and gradient over the first half of its rows."""
    fn = state.step_fn

    def step(model, st, batch):
        half = {k: v[:len(v) // 2] for k, v in batch.items()}
        return fn(model, st, half)
    state.step_fn = step


def unchanged_state(state) -> None:
    """Each step computes its loss and leaves the weights and the
    optimizer's state as they were."""
    from repro_torch.train.train_step import accumulate_grads
    cfg = state.cfg

    def step(model, st, batch):
        loss, _ = accumulate_grads(model, batch, cfg)
        for p in model.parameters():
            p.grad = None
        return model, st, {"loss": loss, "grad_norm": torch.zeros(()),
                           "step": st.step}
    state.step_fn = step


def stale_once_warm(state) -> None:
    """The first step is sound; every later one computes its loss and
    leaves the weights and the optimizer's state as they were (a step
    that goes wrong only once it is warm)."""
    sound = state.step_fn
    unchanged_state(state)
    stale, calls = state.step_fn, []

    def step(model, st, batch):
        calls.append(1)
        return (sound if len(calls) == 1 else stale)(model, st, batch)
    state.step_fn = step


FAULTS = {f.__name__: f for f in (alter_token, alter_prompt, half_batch,
                                  unchanged_state, stale_once_warm)}
