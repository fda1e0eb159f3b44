"""The training cell: optimizer steps of ``global_batch`` sequences of
``seq_len`` tokens off a versioned corpus, as long as the window lasts.

The corpus is a generated SCI workload whose records are ``seq_len + 1``
tokens (mod the vocabulary), partitioned by the program's LyreSplit; the
program's ``VersionedDataset`` checks out one version (the
``gather_row_tiles`` kernel) and streams shuffled batches of its records.
Set-up builds ONE train step (``make_train_step`` with the program's
AdamW) over the benchmark's weights and drives it through
``setup_steps`` steps, which warm every shape; then it puts the seeded
weights and a fresh AdamW state back into that same object, in place,
and hands it to the window.  A step ends when its loss is on the host.

The window's own first ``reference_steps`` steps are the ones checked:
each one's loss, each leaf's first gradient as the optimizer got it (its
first moment after the window's first step over 1 - b1) and each leaf's
change from the seeded start after the last of them, the norms taken on
the card between the steps and read after the window.  Then, with the
program's state freed, the plain float32 reference (``reference.model``,
``reference.adamw``) trains the same weights on the same records for
those steps, and the worst gaps are the numbers compared (``checks``).

The traffic file's keys: ``seq_len``, ``global_batch``; ``corpus``, the
generator's kind, versions, inserts and branches and the version
trained on; ``optimizer``, AdamW's settings (a constant learning rate);
``setup_steps``, the warm-up; ``reference_steps``, the window's steps
the reference follows (two, so that it stays shorter than the window);
``trace_steps``, the traced slice."""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import checks, weights
from ..devtrace import Spans, traced
from ..gen import versions as gen
from ..harness import (arch_config, build_store, load_model,
                       reference, subseed)
from ..reference import adamw


def _device_type(device) -> str:
    return torch.device(device).type


class Cell:
    """The program's state for one run: the corpus store and its batch
    stream, the model, the AdamW state, the step."""

    def __init__(self, c: dict, t: dict, seed: int, device):
        from repro_torch.data import VersionedDataset
        from repro_torch.train import AdamW, make_train_step
        self.c, self.t, self.device = c, t, device
        self.cfg = arch_config(c)
        t0 = time.perf_counter()
        s = t["corpus"]
        v = gen.generate(s["kind"], n_versions=s["n_versions"],
                         inserts=s["inserts"], n_branches=s["n_branches"],
                         n_attrs=t["seq_len"] + 1, seed=subseed(seed, 2))
        # the benchmark's own records (the store copies them)
        self.records = v.data % c["vocab"]
        self.vid = s["version"] % v.n_versions
        self.version_rids = v.rlists[self.vid]
        ds = VersionedDataset(store=build_store(v, self.records, device),
                              seq_len=t["seq_len"])
        self.batches = ds.batches(self.vid, global_batch=t["global_batch"],
                                  seed=subseed(seed, 3) % (1 << 32))
        t1 = time.perf_counter()
        flat = weights.make(c, seed, device)
        self.model = load_model(c, self.cfg, flat, device, trainable=True)
        del flat
        self.phases = {"corpus_s": t1 - t0,
                       "weights_s": time.perf_counter() - t1}
        o = t["optimizer"]
        self.opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"],
                         clip_norm=o["clip_norm"])
        self.state = self.opt.init(self.model)
        self.step_fn = make_train_step(self.cfg, self.opt)

    def step(self, spans: Spans) -> dict:
        t0 = time.perf_counter()
        with record_function("bench.fetch"):
            b = next(self.batches)
            batch = {k: torch.from_numpy(np.ascontiguousarray(b[k])).to(
                self.device) for k in ("tokens", "labels")}
        t1 = time.perf_counter()
        with record_function("bench.step"):
            self.model, self.state, m = self.step_fn(self.model, self.state,
                                                     batch)
            loss = float(m["loss"])
        t2 = time.perf_counter()
        spans.add("fetch", t0, t1)
        spans.add("step", t1, t2)
        rows = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
        return {"b": len(rows), "s": rows.shape[1] - 1,
                "tokens": rows.size - len(rows), "loss": loss, "rows": rows,
                "t_done": t2}

    def restart(self, seed: int) -> None:
        """The seeded weights and a fresh AdamW state (moments and step
        zero) put back into the same model and state, in place."""
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name in weights.schema(self.c):
                start = weights.layer_leaves(
                    {name: weights.make_leaf(self.c, seed, name,
                                             self.device)})
                for leaf, p0 in start.items():
                    params[leaf].copy_(p0)
                del start
            for t in (*self.state.m.values(), *self.state.v.values()):
                t.zero_()
        for p in params.values():
            p.grad = None
        self.state = self.state._replace(
            step=torch.zeros_like(self.state.step))

    def first_grad_norms(self) -> dict:
        """Each leaf's gradient as the optimizer got it after one step:
        its first moment over 1 - b1 (0-d tensors on the card)."""
        k = 1.0 - self.opt.b1
        with torch.no_grad():
            return {n: m.norm() / k for n, m in self.state.m.items()}

    def change_norms(self, seed: int) -> dict:
        """Each leaf's distance from its seeded start, the start made
        again a stacked leaf at a time (0-d tensors on the card)."""
        params = dict(self.model.named_parameters())
        out = {}
        with torch.no_grad():
            for name in weights.schema(self.c):
                start = weights.layer_leaves(
                    {name: weights.make_leaf(self.c, seed, name,
                                             self.device)})
                for leaf, p0 in start.items():
                    out[leaf] = (params[leaf].detach() - p0).norm()
                del start
        return out

    def close(self) -> None:
        del self.model, self.state, self.step_fn, self.batches


def launches() -> dict:
    from repro_torch.kernels import checkout_gather as cg
    from repro_torch.kernels import flash_attention as fa
    return {"flash": fa.LAUNCHES,
            "gather_row_tiles": cg.LAUNCHES["gather_row_tiles"]}


def record_ids(rows: np.ndarray, records: np.ndarray, rids: np.ndarray):
    """The record of the version each served row equals (compared whole),
    -1 where none does."""
    by_row = {records[r].tobytes(): int(r) for r in rids}
    return np.asarray([by_row.get(np.ascontiguousarray(row).tobytes(), -1)
                       for row in rows])


def reference_train(c: dict, t: dict, seed: int, batches: list, device,
                    ops=None, keep_rows: int | None = None) -> dict:
    """The plain reference's ``len(batches)`` steps from the seeded
    weights on the given record rows (each (B, S + 1)): per step the
    mean loss; the first step's clipped gradient's norm by leaf; each
    leaf's change after the last step.  One sequence at a time, each
    block recomputed in the backward; the gradient the mean over the
    batch (over its first ``keep_rows`` rows where given)."""
    ref = reference(c)
    w = weights.make(c, seed, device)
    for p in w.values():
        p.requires_grad_(True)
    o = t["optimizer"]
    opt = adamw.AdamW(w, lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"],
                      clip_norm=o["clip_norm"])
    ops = ops or ref.Ops()

    def block(f, x):
        return checkpoint(f, x, use_reentrant=False)
    losses, first = [], None
    with ref.no_tf32():
        for rows in batches:
            rows = rows[:keep_rows] if keep_rows else rows
            total = 0.0
            for row in rows:
                seq = torch.from_numpy(np.ascontiguousarray(row)).to(device)
                loss = ref.loss(w, seq[None, :-1], seq[None, 1:], c, ops,
                                layer_fn=block) / len(rows)
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = opt.step()
            if first is None:
                first = {n: float(g.norm()) for n, g in
                         weights.layer_leaves(grads).items()}
            del grads
    with torch.no_grad():
        change = {}
        for name in w:
            p0 = weights.make_leaf(c, seed, name, device)
            for leaf, d in weights.layer_leaves({name: w[name] - p0}).items():
                change[leaf] = float(d.norm())
            del p0
    del w, opt
    return {"losses": losses, "first_grad": first, "change": change}


def compare(got: dict, want: dict, limits: dict) -> dict:
    """The training numbers compared, each (reading, limit): the worst
    step's relative loss gap; the worst leaf's gap of the first gradient's
    norm; the worst moving leaf's gap of the change's norm
    (``checks.leaf_gap``, ``checks.moving_leaves``)."""
    keep = checks.moving_leaves(want["first_grad"])
    return {
        "loss_gap": (max(checks.relative_gap(g, w) for g, w in
                         zip(got["losses"], want["losses"])),
                     limits["loss_gap"]),
        "first_grad_gap": (checks.leaf_gap(got["first_grad"],
                                           want["first_grad"])[0],
                           limits["first_grad_gap"]),
        "change_gap": (checks.leaf_gap(got["change"], want["change"],
                                       keep)[0], limits["change_gap"])}


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault=None, control: bool = False) -> dict:
    """One run; ``fault(state)`` breaks the program's step before set-up
    (the tests' faults), ``control`` also reads the control: the
    reference in float8 in the program's place."""
    c, t = cell.config, cell.traffic
    n_ref = int(t["reference_steps"])
    state = Cell(c, t, seed, device)
    if fault is not None:
        fault(state)
    t_warm = time.perf_counter()
    setup_steps = [state.step(Spans())
                   for _ in range(int(t["setup_steps"]))]
    state.restart(seed)
    _sync(device)
    state.phases["warm_s"] = time.perf_counter() - t_warm
    spans = Spans()
    steps: list = []
    first_grad = change = None
    l0 = launches()
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds or len(steps) < n_ref:
        steps.append(state.step(spans))
        if len(steps) == 1:
            first_grad = state.first_grad_norms()
        if len(steps) == n_ref:
            change = state.change_norms(seed)
    t_close = steps[-1]["t_done"]
    l1 = launches()
    first_grad = {n: float(v) for n, v in first_grad.items()}
    change = {n: float(v) for n, v in change.items()}
    out = {"t_open": t_open, "window_s": t_close - t_open, "steps": steps,
           "spans": spans, "config": c, "trace": None, "traced": [],
           "launches": {k: l1[k] - l0[k] for k in l0}}
    if trace:
        def slice_():
            recs = []
            for _ in range(int(t["trace_steps"])):
                before = launches()["flash"]
                rec = state.step(Spans())
                recs.append({"b": rec["b"], "s": rec["s"],
                             "flash": launches()["flash"] - before})
            return recs
        out["traced"], out["trace"] = traced(slice_, torch)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if _device_type(device) == "cuda" else 0)
    records, rids, phases = state.records, state.version_rids, state.phases
    state.close()
    del state
    _free(device)

    # ---- correctness, after the window and the program's state freed ----
    served = setup_steps + steps
    ids = [record_ids(s["rows"], records, rids) for s in served]
    checked = ids[len(setup_steps):len(setup_steps) + n_ref]
    first_ids = np.concatenate(checked)
    bad_rows = sum(int((i < 0).sum()) for i in ids)
    repeats = len(first_ids) - len(np.unique(first_ids))
    t_ref = time.perf_counter()
    want = reference_train(c, t, seed, [records[i] for i in checked],
                           device)
    out["reference_s"] = time.perf_counter() - t_ref
    got = {"losses": [s["loss"] for s in steps[:n_ref]],
           "first_grad": first_grad, "change": change}
    out["checks"] = {"batch_row_mismatch": (bad_rows + repeats,
                                            cell.limits["batch_row_mismatch"]),
                     **compare(got, want, cell.limits)}
    if control:
        ctl = reference_train(c, t, seed, [records[i] for i in checked],
                              device, ops=reference(c).control_ops())
        out["control_checks"] = compare(ctl, want, cell.limits)
    out["attempted"] = len(served)
    out["failed"] = sum(int((i < 0).any()) for i in ids)
    out["samples"] = {
        "steps": len(steps), "setup_steps": len(setup_steps),
        "step_s": [b["t_done"] - a["t_done"] for a, b in
                   zip([{"t_done": t_open}] + steps, steps)],
        "reference_steps": n_ref, "losses": got["losses"],
        "reference_losses": want["losses"],
        "leaves_compared": len(checks.moving_leaves(want["first_grad"])),
        "leaves": len(want["change"]), "setup_phases": phases,
        "launches": out["launches"]}
    return out


def _sync(device) -> None:
    if _device_type(device) == "cuda":
        torch.cuda.synchronize()


def _free(device) -> None:
    import gc
    gc.collect()
    if _device_type(device) == "cuda":
        torch.cuda.empty_cache()
