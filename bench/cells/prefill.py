"""The serving prefill cell: an open loop of requests, each one prompt
checked out of a versioned prompt store and prefilled for its first
token.

Requests arrive on a schedule fixed before the window opens, whether or
not earlier ones have finished.  Over ``--seconds`` there are ``rate_per_s
· seconds`` of them; their gaps are that many quantiles of the
exponential distribution (a Poisson process's gaps) and their prompt
lengths the ``lengths`` mix's shares of them, both shuffled by the seed,
so every seed does the same work in another order.  Each request is one
row of a version drawn uniformly from the store of its length: a
generated CUR workload whose records are that many tokens (mod the
vocabulary), partitioned by the program's LyreSplit.

The server is first come, first served by length: whenever the card is
free it takes the oldest waiting request's length and as many waiting
requests of that length as fit into ``batch_tokens``, rounded down to a
power of two (the shapes set-up warms).  A batch is one checkout wave of
its distinct versions through the program's ``BatchedCheckoutServer``
(the ``checkout_wave`` kernel), ``make_prefill_step`` on the (batch,
length) prompts and the argmax of the last position's logits on the
host.  A request's time to first token runs from its arrival to its
token on the host.

The window is the batches the server starts within ``--seconds`` of the
open; it closes when the last of them has its tokens on the host.  The
rate counts the prompt tokens of those batches over that time.  Requests
still queued at the close are served after it, untimed, so that every
request of the schedule is checked.

After the window the run holds every served prompt against the generated
record it stands for (exactly), and a sample of the served tokens, drawn
from the seed with the longest prompts in it, against the plain float32
reference's logits (``checks.token_gaps``).

The traffic file's keys: ``lengths``, [length, share] pairs;
``rate_per_s``; ``batch_tokens``; ``store``, the generator's kind,
versions, inserts and branches; ``drain_s``, how long the run waits
past the window for the last requests; ``trace_seconds``, the traced
slice's schedule; ``check_requests`` and ``check_longest``, the sample
the reference checks and how many of it are of the longest length."""
from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import checks, weights
from ..devtrace import Spans, traced
from ..gen import versions as gen
from ..harness import (arch_config, build_store, load_model, reference,
                       subseed)


def lengths(t: dict) -> list:
    return [int(n) for n, _ in t["lengths"]]


def length_counts(t: dict, n: int) -> dict:
    """``n`` requests split by the mix's shares (largest remainders)."""
    shares = np.asarray([float(s) for _, s in t["lengths"]])
    want = shares / shares.sum() * n
    counts = np.floor(want).astype(int)
    for k in np.argsort(counts - want)[:n - counts.sum()]:
        counts[k] += 1
    return dict(zip(lengths(t), counts.tolist()))


def schedule(t: dict, seed: int, seconds: float, key: int = 0) -> list:
    """The requests of a window of ``seconds``, by arrival: each a dict
    of its arrival ``a`` (seconds from the open), prompt length ``len``,
    version ``vid`` and row fraction ``frac``."""
    rng = np.random.default_rng(subseed(seed, 1, key))
    rate = float(t["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    arrive = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])
    lens = np.repeat(*zip(*length_counts(t, n).items()))
    lens = rng.permutation(lens)
    vids = rng.integers(0, t["store"]["n_versions"], size=n)
    fracs = rng.random(n)
    return [{"a": float(a), "len": int(L), "vid": int(v), "frac": float(f)}
            for a, L, v, f in zip(arrive, lens, vids, fracs)]


def max_batch(t: dict, length: int) -> int:
    return max(int(t["batch_tokens"]) // length, 1)


def batch_sizes(t: dict, length: int) -> list:
    """The powers of two up to the most prompts of ``length`` a batch
    holds."""
    out, n = [], 1
    while n <= max_batch(t, length):
        out.append(n)
        n *= 2
    return out


class Cell:
    """The program's state for one run: a store and a checkout server a
    prompt length, the model, the prefill step."""

    def __init__(self, c: dict, t: dict, seed: int, device):
        from repro_torch.serve import serve_step
        from repro_torch.serve.checkout import BatchedCheckoutServer
        self.c, self.t, self.device = c, t, device
        self.cfg = arch_config(c)
        t0 = time.perf_counter()
        # the benchmark's own records by length (the store copies them)
        self.records, self.rlists, self.servers = {}, {}, {}
        s = t["store"]
        for k, n in enumerate(lengths(t)):
            v = gen.generate(s["kind"], n_versions=s["n_versions"],
                             inserts=s["inserts"],
                             n_branches=s["n_branches"], n_attrs=n,
                             seed=subseed(seed, 2, k))
            self.records[n] = v.data % c["vocab"]
            self.rlists[n] = v.rlists
            srv = BatchedCheckoutServer(build_store(v, self.records[n],
                                                    device))
            srv.warmup()
            self.servers[n] = srv
        t1 = time.perf_counter()
        flat = weights.make(c, seed, device)
        self.model = load_model(c, self.cfg, flat, device, trainable=False)
        del flat
        self.phases = {"stores_s": t1 - t0,
                       "weights_s": time.perf_counter() - t1}
        self.prefill = serve_step.make_prefill_step(self.cfg, device=device)

    def batch(self, length: int, reqs: list, spans: Spans) -> dict:
        """One batch of requests of one prompt length: the checkout of
        their versions, the prefill, the first tokens on the host."""
        srv = self.servers[length]
        vids = [r["vid"] for r in reqs]
        t0 = time.perf_counter()
        with record_function("bench.checkout"):
            distinct = sorted(set(vids))
            tickets = srv.submit_many(distinct)
            srv.flush()
            got = {v: srv.result(tk) for v, tk in zip(distinct, tickets)}
        t1 = time.perf_counter()
        picks = [min(int(r["frac"] * len(got[v])), len(got[v]) - 1)
                 for r, v in zip(reqs, vids)]
        prompts = np.stack([got[v][i] for v, i in zip(vids, picks)])
        with record_function("bench.prefill"):
            logits = self.prefill(self.model,
                                  {"tokens": torch.from_numpy(prompts)})
            tokens = logits[:, -1, :self.c["vocab"]].argmax(-1).cpu()
        t2 = time.perf_counter()
        spans.add("checkout", t0, t1)
        spans.add("prefill", t1, t2)
        return {"len": length, "b": len(reqs), "vids": vids,
                "picks": picks, "prompts": prompts, "tokens": tokens,
                "t_done": t2}

    def close(self) -> None:
        for srv in self.servers.values():
            srv.close(deliver=False)
        self.servers.clear()
        del self.model, self.prefill


def serve(state: Cell, plan: list, spans: Spans, give_up_s: float,
          on_batch=None) -> tuple:
    """Serve ``plan`` as its requests arrive: (the open's host time, the
    batches in order, each with the plan's indices of its requests ``idx``
    and each request's time to first token ``ttft_s``).  Requests not
    served ``give_up_s`` after the open are left out."""
    t = state.t
    queues = {n: collections.deque() for n in lengths(t)}
    out, i, served = [], 0, 0
    t_open = time.perf_counter()
    while served < len(plan):
        now = time.perf_counter() - t_open
        if now > give_up_s:
            break
        while i < len(plan) and plan[i]["a"] <= now:
            queues[plan[i]["len"]].append(i)
            i += 1
        heads = [(q[0], n) for n, q in queues.items() if q]
        if not heads:
            time.sleep(max(0.0, plan[i]["a"] - now))
            continue
        n = min(heads)[1]
        q = queues[n]
        k = max(b for b in batch_sizes(t, n) if b <= len(q))
        idx = [q.popleft() for _ in range(k)]
        before = on_batch() if on_batch else None
        started = time.perf_counter() - t_open
        rec = state.batch(n, [plan[j] for j in idx], spans)
        if on_batch:
            after = on_batch()
            rec["launches"] = {x: after[x] - before[x] for x in after}
        rec["idx"] = idx
        rec["t_start"] = started
        rec["ttft_s"] = [rec["t_done"] - t_open - plan[j]["a"] for j in idx]
        out.append(rec)
        served += k
    return t_open, out


def warm_up(state: Cell, seed: int) -> None:
    """Every (batch, length) shape the server can form, once."""
    rng = np.random.default_rng(subseed(seed, 4))
    for n in lengths(state.t):
        for b in batch_sizes(state.t, n):
            reqs = [{"vid": int(v), "frac": float(f)} for v, f in zip(
                rng.integers(0, state.t["store"]["n_versions"], b),
                rng.random(b))]
            state.batch(n, reqs, Spans())


def launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    return {"flash": fa.LAUNCHES}


def sample(requests: list, t: dict, seed: int) -> list:
    """Indices of the requests the reference checks: ``check_longest`` of
    the longest prompts, the rest of ``check_requests`` from all, drawn
    from the seed."""
    rng = np.random.default_rng(subseed(seed, 3))
    top = max(r["len"] for r in requests)
    longest = [i for i, r in enumerate(requests) if r["len"] == top]
    k = min(int(t["check_longest"]), len(longest))
    picked = [longest[i] for i in rng.choice(len(longest), k, replace=False)]
    taken = set(picked)
    rest = [i for i in range(len(requests)) if i not in taken]
    m = min(int(t["check_requests"]) - k, len(rest))
    picked += [rest[i] for i in rng.choice(len(rest), m, replace=False)]
    return sorted(picked)


def reference_logits(c: dict, seed: int, prompts: list, device,
                     ops=None, block_tokens: int = 8192) -> list:
    """The plain reference's last-position logits of each prompt (float32,
    TF32 off), prompts of one length batched up to ``block_tokens``."""
    ref = reference(c)
    w = weights.make(c, seed, device)
    out: list = [None] * len(prompts)
    by_len: dict = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    with ref.no_tf32():
        for n, idx in by_len.items():
            per = max(block_tokens // n, 1)
            for k in range(0, len(idx), per):
                part = idx[k:k + per]
                toks = torch.from_numpy(np.stack([prompts[i] for i in part])
                                        ).to(device)
                lg = ref.last_logits(w, toks, c, ops)[:, :c["vocab"]]
                for i, row in zip(part, lg):
                    out[i] = row.cpu()
    del w
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault=None, control: bool = False) -> dict:
    """One run; ``fault(state)`` breaks the program before set-up (the
    tests' faults), ``control`` also reads the control: the reference in
    float8 in the program's place, its tokens judged as the program's."""
    c, t = cell.config, cell.traffic
    state = Cell(c, t, seed, device)
    if fault is not None:
        fault(state)
    t_warm = time.perf_counter()
    warm_up(state, seed)
    state.phases["warm_s"] = time.perf_counter() - t_warm
    plan = schedule(t, seed, seconds)
    _sync(device)
    spans = Spans()
    l0 = launches()
    t_open, done = serve(state, plan, spans, seconds + float(t["drain_s"]))
    for r in done:
        r["in_window"] = r["t_start"] < seconds
    timed = [r for r in done if r["in_window"]]
    t_close = timed[-1]["t_done"] if timed else time.perf_counter()
    l1 = launches()
    requests = [dict(plan[j], ttft_s=s, batch=k, slot=x)
                for k, r in enumerate(done)
                for x, (j, s) in enumerate(zip(r["idx"], r["ttft_s"]))]
    out = {"t_open": t_open, "window_s": t_close - t_open, "batches": done,
           "requests": requests, "spans": spans, "config": c,
           "trace": None, "traced": [],
           "launches": {k: l1[k] - l0[k] for k in l0},
           "server": {n: dict(waves=s.stats.waves,
                              requeues=s.stats.requeues,
                              degraded_waves=s.stats.degraded_waves)
                      for n, s in state.servers.items()}}
    if trace:
        def slice_():
            sub = schedule(t, seed, float(t["trace_seconds"]), key=2)
            _, recs = serve(state, sub, Spans(),
                            float(t["trace_seconds"]) + float(t["drain_s"]),
                            on_batch=launches)
            return [{"b": r["b"], "s": r["len"], **r["launches"]}
                    for r in recs]
        out["traced"], out["trace"] = traced(slice_, torch)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda"
                                else 0)
    records, rlists, phases = state.records, state.rlists, state.phases
    state.close()
    del state
    _free(device)

    # ---- correctness, after the window and the program's state freed ----
    got, want = [], []
    for r in done:
        for j, (vid, pick) in enumerate(zip(r["vids"], r["picks"])):
            got.append(r["prompts"][j])
            want.append(records[r["len"]][rlists[r["len"]][vid][pick]])
    mism = checks.row_mismatches(got, want)
    unserved = len(plan) - len(requests)
    picked = sample(requests, t, seed)
    prompts = [done[requests[i]["batch"]]["prompts"][requests[i]["slot"]]
               for i in picked]
    served = torch.tensor([int(done[requests[i]["batch"]]["tokens"][
        requests[i]["slot"]]) for i in picked])
    t_ref = time.perf_counter()
    lg = torch.stack(reference_logits(c, seed, prompts, device))
    gaps = checks.token_gaps(lg, served)
    out["reference_s"] = time.perf_counter() - t_ref
    out["checks"] = {
        "prompt_mismatch": (mism + unserved,
                            cell.limits["prompt_mismatch"]),
        "token_gap": (max(gaps), cell.limits["token_gap"])}
    if control:
        ctl = reference_logits(c, seed, prompts, device,
                               ops=reference(c).control_ops())
        ctl_tokens = torch.stack(ctl).argmax(-1)
        out["control_checks"] = {
            "prompt_mismatch": (0, cell.limits["prompt_mismatch"]),
            "token_gap": (max(checks.token_gaps(lg, ctl_tokens)),
                          cell.limits["token_gap"])}
    out["attempted"] = len(plan)
    out["failed"] = mism + unserved
    out["samples"] = {"requests": len(plan), "served": len(requests),
                      "batches": len(done), "window_batches": len(timed),
                      "window_tokens": sum(r["b"] * r["len"] for r in timed),
                      "mean_batch": len(requests) / max(len(done), 1),
                      "checked_tokens": len(picked),
                      "tokens_matching_reference_argmax":
                          sum(g == 0.0 for g in gaps),
                      "setup_phases": phases,
                      "launches": out["launches"], "servers": out["server"]}
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
