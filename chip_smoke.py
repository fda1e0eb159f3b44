#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py [--seed 0] [--waves 16] [--profile] [--min-waves 6]

Phases, each of which raises on failure:

1. build — compile every CUDA source of the port with nvcc (sm_90a), all in
   parallel, into ``build/kernels/``;
2. kernel vs plain — each CUDA kernel against its plain torch version on
   the card, whole output compared with ``torch.equal``, on small
   hand-made plans: ``checkout_wave`` (run tiles, row tiles, tail-promoted
   tiles, a stale ``hi``), ``segment_append`` and ``segment_move`` (mixed
   sel, runs ending at the last rows of a source, all-delta and all-pad
   plans; an out-of-bounds run must raise ValueError);
3. read path — the versioning benchmark's SCI workload at the paper's
   SCI_1M scale (1,000 versions, 944,685 records of 100 int32 attributes),
   partitioned by LyreSplit at a storage budget of 2|R|, served by a
   pipelined ``BatchedCheckoutServer`` on the card: ``--waves`` waves of 256
   tickets over 32 unique versions each; every ticket is checked bit for bit
   against the numpy gather ``data[rlist(v)]``;
4. read timings — per-wave kernel, plain-version, ``torch.index_select``
   and device-to-host times at the read path's shapes, beside the
   bandwidth bound;
5. write path — the same workload's first 900 versions as a LyreSplit
   store on the card behind a pipelined server with a
   ``RepartitionTrigger``; versions 900-999 arrive as write waves of 16
   commits (``submit_commit`` -> ``commit_many`` -> ``segment_append``),
   each followed by a read wave that includes versions just committed;
   the trigger fires one density-triggered migration (LyreSplit ->
   ``apply_migration`` -> ``migrate_superblock`` -> ``segment_move``), and
   4 more read waves follow; every ticket and the final CSR are checked;
6. write timings — ``segment_append`` at the shapes of one real write wave
   and ``segment_move`` at the real migration's, kernel against plain
   version, ``torch.index_select`` and the bandwidth bound.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Full per-wave numbers go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result, when
there is no CUDA device or the port's sources are missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
KERNELS = ["checkout_wave", "segment_append", "segment_move"]
WRITE_BASE = 900         # versions in the write phase's starting store
WRITE_WAVE = 16          # commits per write wave
# the write phase's RepartitionTrigger: every wave below density 1.0 counts
# toward the streak, so it fires on a wave count: 6 read waves in a row fire
# LyreSplit once, after the 6th write wave, and the 5 read waves left cannot
# fire it again (``--min-waves`` changes the count; see PERF.md)
TRIGGER = {"min_waves": 6, "low_density": 1.0, "min_gain": 1.02}


def gpu_line(torch) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(report: dict) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    report["build_s"] = time.perf_counter() - t0
    for name in KERNELS:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {KERNELS} in {report['build_s']:.2f} s")


def small_plan_cases(torch, np):
    """Hand-made plans over a small superblock: run tiles, row tiles,
    tail-promoted tiles, and a deliberately stale ``hi``."""
    bn = 8
    cases = []
    for dtype, d in ((torch.int32, 128), (torch.float32, 512),
                     (torch.int16, 256)):
        r = 96
        gen = torch.Generator().manual_seed(d)
        data = torch.randint(-1000, 1000, (r, d), generator=gen).to(dtype)
        starts = np.concatenate([
            np.arange(0, 8),                      # run tile
            np.array([3, 17, 5, 90, 2, 2, 64, 1]),  # row tile
            np.array([40, 41, 42, 43, 43, 43, 43, 43]),  # tail, promoted
            np.arange(88, 96),                    # run ending at R
            np.array([50, 51, 52, 53, 53, 53, 53, 53]),  # stale hi -> rows
        ]).astype(np.int32)
        mode = np.array([1, 0, 1, 1, 1], np.int32)
        hi = np.array([48, 96, 48, 96, 56], np.int32)  # last: 50+8 > 56
        cases.append((f"{dtype}-D{d}", data, starts, mode, hi, bn))
    return cases


def phase_small(torch, np, report: dict) -> None:
    from repro_torch.kernels import checkout_batched as cb
    cases = small_plan_cases(torch, np)
    for name, data, starts, mode, hi, bn in cases:
        dev = data.cuda()
        s, m, h = (torch.from_numpy(a).cuda() for a in (starts, mode, hi))
        got = cb.checkout_wave(dev, s, m, h, block_n=bn)
        want = cb.checkout_wave_plain(dev, s, m, h, block_n=bn)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"checkout_wave != plain on case {name}")
        # the stale-hi tile must have gathered rows (50..53, then 53s),
        # not the run 50..57
        ref = data[torch.from_numpy(starts[32:40]).long()]
        if not torch.equal(got[32:40].cpu(), ref):
            raise AssertionError(f"stale hi did not degrade on {name}")
    report["small_cases"] = len(cases)
    print(f"kernel vs plain: {report['small_cases']} hand-made plans equal")


def segment_plan_cases(np):
    """Hand-made (kernel, sel, starts) plans over a 96-row src and a 40-row
    delta: mixed sel with runs ending at the last BN rows of each source
    and an unaligned start, an all-delta plan, an all-pad plan; then the
    out-of-bounds plans that must raise."""
    i32 = functools.partial(np.array, dtype=np.int32)
    ok = [
        ("segment_append", i32([0, 1, 2, 0, 1, 0, 2, 1]),
         i32([0, 8, 0, 88, 32, 5, 77, 3])),
        ("segment_append", i32([1] * 5), i32([0, 8, 16, 24, 32])),
        ("segment_append", i32([2] * 4), i32([0] * 4)),
        ("segment_move", i32([0, 1, 0, 1, 1, 0]), i32([88, 32, 0, 3, 0, 41])),
        ("segment_move", i32([1] * 5), i32([32, 24, 16, 8, 0])),
    ]
    bad = [("segment_append", i32([0, 0]), i32([0, 89])),
           ("segment_append", i32([1, 2]), i32([33, 0])),
           ("segment_append", i32([0, 3]), i32([0, 0])),
           ("segment_move", i32([0, 1]), i32([-1, 0])),
           ("segment_move", i32([1, 0]), i32([33, 0]))]
    return ok, bad


def phase_segments(torch, np, report: dict) -> None:
    """Both segment kernels against their plain versions on hand-made
    plans, in int32 (D=128), float32 (D=512) and int16 (D=256)."""
    from repro_torch.kernels import segment_append as sa
    from repro_torch.kernels import segment_move as sm
    kernels = {"segment_append": (sa.segment_append, sa.segment_append_plain),
               "segment_move": (sm.segment_move, sm.segment_move_plain)}
    ok, bad = segment_plan_cases(np)
    n = 0
    for dtype, d in ((torch.int32, 128), (torch.float32, 512),
                     (torch.int16, 256)):
        gen = torch.Generator().manual_seed(d)
        src = torch.randint(-1000, 1000, (96, d), generator=gen).to(dtype)
        delta = torch.randint(-1000, 1000, (40, d), generator=gen).to(dtype)
        src, delta = src.cuda(), delta.cuda()
        for name, sel, starts in ok:
            kernel, plain = kernels[name]
            got = kernel(src, delta, sel, starts)
            want = plain(src, delta, torch.from_numpy(sel).cuda(),
                         torch.from_numpy(starts).cuda())
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain on {dtype}-D{d} "
                                     f"sel={sel.tolist()}")
            n += 1
        for name, sel, starts in bad:
            try:
                kernels[name][0](src, delta, sel, starts)
            except ValueError:
                n += 1
                continue
            raise AssertionError(f"{name} ran an out-of-bounds plan "
                                 f"sel={sel.tolist()} starts={starts.tolist()}")
    report["segment_small_cases"] = n
    print(f"segment kernels vs plain: {n} hand-made plans equal or refused")


def make_store(np, seed: int, report: dict):
    from repro_torch.core import (generate, lyresplit_for_budget,
                                  store_from_arrays, to_tree)
    t0 = time.perf_counter()
    w = generate("SCI", n_versions=1000, inserts=630, n_branches=100,
                 n_attrs=100, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    split = lyresplit_for_budget(tree, 2 * w.n_records)
    store = store_from_arrays(w.graph.indptr, w.graph.indices, w.n_records,
                              w.data, split.best.assignment, device="cuda")
    report["setup_s"] = time.perf_counter() - t0
    report["store"] = {"versions": w.n_versions, "records": w.n_records,
                       "memberships": w.n_edges,
                       "partitions": len(store.partitions),
                       "stored_rows": store.storage_cost()}
    print(f"store: {report['store']} built in {report['setup_s']:.1f} s")
    return store, w, tree


def wave_traffic(np, seed: int, n_waves: int, n_versions: int):
    """Duplicate-heavy waves: 256 tickets over 32 unique versions each."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        uniq = rng.choice(n_versions, 32, replace=False)
        tickets = np.concatenate([uniq, rng.choice(uniq, 256 - 32)])
        waves.append(rng.permutation(tickets).tolist())
    return waves


def phase_main(torch, np, store, waves, report: dict) -> None:
    """The main path: a pipelined server on the card, every ticket checked
    against the numpy gather of the store's record pool."""
    from repro_torch.core.checkout import peek_superblock
    from repro_torch.kernels import checkout_batched as cb
    from repro_torch.kernels import segment_append as sa
    from repro_torch.kernels import segment_move as sm
    from repro_torch.serve import BatchedCheckoutServer
    # the server's latency clock stops while the client checks results,
    # so ticket latencies measure the server alone
    paused = [0.0]
    srv = BatchedCheckoutServer(
        store, pipeline=True, clock=lambda: time.monotonic() - paused[0])
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    report["warmup_s"] = time.perf_counter() - t0
    checked = 0
    serve_s = 0.0

    def check(delivered, vids):
        nonlocal checked
        t_check = time.monotonic()
        oracle = {}
        for m, v in zip(delivered, vids):
            want = oracle.get(v)
            if want is None:
                want = oracle[v] = (m, store.data[store.graph.rlist(v)])
                if not np.array_equal(m, want[1]):
                    raise AssertionError(f"ticket for version {v} differs "
                                         "from data[rlist(v)]")
            elif m is not want[0] and not np.array_equal(m, want[1]):
                raise AssertionError(f"ticket for version {v} differs")
            checked += 1
        paused[0] += time.monotonic() - t_check

    sa.LAUNCHES = sm.LAUNCHES = cb.LAUNCHES = 0   # read path window opens
    t_wall = time.perf_counter()
    prev = None
    flush_ms = []
    for vids in waves:
        t = time.perf_counter()
        srv.submit_many(vids)
        delivered = srv.flush()
        flush_ms.append(1e3 * (time.perf_counter() - t))
        serve_s += flush_ms[-1] / 1e3
        if prev is not None:
            check(delivered, prev)
        prev = vids
    t = time.perf_counter()
    delivered = srv.deliver()
    serve_s += time.perf_counter() - t
    check(delivered, prev)
    wall_s = time.perf_counter() - t_wall
    launches = cb.LAUNCHES                   # read path window closes
    if sa.LAUNCHES or sm.LAUNCHES:
        raise AssertionError("the read path launched a segment kernel")
    srv.close()
    sb = peek_superblock(store)
    st = srv.stats
    if launches < len(waves):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(waves)} waves")
    if sb is None or sb.uploads != 1:
        raise AssertionError("superblock was not uploaded exactly once")
    if st.degraded_waves or st.requeues or checked != 256 * len(waves):
        raise AssertionError(f"serve stats off: {st}, checked {checked}")
    lease = getattr(store, "_read_leases", None)
    if int(store._inflight_waves) != 0 or (lease and lease.held()):
        raise AssertionError("read leases not balanced after close")
    report["main"] = {
        "waves": len(waves), "tickets": checked, "launches": launches,
        "uploads": sb.uploads, "degraded_waves": st.degraded_waves,
        "rows_served": st.rows_served, "serve_s": serve_s,
        "wall_s_with_checks": wall_s,
        "ms_per_wave_serve": 1e3 * serve_s / len(waves),
        "flush_ms": flush_ms,
        "tickets_per_s_serve": checked / serve_s,
        "p50_ticket_latency_ms": 1e3 * st.p50_latency_s,
        "max_ticket_latency_ms": 1e3 * st.max_latency_s,
        "superblock_bytes": int(sb.host.nbytes)}
    print(f"main path: {checked} tickets in {len(waves)} waves bit-identical"
          f"; launches={launches} uploads={sb.uploads} "
          f"degraded_waves={st.degraded_waves}")
    print(f"serve: {report['main']['ms_per_wave_serve']:.2f} ms/wave, "
          f"{report['main']['tickets_per_s_serve']:.0f} tickets/s, "
          f"p50 ticket latency {report['main']['p50_ticket_latency_ms']:.2f}"
          f" ms, max {report['main']['max_ticket_latency_ms']:.2f} ms "
          f"(host clock, client checks excluded)")


def phase_timing(torch, np, store, waves, report: dict) -> dict:
    """Per-wave device times at the main path's shapes, after the run:
    kernel, plain version, index_select yardstick, device-to-host copy; and
    the full-size kernel-vs-plain comparison on every wave."""
    from repro_torch.core.checkout import peek_superblock, plan_wave
    from repro_torch.kernels import checkout_batched as cb
    sb = peek_superblock(store)
    data = sb.device()
    row_bytes = data.shape[1] * data.element_size()
    per_wave = []
    for vids in waves:
        uniq = sorted(set(vids))
        t_plan = time.perf_counter()
        wp = plan_wave(store, uniq, sb)
        plan_ms = 1e3 * (time.perf_counter() - t_plan)
        s, m, h = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
                   for a in (wp.plan.starts, wp.plan.mode, wp.hi))
        got = cb.checkout_wave(data, s, m, h, block_n=sb.block_n)
        want = cb.checkout_wave_plain(data, s, m, h, block_n=sb.block_n)
        if not torch.equal(got, want):
            raise AssertionError("full-size checkout_wave != plain")
        err = int((got.long() - want.long()).abs().max())
        t = int(m.shape[0])
        src = cb.source_rows(s, m, h, block_n=sb.block_n)
        unique_rows = int(torch.unique(src).numel())
        s_long = s.long()
        del want
        out_bytes = t * sb.block_n * row_bytes
        plan_bytes = 4 * (t * sb.block_n + 2 * t)
        bytes_min = unique_rows * row_bytes + out_bytes + plan_bytes
        host = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
        w = {"tiles": t, "run_tiles": int(m.sum()), "max_abs_err": err,
             "plan_host_ms": plan_ms,
             "out_bytes": out_bytes, "unique_rows_read": unique_rows,
             "bytes_min": bytes_min,
             "bound_ms": 1e3 * bytes_min / HBM_BYTES_PER_S,
             "ms": cuda_ms(torch, lambda: cb.checkout_wave(
                 data, s, m, h, block_n=sb.block_n), 5),
             "plain_ms": cuda_ms(torch, lambda: cb.checkout_wave_plain(
                 data, s, m, h, block_n=sb.block_n), 2),
             "library_ms": cuda_ms(torch, lambda: torch.index_select(
                 data, 0, s_long), 5),
             "d2h_ms": cuda_ms(torch, lambda: host.copy_(
                 got, non_blocking=True), 2)}
        per_wave.append(w)
        del got, host
    torch.cuda.synchronize()
    mean = {k: float(np.mean([w[k] for w in per_wave]))
            for k in per_wave[0]}
    report["per_wave"] = per_wave
    report["per_wave_mean"] = mean
    print(f"per wave (mean of {len(per_wave)}): kernel {mean['ms']:.3f} ms, "
          f"plain {mean['plain_ms']:.3f} ms, index_select "
          f"{mean['library_ms']:.3f} ms, bound {mean['bound_ms']:.3f} ms, "
          f"D2H {mean['d2h_ms']:.3f} ms, plan_wave on the host "
          f"{mean['plan_host_ms']:.2f} ms, "
          f"{mean['out_bytes'] / 1e6:.1f} MB out")
    return mean


def read_wave_vids(np, rng, n_versions: int, fresh=()):
    """256 tickets over 32 unique versions drawn from ``n_versions``,
    including (up to) 4 of the versions ``fresh`` just committed."""
    new = rng.choice(np.asarray(fresh, np.int64), min(4, len(fresh)),
                     replace=False)
    rest = rng.choice(np.setdiff1d(np.arange(n_versions), new),
                      32 - len(new), replace=False)
    uniq = np.concatenate([new, rest])
    tickets = np.concatenate([uniq, rng.choice(uniq, 256 - 32)])
    return rng.permutation(tickets).tolist()


def phase_write(torch, np, w, tree, seed: int, trigger_kw: dict,
                report: dict) -> dict:
    """The online write path at full width: write waves of ``WRITE_WAVE``
    commits land through ``segment_append``, a read wave follows each, the
    density trigger migrates once through ``segment_move``, and 4 read
    waves follow.  Returns the first write wave's and the migration's
    kernel inputs, captured for ``phase_write_timing``."""
    from repro_torch.core import checkout as ck
    from repro_torch.core import lyresplit_for_budget, store_from_arrays
    from repro_torch.core.online import RepartitionTrigger
    from repro_torch.core.version_graph import WeightedTree
    from repro_torch.kernels import checkout_batched as cb
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_append as sa
    from repro_torch.kernels import segment_move as sm
    from repro_torch.serve import BatchedCheckoutServer
    t0 = time.perf_counter()
    n0 = WRITE_BASE
    ip, ind = w.graph.indptr, w.graph.indices
    pool = int(ind[:ip[n0]].max()) + 1     # records the first n0 versions own
    base_tree = WeightedTree(parent=tree.parent[:n0].copy(),
                             n_records=tree.n_records[:n0].copy(),
                             edge_w=tree.edge_w[:n0].copy())
    split = lyresplit_for_budget(base_tree, 2 * pool)
    store = store_from_arrays(ip[:n0 + 1], ind[:ip[n0]], pool, w.data[:pool],
                              split.best.assignment, device="cuda")
    trigger = RepartitionTrigger(store, base_tree, **trigger_kw)
    srv = BatchedCheckoutServer(store, pipeline=True, trigger=trigger)
    srv.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"write store: {n0} versions, {pool} records, "
          f"{len(store.partitions)} partitions, built in {setup_s:.1f} s")

    captured: dict = {}
    extensions: list = []
    real = {"segment_append": ops.segment_append,
            "segment_move": ops.segment_move}
    real_extend = ck.extend_superblock_after_commit

    def capture(name):
        def wrapped(src, delta, sel, starts, **kw):
            if name not in captured:        # the first call of each kernel
                captured[name] = {
                    "src": src, "sel": np.array(sel),
                    "starts": np.array(starts),
                    "delta": None if delta is None else np.array(delta)}
            return real[name](src, delta, sel, starts, **kw)
        return wrapped

    def extend(*args, **kwargs):
        new_sb, st = real_extend(*args, **kwargs)
        extensions.append(st)
        return new_sb, st

    rng = np.random.default_rng(seed + 2)
    checked = 0

    def check(delivered, vids):
        nonlocal checked
        oracle: dict = {}
        for m, v in zip(delivered, vids):
            want = oracle.get(v)
            if want is None or m is not want[0]:
                ref = want[1] if want is not None \
                    else w.data[w.graph.rlist(v)]
                if not np.array_equal(m, ref):
                    raise AssertionError(f"write phase: ticket for version "
                                         f"{v} differs from data[rlist(v)]")
                oracle[v] = (m, ref)
            checked += 1

    def read_wave(vids):
        tickets = srv.submit_many(vids)
        srv.flush()                 # dispatch; nothing else is in flight
        srv.deliver()               # join; the trigger observes here
        check([srv.result(t) for t in tickets], vids)

    ops.segment_append = capture("segment_append")
    ops.segment_move = capture("segment_move")
    ck.extend_superblock_after_commit = extend
    evictions0 = getattr(store, "_superblock_evictions", 0)
    commit_ms, write_vids, cur = [], [], pool
    try:
        cb.LAUNCHES = sa.LAUNCHES = sm.LAUNCHES = 0   # write path window
        t_wall = time.perf_counter()
        for lo in range(n0, w.n_versions, WRITE_WAVE):
            vs = list(range(lo, min(lo + WRITE_WAVE, w.n_versions)))
            commits = []
            for v in vs:
                # the generator allocates rids densely in version order:
                # a version's fresh rids are those past the pool before it
                rl = w.graph.rlist(v)
                fresh = rl[rl >= cur]
                commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                                "new_rows": w.data[fresh]})
                cur += len(fresh)
            tickets = srv.submit_commit(commits)
            t = time.perf_counter()
            srv.flush()             # the write wave lands as commit_many
            torch.cuda.synchronize()
            commit_ms.append(1e3 * (time.perf_counter() - t))
            got = [int(srv.result(k)) for k in tickets]
            if got != vs:
                raise AssertionError(f"write tickets gave {got}, not {vs}")
            write_vids += got
            sb = ck.peek_superblock(store)
            if (sb is None or sb._device is None or sb.epoch != store.epoch
                    or sb._device.device.type != store.device.type):
                raise AssertionError("no device superblock at the store's "
                                     "epoch after a write wave")
            if getattr(store, "_superblock_evictions", 0) != evictions0:
                raise AssertionError("a write wave evicted the superblock")
            read_wave(read_wave_vids(np, rng, vs[-1] + 1, vs))
        if not trigger.reports:
            raise AssertionError("the trigger did not fire in the write "
                                 "phase")
        prev = None                 # 4 pipelined read waves after it
        for _ in range(4):
            vids = read_wave_vids(np, rng, w.n_versions)
            srv.submit_many(vids)
            out = srv.flush()
            if prev is not None:
                check(out, prev)
            prev = vids
        check(srv.deliver(), prev)
        wall_s = time.perf_counter() - t_wall
        launches = {"checkout_wave": cb.LAUNCHES,
                    "segment_append": sa.LAUNCHES,
                    "segment_move": sm.LAUNCHES}    # window closes
    finally:
        ops.segment_append = real["segment_append"]
        ops.segment_move = real["segment_move"]
        ck.extend_superblock_after_commit = real_extend
    srv.close()
    n_write = len(commit_ms)
    n_read = n_write + 4
    st = srv.stats
    rep = trigger.reports[0]
    mig = rep.superblock
    if write_vids != list(range(n0, w.n_versions)):
        raise AssertionError("write tickets did not return the versions "
                             "in order")
    if not (np.array_equal(store.graph.indptr, w.graph.indptr)
            and np.array_equal(store.graph.indices, w.graph.indices)
            and store.graph.n_records == w.n_records):
        raise AssertionError("the store's CSR differs from the workload's")
    if launches["segment_append"] != n_write:
        raise AssertionError(f"segment_append launched "
                             f"{launches['segment_append']} times for "
                             f"{n_write} write waves")
    if len(trigger.reports) != 1 or st.repartitions != 1:
        raise AssertionError(
            f"{len(trigger.reports)} migrations fired, not exactly one, at "
            f"density-stats waves {[r.at_wave for r in trigger.reports]}")
    if mig is None or not mig.used_device or mig.reused_tiles <= 0:
        raise AssertionError(f"the migration did not reuse device tiles: "
                             f"{mig}")
    if launches["segment_move"] != 1:
        raise AssertionError(f"segment_move launched "
                             f"{launches['segment_move']} times, not once")
    if launches["checkout_wave"] < n_read:
        raise AssertionError(f"checkout_wave launched "
                             f"{launches['checkout_wave']} times for "
                             f"{n_read} read waves")
    if (checked != 256 * n_read or st.degraded_waves or st.requeues
            or st.commit_waves != n_write
            or st.commits_ingested != len(write_vids)):
        raise AssertionError(f"write phase stats off: {st}, checked "
                             f"{checked}")
    lease = getattr(store, "_read_leases", None)
    if int(store._inflight_waves) != 0 or (lease and lease.held()):
        raise AssertionError("read leases not balanced after close")
    report["write"] = {
        "trigger": trigger_kw, "setup_s": setup_s, "write_waves": n_write,
        "commits": len(write_vids), "read_waves": n_read,
        "tickets": checked, "launches": launches, "wall_s": wall_s,
        "commit_wave_ms": commit_ms,
        "extension_host_ms": [1e3 * e.wall_s for e in extensions],
        "extensions": [dataclasses.asdict(e) for e in extensions],
        "migration": {k: v for k, v in dataclasses.asdict(rep).items()
                      if k != "superblock"},
        "migration_superblock": dataclasses.asdict(mig),
        "partitions_after": len(store.partitions),
        "superblock_bytes": int(ck.peek_superblock(store).host.nbytes)}
    print(f"write path: {len(write_vids)} commits in {n_write} write waves, "
          f"{checked} tickets in {n_read} read waves bit-identical; "
          f"launches={launches}")
    print(f"write waves (host clock, commit_many + superblock extension): "
          f"{' '.join(f'{m:.0f}' for m in commit_ms)} ms; of which the "
          f"extension (plan + host mirror + launch) "
          f"{' '.join(f'{1e3 * e.wall_s:.0f}' for e in extensions)} ms")
    print(f"migration at wave {rep.at_wave}: {rep.n_partitions_before} -> "
          f"{rep.n_partitions_after} partitions, {rep.wall_s * 1e3:.0f} ms "
          f"host (LyreSplit + plan + apply + superblock), superblock "
          f"{mig.wall_s * 1e3:.0f} ms, {mig.reused_tiles}/{mig.n_tiles} "
          f"tiles reused, {mig.bytes_uploaded / 1e6:.1f} MB uploaded")
    return captured


def phase_write_timing(torch, np, captured: dict, report: dict) -> dict:
    """Each segment kernel at the shapes the write path gave it (the first
    write wave, the migration): kernel against plain version on the full
    inputs, then kernel, plain, ``torch.index_select`` over a pre-built
    ``[src; delta; zero tile]`` (the cat happens before the timed window),
    the bandwidth bound, and the delta's host-to-device upload as the path
    makes it (pageable)."""
    from repro_torch.kernels import segment_append as sa
    from repro_torch.kernels import segment_move as sm
    out = {}
    for name, mod, plain, pad in (
            ("segment_append", sa, sa.segment_append_plain, True),
            ("segment_move", sm, sm.segment_move_plain, False)):
        c = captured[name]
        src = c["src"]
        bn = 8
        delta = (src.new_zeros((bn, src.shape[1])) if c["delta"] is None
                 else torch.from_numpy(c["delta"]).cuda())
        sel_d, starts_d = sa.upload(src.device, c["sel"], c["starts"])
        got = mod._launch(src, delta, sel_d, starts_d, bn)
        want = plain(src, delta, sel_d, starts_d, block_n=bn)
        err = 0 if torch.equal(got, want) else \
            int((got.double() - want.double()).abs().max())
        if err:
            raise AssertionError(f"full-size {name} != plain (max abs "
                                 f"err {err})")
        del got, want
        t = len(c["sel"])
        row_bytes = src.shape[1] * src.element_size()
        reads = int((c["sel"] != 2).sum()) if pad else t
        bytes_min = (reads + t) * bn * row_bytes + 8 * t
        rows = sa.source_rows(sel_d, starts_d, src.shape[0], delta.shape[0],
                              block_n=bn, pad=pad)
        stack = torch.cat([src, delta, src.new_zeros((bn, src.shape[1]))])
        out[name] = {
            "tiles": t, "reused_tiles": int((c["sel"] == 0).sum()),
            "delta_tiles": int((c["sel"] == 1).sum()),
            "pad_tiles": int((c["sel"] == 2).sum()) if pad else 0,
            "bytes_min": bytes_min, "max_abs_err": err,
            "bound_ms": 1e3 * bytes_min / HBM_BYTES_PER_S,
            "ms": cuda_ms(torch, lambda: mod._launch(
                src, delta, sel_d, starts_d, bn), 5),
            "plain_ms": cuda_ms(torch, lambda: plain(
                src, delta, sel_d, starts_d, block_n=bn), 2),
            "library_ms": cuda_ms(torch, lambda: torch.index_select(
                stack, 0, rows), 5),
            "delta_bytes": 0 if c["delta"] is None else c["delta"].nbytes,
            "upload_ms": 0.0 if c["delta"] is None else cuda_ms(
                torch, lambda: torch.from_numpy(c["delta"]).to(src.device),
                3)}
        del stack, rows
        o = out[name]
        print(f"{name} ({t} tiles, {bytes_min / 1e6:.0f} MB moved): kernel "
              f"{o['ms']:.3f} ms, plain {o['plain_ms']:.3f} ms, "
              f"index_select {o['library_ms']:.3f} ms, bound "
              f"{o['bound_ms']:.3f} ms; delta upload "
              f"{o['delta_bytes'] / 1e6:.1f} MB in {o['upload_ms']:.3f} ms")
    captured.clear()
    torch.cuda.synchronize()
    report["write_timing"] = out
    return out


def phase_profile(torch, store, waves, report: dict, label: str) -> None:
    """Device busy share and device time by op over served waves, read off
    a torch.profiler trace (written to chiprun_out/chip_smoke_trace_<label>
    .json).  Fresh traffic plans every wave on the host; traffic served
    again hits the plan memo."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import BatchedCheckoutServer
    srv = BatchedCheckoutServer(store, pipeline=True)
    srv.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for vids in waves:
            srv.submit_many(vids)
            srv.flush()
        srv.deliver()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    srv.close()
    out = ROOT / "chiprun_out" / f"chip_smoke_trace_{label}.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, cur = 0.0, None          # union of device intervals
    by_op: dict = {}
    for s0, s1, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (s1 - s0) / 1e3
        if cur is None or s0 > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [s0, s1]
        else:
            cur[1] = max(cur[1], s1)
    busy_ms = (busy_us + cur[1] - cur[0]) / 1e3
    rows = sorted(by_op.items(), key=lambda kv: -kv[1])
    report[f"profile_{label}"] = {"waves": len(waves), "wall_ms": wall_ms,
                         "device_busy_ms": busy_ms,
                         "device_busy_share": busy_ms / wall_ms,
                         "device_ms_by_op": rows}
    print(f"profile ({label}): {len(waves)} waves in {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for name, ms in rows:
        print(f"  {ms:9.3f} ms  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--waves", type=int, default=16)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 8 fresh served waves, then the same 8 "
                    "served again (memoized plans), with torch.profiler")
    ap.add_argument("--min-waves", type=int, default=TRIGGER["min_waves"],
                    help="the write phase trigger's streak length; the "
                    "phase checks that exactly one migration fires")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's sources are missing ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2
    report: dict = {"seed": args.seed, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    t_all = time.perf_counter()
    gpu = gpu_line(torch)
    report["gpu"] = gpu
    phase_build(report)
    phase_small(torch, np, report)
    phase_segments(torch, np, report)
    store, w, tree = make_store(np, args.seed, report)
    waves = wave_traffic(np, args.seed, args.waves, store.graph.n_versions)
    phase_main(torch, np, store, waves, report)
    mean = phase_timing(torch, np, store, waves, report)
    if args.profile:
        fresh = wave_traffic(np, args.seed + 1, 8, store.graph.n_versions)
        phase_profile(torch, store, fresh, report, "fresh")
        phase_profile(torch, store, fresh, report, "repeat")
    del store                   # the read path's store and superblock go
    gc.collect()
    torch.cuda.empty_cache()
    captured = phase_write(torch, np, w, tree, args.seed,
                           dict(TRIGGER, min_waves=args.min_waves), report)
    seg = phase_write_timing(torch, np, captured, report)
    report["total_s"] = time.perf_counter() - t_all
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    kernels = {"kernels": [{
        "name": "checkout_wave", "route": "cuda",
        "source": "src/repro_torch/csrc/checkout_wave.cu",
        "replaces": "src/repro/kernels/checkout_batched.py:210",
        "launches": report["main"]["launches"],
        "max_abs_err": max(w["max_abs_err"] for w in report["per_wave"]),
        "ms": mean["ms"], "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"], "bound_by": "bytes",
        "library_ms": mean["library_ms"]}] + [{
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": report["write"]["launches"][name],
            "max_abs_err": seg[name]["max_abs_err"], "ms": seg[name]["ms"],
            "plain_ms": seg[name]["plain_ms"],
            "bound_ms": seg[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": seg[name]["library_ms"]}
            for name, replaces in (
                ("segment_append", "src/repro/kernels/segment_append.py:71"),
                ("segment_move", "src/repro/kernels/segment_move.py:67"))]}
    print(f"total {report['total_s']:.1f} s")
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
