#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py [--seed 0] [--waves 16]

Phases, each of which raises on failure:

1. build — compile every CUDA source of the port with nvcc (sm_90a), all in
   parallel, into ``build/kernels/``;
2. kernel vs plain — the CUDA ``checkout_wave`` against its plain torch
   version on the card, whole packed output compared with ``torch.equal``:
   small hand-made plans (run tiles, row tiles, tail-promoted tiles, a stale
   ``hi``) and one full-size wave off the SCI_1M superblock;
3. main path — the versioning benchmark's SCI workload at the paper's
   SCI_1M scale (1,000 versions, 944,685 records of 100 int32 attributes),
   partitioned by LyreSplit at a storage budget of 2|R|, served by a
   pipelined ``BatchedCheckoutServer`` on the card: ``--waves`` waves of 256
   tickets over 32 unique versions each; every ticket is checked bit for bit
   against the numpy gather ``data[rlist(v)]``;
4. timings — per-wave kernel, plain-version, ``torch.index_select`` and
   device-to-host times at the main path's shapes, beside the bandwidth
   bound.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Full per-wave numbers go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result, when
there is no CUDA device or the port's sources are missing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
KERNELS = ["checkout_wave"]


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
    return store


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

    cb.LAUNCHES = 0                          # main path window opens
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
    launches = cb.LAUNCHES                   # main path window closes
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
    store = make_store(np, args.seed, report)
    waves = wave_traffic(np, args.seed, args.waves, store.graph.n_versions)
    phase_main(torch, np, store, waves, report)
    mean = phase_timing(torch, np, store, waves, report)
    if args.profile:
        fresh = wave_traffic(np, args.seed + 1, 8, store.graph.n_versions)
        phase_profile(torch, store, fresh, report, "fresh")
        phase_profile(torch, store, fresh, report, "repeat")
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
        "library_ms": mean["library_ms"]}]}
    print(f"total {report['total_s']:.1f} s")
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
