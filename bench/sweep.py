"""The knee of a serving cell, found once by a sweep on the card:

    python3 bench/sweep.py --workload <cell> --seed <n> \
        --rates 20,40,60 --seconds 15

In one process: set-up as a run makes it, then for each batch shape the
server forms the prefill's tokens a second (the batch alone, three times),
then the cell's open loop at each offered rate for ``--seconds``: the
requests served, the rate achieved, the tails of time to first token and
how long past the last arrival the queue took to drain.  Each reading is
one JSON line.  The benchmark's own runs never run this."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch

    from bench import manifest
    from bench.cells import prefill
    from bench.devtrace import Spans
    from bench.stats import percentile
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    t = cell.traffic
    state = prefill.Cell(cell.config, t, args.seed, torch.device("cuda", 0))
    prefill.warm_up(state, args.seed)
    for n in prefill.lengths(t):
        for b in prefill.batch_sizes(t, n):
            reqs = [{"vid": 0, "frac": 0.5}] * b
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                state.batch(n, reqs, Spans())
                secs.append(time.perf_counter() - t0)
            print(json.dumps({"len": n, "batch": b, "batch_s": secs,
                              "tokens_per_s": n * b / min(secs)}),
                  flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        plan = prefill.schedule({**t, "rate_per_s": rate}, args.seed,
                                args.seconds)
        t_open, done = prefill.serve(state, plan, Spans(),
                                     args.seconds + 30.0)
        ttft = [1e3 * s for r in done for s in r["ttft_s"]]
        served = sum(r["b"] for r in done)
        window = done[-1]["t_done"] - t_open
        print(json.dumps({
            "rate_per_s": rate, "requests": len(plan), "served": served,
            "achieved_per_s": served / window,
            "tokens_per_s": sum(r["b"] * r["len"] for r in done) / window,
            "drain_s": window - plan[-1]["a"],
            "mean_batch": served / len(done),
            "ttft_p50_ms": percentile(ttft, 50),
            "ttft_p95_ms": percentile(ttft, 95),
            "ttft_max_ms": max(ttft)}), flush=True)
    state.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
