"""Readings for the limits of ``correct``, on the card at the cell's own
size, in one process:

    python3 bench/control.py --workload <cell> --seconds 3 \
        --seeds 1,2,...,12 --control-seeds 1,2,3 [--fault half_batch]

For each seed a run of the cell's runner with a short window, each
number compared printed as a JSON line: the program's (the lower
reading), with ``--control-seeds`` also the control's (the reference in
float8 in the program's place: the upper reading), with ``--fault`` the
program with that fault planted (``faults.py``).  The benchmark's own
runs never run this."""
import argparse
import importlib
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
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from bench import faults, manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    runner = importlib.import_module(f"bench.cells.{cell.traffic['kind']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    fault = faults.FAULTS[args.fault] if args.fault else None
    for seed in sorted(set(seeds) | ctl):
        t0 = time.perf_counter()
        out = runner.run(cell, seed, args.seconds, False,
                         torch.device("cuda", 0), fault=fault,
                         control=seed in ctl)
        line = {"seed": seed, "fault": args.fault,
                "program": {k: v for k, (v, _) in out["checks"].items()},
                "control": ({k: v for k, (v, _) in
                             out["control_checks"].items()}
                            if "control_checks" in out else None),
                "samples": out["samples"], "seconds":
                    time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
