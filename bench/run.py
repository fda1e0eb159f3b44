"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the store, the weights, the warm-up of every shape the cell's
traffic uses), then a window of ``--seconds`` of traffic, then the check
of what the window produced against the plain reference.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, read after a traced slice of
traffic), ``device``, ``breakdown`` (traced runs) and last ``checks``,
each compared number beside its limit; the same numbers close standard
error.  It exits non-zero and prints no result without the cards the
cell asks for, or if the process has loaded JAX or the JAX package."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)          # the harness's modules import as bench.<name>
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))


def result_line(cell, out: dict, trace: bool, device_kind: str) -> dict:
    from bench import manifest
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": all(v <= lim for v, lim in out["checks"].values()),
            "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": device}
    if trace:
        t = out["trace"]
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = {"device_ops": t.device_ops(),
                             "idle_gaps": t.idle_gaps()}
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in out["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness, manifest
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    runner = importlib.import_module(f"bench.cells.{cell.traffic['kind']}")
    started = time.perf_counter() - T_START
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    out["setup_s"] = out["t_open"] - T_START
    out["samples"]["setup_phases"]["start_s"] = started
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(0))
    print(json.dumps({"samples": out["samples"],
                      "reference_s": out["reference_s"],
                      "setup_s": out["setup_s"],
                      "window_s": out["window_s"]}))
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
