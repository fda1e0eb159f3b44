"""Per-op attribution of a cell's roofline byte and FLOP terms: the port of
``src/repro/launch/hlo_breakdown.py``.

The dry run gives one ``memory_s`` a cell; this runs the same counted step
(``launch.dryrun.cell_step`` on ``meta``) and adds each op's bytes and FLOPs
up by ``"<aten op> <result shape>"``, the keys ``launch.op_count.analyze``
hands its ``attribute``, so that every hypothesis about where a step's
bytes go starts from the count.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.op_breakdown \\
        --arch phi3_medium_14b --shape train_4k --top 25
"""
from __future__ import annotations

import argparse
import collections

from .op_count import analyze


def breakdown(fn, *args) -> tuple[collections.Counter, collections.Counter]:
    """(bytes_by_key, flops_by_key) of ``fn(*args)``; the keys and sums are
    ``op_count.analyze``'s, op for op."""
    by_bytes: collections.Counter = collections.Counter()
    by_flops: collections.Counter = collections.Counter()

    def attribute(key: str, b: float, f: float = 0.0) -> None:
        by_bytes[key] += int(b)
        if f:
            by_flops[key] += int(f)

    analyze(fn, *args, attribute=attribute)
    return by_bytes, by_flops


def report(by_bytes, by_flops, title: str, top: int) -> str:
    """The top ``top`` keys by bytes with their cumulative shares, and the
    top 10 by FLOPs."""
    tot_b = sum(by_bytes.values())
    tot_f = sum(by_flops.values())
    out = [f"== {title}: total bytes {tot_b:.3e}  flops {tot_f:.3e}",
           f"\n-- top {top} by bytes --"]
    cum = 0
    for key, b in by_bytes.most_common(top):
        cum += b
        out.append(f"{b:12.3e}  ({b / max(tot_b, 1) * 100:5.1f}% cum "
                   f"{cum / max(tot_b, 1) * 100:5.1f}%)  {key}")
    out.append("\n-- top 10 by flops --")
    for key, f in by_flops.most_common(10):
        out.append(f"{f:12.3e}  ({f / max(tot_f, 1) * 100:5.1f}%)  {key}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    from .. import configs
    from ..models.transformer import abstract_params
    from .dryrun import cell_step

    arch = configs.canonical(args.arch)
    cfg = configs.get(arch)
    _, step, step_args = cell_step(cfg, args.shape, abstract_params(cfg))
    by_bytes, by_flops = breakdown(step, *step_args)
    print(report(by_bytes, by_flops, f"{arch} {args.shape} host", args.top))


if __name__ == "__main__":
    main()
