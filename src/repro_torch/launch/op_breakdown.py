"""Per-op attribution of a cell's roofline byte and FLOP terms: the port of
``src/repro/launch/hlo_breakdown.py``.

The dry run gives one ``memory_s`` a cell; this runs the same counted step
(``launch.dryrun.count_cell`` on ``meta``) and adds each op's bytes and
FLOPs up by ``"<aten op> <result shape>"``, the keys
``launch.op_count.analyze`` hands its ``attribute``, so that every
hypothesis about where a step's bytes go starts from the count.  On a
production mesh (``--mesh single|multi``: rank 0's step under the counting
group) it also lists the rank's collectives by kind: calls and result
bytes, apart from the HBM bytes.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.op_breakdown \\
        --arch phi3_medium_14b --shape train_4k --mesh single --top 25
"""
from __future__ import annotations

import argparse
import collections

from .op_count import analyze


def attribution() -> tuple:
    """(bytes_by_key, flops_by_key, the ``attribute`` that fills them)."""
    by_bytes: collections.Counter = collections.Counter()
    by_flops: collections.Counter = collections.Counter()

    def attribute(key: str, b: float, f: float = 0.0) -> None:
        by_bytes[key] += int(b)
        if f:
            by_flops[key] += int(f)

    return by_bytes, by_flops, attribute


def breakdown(fn, *args) -> tuple[collections.Counter, collections.Counter]:
    """(bytes_by_key, flops_by_key) of ``fn(*args)``; the keys and sums are
    ``op_count.analyze``'s, op for op."""
    by_bytes, by_flops, attribute = attribution()
    analyze(fn, *args, attribute=attribute)
    return by_bytes, by_flops


def collectives(by_kind: dict, calls: dict) -> str:
    """The collectives by kind: result bytes, their share and calls."""
    tot = sum(by_kind.values())
    out = ["\n-- collectives by kind (result bytes) --"]
    for kind, b in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        out.append(f"{b:12.3e}  ({b / max(tot, 1) * 100:5.1f}%)  {kind} "
                   f"x {calls[kind]}")
    return "\n".join(out)


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


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    from .. import configs
    from .dryrun import count_cell

    arch = configs.canonical(args.arch)
    by_bytes, by_flops, attribute = attribution()
    cost, _, _ = count_cell(configs.get(arch), args.shape, args.mesh,
                            attribute=attribute)
    text = report(by_bytes, by_flops, f"{arch} {args.shape} {args.mesh}",
                  args.top)
    if args.mesh != "host":
        text += "\n" + collectives(cost.coll_bytes, cost.coll_counts)
    print(text)
    return text


if __name__ == "__main__":
    main()
