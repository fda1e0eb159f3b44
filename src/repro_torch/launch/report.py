"""The dry run's roofline and detail tables from its per-cell JSON records:
the port of ``src/repro/launch/report.py``.  One roofline table for each
mesh the records hold (``host``: one card; ``single``: 256 ranks;
``multi``: 512), as the reference's ``main`` prints one a mesh, each rank's
terms against one card's data-sheet peaks and its collectives over one
link (``launch.roofline``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report build/dryrun
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .roofline import CARD, LINK_BW, PEAK_FLOPS

# the tables' titles, in the order they are printed
MESH_TITLES = {
    "host": f"one card: {CARD}",
    "single": "single pod, (data 16, model 16) = 256 ranks, each one card",
    "multi": "two pods, (pod 2, data 16, model 16) = 512 ranks, each one "
             "card"}


def load(dirname: str) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def fmt_s(x: float) -> str:
    return f"{x:.3e}"


def cell_fraction(r: dict) -> float:
    """Roofline fraction: ideal model-FLOPs time (bf16 peak) / binding
    term."""
    rf = r["roofline"]
    bound = max(rf["compute_s"], rf.get("memory_s_flash", rf["memory_s"]),
                rf["collective_s"])
    ideal = r["model_flops"] / (r["chips"] * PEAK_FLOPS)
    return ideal / max(bound, 1e-12)


def bottleneck_note(r: dict) -> str:
    """The lever that would move the binding term, in this port's terms."""
    rf = r["roofline"]
    dom = rf["dominant"]
    kind = r.get("kind", "")
    if dom == "memory":
        if kind == "decode":
            return ("param+KV/state stream and the per-step weight casts "
                    "— a bf16 weight copy or larger batch to move it")
        if r["arch"].startswith(("mamba2", "zamba2")):
            return ("unfused elementwise work around the SSD scan "
                    "(and its plain backward) — fused kernels to move it")
        return ("unfused elementwise work and weight casts — fused "
                "norm/residual kernels to move it")
    if dom == "collective":
        bd = rf["collective_breakdown"]
        top = max(bd, key=bd.get)
        lever = {
            "all-gather": ("the weights gathered over the batch axes each "
                           "step; prefetch and overlap to move it"
                           if kind == "train" else
                           "the working copy gathered on every call; keep "
                           "it across calls to move it"),
            "all-reduce": ("the whole gradient all-reduced over the batch "
                           "axes and the model group's partial sums; "
                           "reduce-scatter into the shards to move it"
                           if kind == "train" else
                           "the model group's partial sums; a "
                           "sequence-parallel reduce-scatter to move it"),
        }.get(top, "the MoE exchange; overlap it with the experts")
        return f"{top} dominates — {lever}"
    if kind == "train":
        return ("float32 products of the flash backward — a backward "
                "kernel on the tensor cores to move it")
    return ("tensor-core bound — the remaining lever is the MODEL/count "
            "gap (attention's products)")


def roofline_table(rows: list[dict], mesh: str = "host") -> str:
    """One line per (arch × shape): the three terms (memory on the
    materialised and the kernel path), dominant, MODEL/count FLOPs, the
    roofline fraction, peak GB and the note."""
    out = ["| arch | shape | compute_s | memory_s | memory_s (kernels) | "
           "collective_s | dominant | MODEL/count | RF | peak GB | "
           "bottleneck note |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"skipped | — | — | — | {r['reason'][:58]} |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"ERROR | — | — | — | {r.get('error', '')[:58]} |")
            continue
        rf = r["roofline"]
        peak = r["memory"]["peak_estimate_bytes"] / 1e9
        ratio = min(r["useful_flops_ratio"], 9.999)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | "
            f"{fmt_s(rf.get('memory_s_flash', rf['memory_s']))} | "
            f"{fmt_s(rf['collective_s'])} | {rf['dominant']} | "
            f"{ratio:.3f} | {cell_fraction(r):.3f} | {peak:.1f} | "
            f"{bottleneck_note(r)} |")
    return "\n".join(out)


def dryrun_table(rows: list[dict]) -> str:
    """One line a record: status, trace s, a rank's argument, temp and
    cast GB, whether it fits one card, and its collectives' calls."""
    out = ["| arch | shape | mesh | status | trace_s | args GB | temp GB | "
           "casts GB | fits 80 GB | collectives (counts) |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']} | — | — | — | — | — | — |")
            continue
        m = r["memory"]
        cc = {k: int(v) for k, v in r["roofline"]["collective_counts"].items()
              if v}
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['trace_s']} | {m['argument_bytes'] / 1e9:.2f} | "
            f"{m['temp_bytes'] / 1e9:.2f} | {r['cast_bytes'] / 1e9:.2f} | "
            f"{m['fits_card']} | {cc} |")
    return "\n".join(out)


def meshes_of(rows: list[dict]) -> list[str]:
    """The meshes the records hold, in ``MESH_TITLES``' order."""
    have = {r.get("mesh") for r in rows}
    return [m for m in MESH_TITLES if m in have]


def summary_stats(rows: list[dict]) -> str:
    """The mean roofline fraction over the train and prefill cells and the
    cells whose rank fits one 80 GB card, a mesh at a time."""
    parts = []
    for mesh in meshes_of(rows) or ["host"]:
        cells = [r for r in rows if r["status"] == "ok"
                 and r.get("mesh") == mesh]
        fr = [cell_fraction(r) for r in cells
              if r["kind"] in ("train", "prefill")]
        fits = sum(1 for r in cells if r["memory"]["fits_card"])
        parts.append(f"{mesh} {sum(fr) / max(len(fr), 1):.3f} ({fits} "
                     "cells fit one 80 GB card)")
    return ("Mean roofline fraction over train/prefill cells: "
            + "; ".join(parts) + ".")


def main(argv=None) -> str:
    args = sys.argv[1:] if argv is None else argv
    d = args[0] if args else "build/dryrun"
    rows = load(d)
    ok = sum(1 for r in rows if r["status"] == "ok")
    sk = sum(1 for r in rows if r["status"] == "skipped")
    er = len(rows) - ok - sk
    parts = [f"## Dry-run summary: {ok} ok / {sk} skipped / {er} errors "
             f"({len(rows)} cell records)\n",
             summary_stats(rows) + "\n"]
    for mesh in meshes_of(rows):
        link = (f"; collectives over one {LINK_BW / 1e9:.0f} GB/s link a "
                "rank" if mesh != "host" else "")
        parts += [f"### Roofline ({MESH_TITLES[mesh]}; counts against "
                  f"data-sheet peaks{link}, not measurements)\n",
                  roofline_table(rows, mesh), ""]
    parts += ["### Dry-run detail\n", dryrun_table(rows)]
    text = "\n".join(parts)
    print(text)
    return text


if __name__ == "__main__":
    main()
