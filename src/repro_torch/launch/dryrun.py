"""Dry run of every (architecture × input shape) cell on one card: the port
of ``src/repro/launch/dryrun.py``.

The reference fakes 512 host devices and compiles each cell's step from
``ShapeDtypeStruct``s.  The port runs its own step on ``meta`` tensors
(``models.transformer.abstract_params``, ``configs.input_specs``: shape and
dtype, no storage, nothing computed) under ``launch.op_count.analyze``,
which counts every aten op's FLOPs and bytes and the live memory, and
derives the H100 roofline (``launch.roofline``).  No card is needed, and
nothing falls back to the CPU: ``meta`` holds no data.

The record keeps the reference's keys where they mean the same.  Its
``lower_s`` and ``compile_s`` are one ``trace_s`` here (the counted run);
``xla_cost_flops`` and ``xla_cost_bytes`` (XLA's own loop-body-once
counts) have no counterpart and are left out.  ``memory`` holds
``argument_bytes`` (parameters, optimizer state and inputs),
``output_bytes`` (the result's storages that are not the arguments'),
``alias_bytes`` (the arguments the result hands back, updated in place),
``temp_bytes`` (the peak of every storage made during the step, the
outputs included) and ``peak_estimate_bytes`` = arguments + temp.  The
decode cell runs one new token against a full cache: ``len`` is the Python
int ``seq - 1`` (a live cache's length is a Python int).  ``--mesh`` takes
``host`` only (one card, ``chips`` 1).

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2_1_8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from .. import configs
from ..models.transformer import abstract_params, count_params
from ..serve.serve_step import make_prefill_step, make_serve_step
from ..train.optimizer import AdamW
from ..train.train_step import make_train_step
from . import op_count
from .roofline import (HBM_BYTES, flash_attention_io_bytes, model_flops,
                       roofline_from_cost)

MESHES = ("host",)


def check_mesh(mesh_kind: str) -> None:
    if mesh_kind not in MESHES:
        raise ValueError(f"--mesh {mesh_kind}: the port runs on one card "
                         "(--mesh host); the 256- and 512-chip meshes wait "
                         "for ROADMAP A.11f")


def active_params(cfg, abstract) -> float:
    """N_active for MODEL_FLOPS: full N for dense; for MoE subtract the
    non-routed fraction of expert params."""
    total = count_params(abstract)
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    expert_params = (cfg.n_layers - cfg.first_dense) * m.n_experts * \
        (3 * m.d_model * m.d_ff_expert)
    active_expert = expert_params * (m.top_k / m.n_experts)
    return float(total - expert_params + active_expert)


def cell_step(cfg, shape: str, abstract):
    """(kind, step, args): the cell's step and its ``meta`` arguments, as a
    user would call them (``make_train_step`` on an AdamW state,
    ``make_prefill_step``, ``make_serve_step``)."""
    batch, kind = configs.input_specs(cfg, shape)
    if kind == "train":
        abstract.requires_grad_(True)
        opt = AdamW()
        return kind, make_train_step(cfg, opt), (abstract, opt.init(abstract),
                                                 batch)
    if kind == "prefill":
        return kind, make_prefill_step(cfg, device="meta"), (abstract, batch)
    batch["cache"]["len"] = configs.SHAPES[shape]["seq"] - 1
    return kind, make_serve_step(cfg, device="meta"), (abstract, batch)


def run_cell(arch: str, shape: str, mesh_kind: str = "host", *,
             cfg=None) -> dict:
    """The cell's record; ``cfg`` defaults to ``configs.get(arch)``."""
    check_mesh(mesh_kind)
    arch = configs.canonical(arch)
    ok, why = configs.cell_supported(arch, shape)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec

    cfg = cfg or configs.get(arch)
    chips = 1
    info = configs.SHAPES[shape]
    tokens_per_step = info["seq"] * info["batch"] \
        if info["kind"] in ("train", "prefill") else info["batch"]

    t0 = time.time()
    abstract = abstract_params(cfg)
    kind, step, args = cell_step(cfg, shape, abstract)
    cost = op_count.analyze(step, *args)
    trace_s = time.time() - t0

    flash_io = flash_attention_io_bytes(cfg, info["seq"], info["batch"],
                                        kind, chips)
    roof = roofline_from_cost(cost, chips, flash_io_bytes=flash_io)
    n_active = active_params(cfg, abstract)
    n_total = count_params(abstract)
    if kind == "train":
        mf = model_flops(n_active, tokens_per_step)    # 6·N·D: fwd + bwd
    else:
        mf = 2.0 * n_active * tokens_per_step          # fwd only
    rec.update({
        "status": "ok",
        "kind": kind,
        "chips": chips,
        "seq": info["seq"], "batch": info["batch"],
        "n_params": n_total,
        "n_params_active": n_active,
        "trace_s": round(trace_s, 1),
        "n_ops": cost.n_ops,
        "memory": {
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": cost.temp_bytes,
            "alias_bytes": cost.alias_bytes,
            "peak_estimate_bytes": cost.peak_estimate_bytes,
            "fits_card": cost.peak_estimate_bytes <= HBM_BYTES,
        },
        "roofline": roof.as_dict(),
        "cast_bytes": cost.cast_bytes,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(roof.flops * chips, 1.0),
    })
    return rec


def status_line(rec: dict) -> str:
    """One line a cell: status, dominant term, compute_s, memory_s on both
    paths, peak GB and whether it fits the card."""
    extra = ""
    if rec["status"] == "ok":
        r, m = rec["roofline"], rec["memory"]
        extra = (f" dom={r['dominant']} comp={r['compute_s']:.3e}s "
                 f"mem={r['memory_s']:.3e}s "
                 f"memF={r['memory_s_flash']:.3e}s "
                 f"peak={m['peak_estimate_bytes'] / 1e9:.1f}GB "
                 f"fits={m['fits_card']} trace={rec['trace_s']}s")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:200]
    return (f"[{rec.get('wall_s', 0.0):7.1f}s] {rec['arch']:24s} "
            f"{rec['shape']:12s} {rec['mesh']:6s} {rec['status']}{extra}")


def main(argv=None) -> list:
    """Runs the cells asked for and returns their records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume: skip cells whose JSON already exists")
    args = ap.parse_args(argv)
    check_mesh(args.mesh)

    cells = []
    if args.all:
        for a in configs.ARCH_IDS:
            for s in configs.SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    records = []
    mk = args.mesh
    for arch, shape in cells:
        fn = None
        if args.out:
            fn = os.path.join(args.out,
                              f"{configs.canonical(arch)}__{shape}__{mk}.json")
            if args.skip_existing and os.path.exists(fn):
                continue
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, mk)
        except Exception as e:
            rec = {"arch": configs.canonical(arch), "shape": shape,
                   "mesh": mk, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        rec["wall_s"] = round(time.time() - t0, 1)
        if fn:
            os.makedirs(args.out, exist_ok=True)
            with open(fn, "w") as f:
                f.write(json.dumps(rec))
        records.append(rec)
        print(status_line(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
