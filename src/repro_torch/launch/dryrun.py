"""Dry run of every (architecture × input shape × mesh) cell: the port of
``src/repro/launch/dryrun.py``.

The reference fakes 512 host devices and compiles each cell's step from
``ShapeDtypeStruct``s.  The port runs its own step on ``meta`` tensors
(``models.transformer.abstract_params``, ``configs.input_specs``: shape and
dtype, no storage, nothing computed) under ``launch.op_count.analyze``,
which counts every aten op's FLOPs and bytes, the live memory and the
collectives, and derives the H100 roofline (``launch.roofline``).  No card
is needed, and nothing falls back to the CPU: ``meta`` holds no data.

Meshes (``--mesh``): ``host`` is one card (``chips`` 1, no collectives);
``single`` and ``multi`` are the reference's production meshes
(``launch.mesh.PRODUCTION``: 256 ranks over (data 16, model 16), 512 over
(pod 2, data 16, model 16)), ``both`` the two.  On a production mesh the
cell runs rank 0's program on ``launch.mesh.counting_group``'s fake ranks:
each parameter a DTensor laid out by ``param_specs`` whose local tensor is
rank 0's shard, made on ``meta`` (``rank_model``; no whole model is made),
the AdamW moments laid out as the parameters, the plain train step (as the
reference's dry run takes it: no ``grad_compress``), the batch the step
takes, and a decode cell's cache as ``cache_specs`` lays out rank 0's
part.  Every count is then rank 0's: ``memory`` is one rank's and
``fits_card`` holds it against one 80 GB card, ``useful_flops_ratio`` and
the kernels' I/O divide by ``chips``, and ``roofline`` gains the
collectives' result bytes by kind (``collective_bytes``,
``collective_breakdown``, ``collective_counts``); ``collectives_by_axis``
splits them by the mesh axis whose group ran them.  A ``PlanError`` the
port raises on a cell is the record's ``error``, in its own words.

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
int ``seq - 1`` (a live cache's length is a Python int).

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2_1_8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Callable, Optional

import torch

from .. import configs
from ..models.transformer import (abstract_params, count_params, init_cache,
                                  param_specs)
from ..serve.serve_step import make_prefill_step, make_serve_step
from ..sharding import make_ctx, sharding
from ..train.optimizer import AdamW
from ..train.train_step import make_train_step, working_specs
from . import op_count
from .mesh import PRODUCTION, counting_group
from .roofline import (HBM_BYTES, flash_attention_io_bytes, model_flops,
                       roofline_from_cost)

MESHES = ("host", *PRODUCTION)


def rank_model(cfg, mesh, make: Optional[Callable] = None):
    """``cfg``'s model laid out by ``param_specs`` on ``mesh`` as this rank
    holds it: each parameter a DTensor of the leaf's global shape whose
    local tensor is this rank's shard, made by ``make(name, shape, dtype)``
    (default: empty on ``meta``).  No whole leaf is made."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    make = make or (lambda name, shape, dtype: torch.empty(
        shape, dtype=dtype, device="meta"))
    model = abstract_params(cfg)
    specs = param_specs(cfg)
    for name, p in list(model.named_parameters()):
        placements = sharding(specs[name], mesh).placements
        shape, _ = compute_local_shape_and_global_offset(p.shape, mesh,
                                                         placements)
        d = DTensor.from_local(make(name, tuple(shape), p.dtype), mesh,
                               placements, run_check=False, shape=p.shape,
                               stride=p.stride())
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
            d, requires_grad=False)
    return model


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


def cell_step(cfg, shape: str, abstract, ctx=None, *, device="meta",
              batch: Optional[dict] = None):
    """(kind, step, args): the cell's step and its arguments, as a user
    would call them (``make_train_step`` on an AdamW state,
    ``make_prefill_step``, ``make_serve_step``), on ``meta``: the
    ``configs.input_specs`` batch.  With a mesh context ``ctx``,
    ``abstract`` is ``rank_model``'s and the decode's cache this rank's
    part (``init_cache(..., ctx=)``).  On another ``device`` (the card's
    rank step in ``chip_smoke.py``) ``abstract`` and ``batch`` are there
    and the decode's cache is made there, zeroed."""
    specs, kind = configs.input_specs(cfg, shape)
    batch = specs if batch is None else batch
    seq = configs.SHAPES[shape]["seq"]
    if ctx is not None:
        # the working copy's layout is cached on first use, built from a
        # whole ``meta`` model: bookkeeping the count would charge as the
        # step's live memory, so it is made before the count
        working_specs(cfg, ctx.tp_size)
    if kind == "train":
        abstract.requires_grad_(True)
        opt = AdamW()
        return kind, make_train_step(cfg, opt, ctx=ctx), (
            abstract, opt.init(abstract), batch)
    if kind == "prefill":
        return kind, make_prefill_step(cfg, ctx, device=device), (abstract,
                                                                  batch)
    if ctx is not None or device != "meta":
        batch["cache"] = init_cache(cfg, batch["tokens"].shape[0], seq,
                                    device=device, ctx=ctx)
    batch["cache"]["len"] = seq - 1
    return kind, make_serve_step(cfg, ctx, device=device), (abstract, batch)


def count_cell(cfg, shape: str, mesh_kind: str = "host", **kw) -> tuple:
    """(the cell's ``OpCost``, chips, ``{axis: group name}``): its step
    counted on one card, or rank 0's on a production mesh under the
    counting group (``kw`` goes to ``op_count.analyze``)."""
    if mesh_kind == "host":
        _, step, args = cell_step(cfg, shape, abstract_params(cfg))
        return op_count.analyze(step, *args, **kw), 1, {}
    with counting_group(mesh_kind) as mesh:
        ctx = make_ctx(mesh)
        _, step, args = cell_step(cfg, shape, rank_model(cfg, mesh), ctx)
        cost = op_count.analyze(step, *args, **kw)
        axes = {a: mesh.get_group(a).group_name for a in mesh.mesh_dim_names}
        return cost, mesh.size(), axes


def by_axis(cost, axes: dict) -> dict:
    """The count's collectives by the mesh axis whose group ran them:
    ``{axis: {kind: [calls, result bytes]}}``."""
    names = {g: a for a, g in axes.items()}
    return {names.get(g, g): dict(kinds)
            for g, kinds in sorted(cost.coll_groups.items())}


def run_cell(arch: str, shape: str, mesh_kind: str = "host", *,
             cfg=None) -> dict:
    """The cell's record; ``cfg`` defaults to ``configs.get(arch)``."""
    if mesh_kind not in MESHES:
        raise ValueError(f"--mesh {mesh_kind}: one of {MESHES}")
    arch = configs.canonical(arch)
    ok, why = configs.cell_supported(arch, shape)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec

    cfg = cfg or configs.get(arch)
    info = configs.SHAPES[shape]
    kind = info["kind"]
    tokens_per_step = info["seq"] * info["batch"] \
        if kind in ("train", "prefill") else info["batch"]

    t0 = time.time()
    cost, chips, axes = count_cell(cfg, shape, mesh_kind)
    trace_s = time.time() - t0
    abstract = abstract_params(cfg)

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
        "collectives_by_axis": by_axis(cost, axes),
        "cast_bytes": cost.cast_bytes,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(roof.flops * chips, 1.0),
    })
    return rec


def status_line(rec: dict) -> str:
    """One line a cell: status, dominant term, compute_s, memory_s on both
    paths, collective_s, peak GB and whether it fits the card."""
    extra = ""
    if rec["status"] == "ok":
        r, m = rec["roofline"], rec["memory"]
        extra = (f" dom={r['dominant']} comp={r['compute_s']:.3e}s "
                 f"mem={r['memory_s']:.3e}s "
                 f"memF={r['memory_s_flash']:.3e}s "
                 f"coll={r['collective_s']:.3e}s "
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
    meshes = list(PRODUCTION) if args.mesh == "both" else [args.mesh]

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
    for arch, shape in cells:
        for mk in meshes:
            fn = None
            if args.out:
                fn = os.path.join(
                    args.out, f"{configs.canonical(arch)}__{shape}__{mk}.json")
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
