"""Training driver: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch internlm2_1_8b --steps 6
    python -m repro_torch.launch.train --arch mamba2_780m --reduced \
        --device cpu --steps 4 --batch 4 --seq 64

Composes the full stack, as the reference does: the versioned corpus (a
CVD checked out through the ``gather_row_tiles`` kernel) -> deterministic
batches -> the train step (microbatched, AdamW; the model's forward runs
the flash-attention and SSD-scan kernels) -> checkpoint-CVD commits with
lineage.  ``--reduced`` shrinks any assigned arch to a host-sized geometry
of the same family.  It trains on the card unless ``--device cpu`` is
given (the kernels' plain versions).

Fault tolerance exercised here:
  * restart:    rerun with the same --ckpt-dir; resumes from the latest
                checkpoint version (exact step, exact data cursor; the
                optimizer state starts fresh, as in the reference).
                ``--preempt-after N`` stops a run after N steps, as a
                preempted job would.
  * straggler:  --straggler-p simulates slow hosts; StragglerPolicy drops
                and re-enqueues their shards deterministically.
The mesh (``--mesh host``) is the data axis of the ranks the environment
starts, as ``torchrun`` sets ``RANK``/``WORLD_SIZE``; one rank is the
default and trains with no process group.  Several ranks each check out
the same deterministic global batch and train on their own rows of it
(``train.train_step``), the parameters, AdamW moments and checkpoints
sharded over the ranks by ``param_specs``; only rank 0 prints and writes
checkpoints.  On the CPU:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch internlm2_1_8b --reduced --device cpu --steps 4 --batch 4

(gloo); on the card each rank takes the device of its ``LOCAL_RANK``
(NCCL, one card a rank).  ``--mesh single|multi`` trains on the
reference's production meshes (``launch.mesh.PRODUCTION``: (data 16,
model 16) and (pod 2, data 16, model 16)), every family tensor-, expert-
and sequence-parallel over "model", and needs exactly 256 or 512 ranks
(``torchrun --nnodes 32 --nproc-per-node 8 ...``); with fewer it raises
``PlanError``, and it never falls back to fewer ranks.  ``--grad-compress``
takes effect only on a mesh with a "pod" axis (``multi``), as the
reference's does: the int8 error-feedback step (``ef_init``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import configs
from ..core import generate, lyresplit_for_budget, to_tree
from ..data import VersionedDataset
from ..kernels import checkout_gather as _cg
from ..kernels import flash_attention as _fa
from ..kernels import ssd_scan as _ss
from ..kernels.ops import resolve_device
from ..models import init_params, load_reference, reference_like, to_reference
from ..models.transformer import ArchConfig, check_supported, param_specs
from ..train import (AdamW, CheckpointStore, HeartbeatMonitor,
                     StragglerPolicy, cosine_schedule, ef_init,
                     make_train_step, resume_latest)
from ..sharding import distribute, make_ctx, whole
from .mesh import (env_world_size, host_mesh_shape, make_host_mesh,
                   make_production_mesh, mesh_shape, world_size)

# checkpoints go under the checkout's git-ignored build directory
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink an assigned arch to host scale, same family/topology."""
    kw = dict(n_layers=min(cfg.n_layers, 2), d_model=256, vocab=1024,
              remat=False)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=64)
    if cfg.d_ff:
        kw["d_ff"] = 512
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, d_model=256, n_experts=8, top_k=2, d_ff_expert=128,
            d_ff_shared=128 if cfg.moe.n_shared else 0)
        kw["first_dense"] = min(cfg.first_dense, 1)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, d_model=256, n_heads=4,
                                        kv_lora=64, qk_nope=32, qk_rope=16,
                                        v_head=32)
    if cfg.ssd is not None:
        kw["ssd"] = dataclasses.replace(cfg.ssd, d_model=256, d_state=16,
                                        headdim=64, chunk=64)
    if cfg.shared_every:
        kw["n_layers"] = 4
        kw["shared_every"] = 2
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
    if cfg.n_patches:
        kw["n_patches"] = 16
    return dataclasses.replace(cfg, **kw)


def launches() -> dict:
    """The training path's kernels' launch counts in this process."""
    return {"gather_row_tiles": _cg.LAUNCHES["gather_row_tiles"],
            "flash_attention": _fa.LAUNCHES, "ssd_scan": _ss.LAUNCHES}


def corpus(cfg: ArchConfig, *, seq: int, seed: int, device,
           data_version: int = -1, log=print):
    """The reference driver's versioned corpus: an SCI workload of 12
    versions whose records are ``seq + 1`` tokens (mod the vocab),
    partitioned by LyreSplit at 2|R|, as a ``VersionedDataset`` on
    ``device``.  Returns (dataset, the version to train on)."""
    w = generate("SCI", n_versions=12, inserts=2000, n_branches=2,
                 n_attrs=seq + 1, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    sr = lyresplit_for_budget(tree, gamma=2.0 * w.n_records)
    ds = VersionedDataset.from_graph(w.graph, w.data % cfg.vocab,
                                     sr.best.assignment, seq_len=seq,
                                     device=device)
    data_vid = data_version if data_version >= 0 else w.n_versions - 1
    log(f"corpus: {ds.provenance(data_vid)}  "
        f"(LYRESPLIT: {sr.best.n_partitions} partitions, "
        f"S={sr.best.est_storage})")
    return ds, data_vid


def restore_or_init(cfg: ArchConfig, store: CheckpointStore, *, seed: int,
                    device, ctx=None, log=print):
    """(model, start step, parent checkpoint vid): trainable parameters from
    a generator seeded with ``seed`` on the device, overwritten by the
    store's latest checkpoint when there is one; with a mesh context every
    rank reads the checkpoint and keeps its own shards
    (``param_specs``)."""
    dev = resolve_device(device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev, trainable=True)
    vid0, tree, meta = resume_latest(store, device=dev,
                                     treedef_like=reference_like(model))
    if tree is not None:
        load_reference(model, tree)
        del tree
    if ctx is not None:
        distribute(model, param_specs(cfg), ctx.mesh)
    if vid0 is None:
        n_params = sum(p.numel() for p in model.parameters())
        log(f"fresh run: {n_params / 1e6:.1f}M params")
        return model, 0, None
    log(f"resumed from checkpoint v{vid0} at step {meta['cursor']}")
    return model, int(meta["cursor"]), vid0


def train(cfg: ArchConfig, model, ds: VersionedDataset, data_vid: int, *,
          store: CheckpointStore | None, start: int, parent_vid, steps: int,
          batch: int, seed: int, lr: float = 3e-4, ckpt_every: int = 0,
          grad_compress: bool = False, straggler_p: float = 0.0,
          preempt_after: int = 0, ctx=None, log=print) -> dict:
    """Train ``model`` in place from step ``start`` to ``steps`` (or for
    ``preempt_after`` steps) on the corpus version ``data_vid``, committing
    a checkpoint every ``ckpt_every`` steps.  AdamW starts fresh, with the
    reference's cosine schedule (warmup 10, ``total`` = ``steps``).  With
    a mesh context every rank of it calls this, and rank 0 alone logs and
    writes the checkpoints (each of them the whole weights, gathered).
    Returns the per-step losses, grad norms, seconds and batch tokens, and
    each checkpoint's vid, seconds and bytes."""
    opt = AdamW(lr=cosine_schedule(lr, warmup=10, total=steps))
    state = opt.init(model)
    step_fn = make_train_step(cfg, opt, grad_compress=grad_compress, ctx=ctx)
    # the compressed step carries the pods' residuals (a "pod" axis only)
    ef = (ef_init(model, ctx.size("pod"), ctx) if grad_compress
          and ctx is not None and "pod" in ctx.mesh.mesh_dim_names else None)
    lead = ctx is None or torch.distributed.get_rank() == 0
    if not lead:
        log = _quiet
    straggle = StragglerPolicy(n_hosts=4)
    hb = HeartbeatMonitor(n_hosts=4)
    rng = np.random.default_rng(seed + 17)
    out = {"start": start, "losses": [], "grad_norms": [], "step_s": [],
           "tokens": [], "checkpoints": []}
    t0 = time.perf_counter()
    for b in ds.batches(vid=data_vid, global_batch=batch, seed=seed + 1,
                        start_step=start, n_steps=steps - start,
                        drop_hosts=np.setdiff1d(np.arange(4),
                                                straggle.active_hosts())
                        if straggler_p else None,
                        n_hosts=4 if straggler_p else 1):
        ts = time.perf_counter()
        if ef is None:
            model, state, m = step_fn(model, state, b)
        else:
            model, state, ef, m = step_fn(model, state, ef, b)
        loss = float(m["loss"])                    # waits for the step
        dt = time.perf_counter() - ts
        for h in range(4):
            slow = rng.random() < straggler_p
            straggle.observe(h, dt * (10 if slow else 1))
            hb.beat(h)
        step = b["step"] + 1
        out["losses"].append(loss)
        out["grad_norms"].append(float(m["grad_norm"]))
        out["step_s"].append(dt)
        out["tokens"].append(np.asarray(b["tokens"]))
        if step % 10 == 0 or step == steps:
            log(f"step {step:4d}  loss {loss:.4f}  "
                f"gnorm {out['grad_norms'][-1]:.3f}  "
                f"hosts {len(straggle.active_hosts())}/4  "
                f"{(time.perf_counter() - t0) / max(step - start, 1):.2f}"
                f"s/step")
        if store is not None and ckpt_every and step % ckpt_every == 0:
            tc = time.perf_counter()
            tree = to_reference(model, {n: whole(p).detach() for n, p
                                        in model.named_parameters()},
                                host=False)
            if lead:
                parent_vid = store.save(step=step, tree=tree,
                                        parent_vid=parent_vid,
                                        meta={"cursor": step,
                                              "data_vid": int(data_vid),
                                              "arch": cfg.name})
            del tree
            if ctx is not None:
                # no rank goes on (or resumes) before the checkpoint is
                # on disk
                torch.distributed.barrier()
            out["checkpoints"].append({
                "vid": parent_vid, "step": step,
                "save_s": time.perf_counter() - tc,
                "bytes": 4 * sum(p.numel() for p in model.parameters())})
            log(f"  checkpoint v{parent_vid} "
                f"(dedup {store.dedup_ratio():.2f})")
        if preempt_after and step - start >= preempt_after:
            break
    out["wall_s"] = time.perf_counter() - t0
    return out


def _quiet(*args, **kw) -> None:
    """The log of a rank other than 0."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--reduced", action="store_true",
                    help="host-scale geometry of the same family")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--data-version", type=int, default=-1,
                    help="-1 = latest version of the corpus CVD")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--straggler-p", type=float, default=0.0)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="stop after this many steps of this run, as a "
                         "preempted job would (0 = run to --steps)")
    args = ap.parse_args(argv)

    cfg = configs.get(configs.canonical(args.arch))
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.microbatches:
        cfg = dataclasses.replace(cfg, microbatches=args.microbatches)
    check_supported(cfg)
    dev = resolve_device(args.device)

    # several ranks (torchrun's environment): their data mesh, or the
    # production mesh asked for; one rank on the host mesh needs no group
    started = not torch.distributed.is_initialized()
    if args.mesh != "host":
        ctx = make_ctx(make_production_mesh(multi_pod=args.mesh == "multi",
                                            device=dev))
    else:
        ctx = make_ctx(make_host_mesh(dev)) if env_world_size() > 1 else None
    lead = ctx is None or torch.distributed.get_rank() == 0
    log = print if lead else _quiet
    ds, data_vid = corpus(cfg, seq=args.seq, seed=args.seed, device=dev,
                          data_version=args.data_version, log=log)
    log(f"mesh={mesh_shape(ctx.mesh) if ctx else host_mesh_shape()} "
        f"arch={cfg.name}{' (reduced)' if args.reduced else ''}")
    store = CheckpointStore(args.ckpt_dir, shard_rows=1 << 12)
    model, start, parent_vid = restore_or_init(cfg, store, seed=args.seed,
                                               device=dev, ctx=ctx, log=log)
    before = launches()
    run = train(cfg, model, ds, data_vid, store=store, start=start,
                parent_vid=parent_vid, steps=args.steps, batch=args.batch,
                seed=args.seed, lr=args.lr, ckpt_every=args.ckpt_every,
                grad_compress=args.grad_compress,
                straggler_p=args.straggler_p,
                preempt_after=args.preempt_after, ctx=ctx, log=log)
    losses = run["losses"]
    out = {"arch": cfg.name, "steps": args.steps,
           "first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None,
           "wall_s": round(run["wall_s"], 1),
           "start": start, "losses": losses,
           "grad_norms": run["grad_norms"],
           "ms_per_step": 1e3 * float(np.mean(run["step_s"]))
           if losses else None,
           "checkpoints": [c["vid"] for c in run["checkpoints"]],
           "device": str(dev), "ranks": world_size(),
           "launches": {k: v - before[k] for k, v in launches().items()}}
    log(json.dumps(out))
    if ctx is not None and started:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
