"""Batched serving driver: the port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch zamba2_2_7b \
        --requests 4 --prompt-len 512 --decode-steps 32
    python -m repro_torch.launch.serve --arch internlm2_1_8b --reduced \
        --device cpu --requests 4 --prompt-len 64 --decode-steps 4

Serves a model against a VERSIONED prompt store, as the reference does: the
requested prompt versions of a CVD are checked out in one fused wave through
the port's ``BatchedCheckoutServer``, and requests round-robin across them.
The cache is filled token by token through ``make_serve_step`` and the model
then decodes greedily; the JSON line the reference prints comes last.  Its
``prefill_s`` is that token-by-token fill, kept under the reference's
field name; the serving prefill's own time is ``prefill_step_s``.
``--trace PATH`` records the run's spans and counters (``trace``; the fill
and the decode loops are ``serve.fill`` and ``serve.decode``) and writes
them to PATH as a Chrome trace at its end (rank 0's, on a mesh).

The driver also runs the reference's serving prefill, ``make_prefill_step``,
once on the same prompts: that is the path through the flash-attention and
SSD-scan kernels (the token-by-token path reaches neither).  It reports the
prefill's time, the kernels' launches in each phase, and how far its
next-token logits lie from the token-by-token path's at the last prompt
position: the relative L2 error per request against a bound derived from
bf16 (``prefill_bound``), and whether the argmax agrees wherever the top-2
gap is clear of that bound.

``--device`` defaults to the card; ``--device cpu`` runs the kernels' plain
versions (the CPU tests).  ``--mesh host`` (the default) is the one
device.  ``--mesh single|multi`` serves on the reference's production
meshes (``launch.mesh.PRODUCTION``, 256 or 512 ranks started by
``torchrun``; with fewer it raises ``PlanError``): every rank checks out
the same prompts, lays the seeded weights out by ``param_specs``, fills
its part of a cache laid out by ``cache_specs`` through
``make_serve_step`` on the mesh (each step's greedy tokens gathered over
the batch axes into the next step's global batch) and runs
``make_prefill_step`` once; each rank holds its rows' prefill against its
token path, the ranks' verdicts and errors are reduced over the group, and
rank 0 prints the JSON line, its throughput the whole batch's.

An encoder-decoder is refused, as the reference's driver refuses it (its
serving needs frame embeddings no prompt store holds).  A vision-language
model is filled and decoded from its tokens alone, as the reference's
driver does (its ``decode_step`` takes no patch embeddings); its prefill
passes as ``patch_embeds`` the prompts' own first ``n_patches`` token
embeddings, so the stub frontend gives the token path's function and the
prefill check keeps its meaning.  A prompt shorter than ``n_patches`` is
refused with ``PlanError`` (the reference's concatenation would lengthen
the sequence).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import configs, trace
from ..core import generate, lyresplit_for_budget, to_tree
from ..data import VersionedDataset
from ..kernels import flash_attention as _fa
from ..kernels import ssd_scan as _ss
from ..kernels.build import PlanError
from ..kernels.ops import resolve_device
from ..models import layers as L
from ..models import moe as MOE
from ..models.transformer import (ArchConfig, _embed, check_supported,
                                  init_cache, init_params, param_specs)
from ..serve.checkout import BatchedCheckoutServer
from ..serve.serve_step import make_prefill_step, make_serve_step
from ..sharding import distribute, make_ctx, whole
from .mesh import host_mesh_shape, make_production_mesh, mesh_shape
from .train import _quiet, reduced_config

ROUNDINGS_PER_BLOCK = 6   # norm, projections, conv or probabilities, gate, out
# an MoE block rounds where a dense one does outside its MLP (the dense
# MLP's gate and out, 2 of the 6), and then in its routed experts: the
# three expert products and the weighted combine (the dispatch buffer is
# a copy of bf16 rows, exact), and the shared expert where there is one
ROUNDINGS_PER_MOE_BLOCK = ROUNDINGS_PER_BLOCK - 2 + 4
ROUNDINGS_SHARED_EXPERT = 1
# an encoder-decoder's decoder block adds a cross-attention sub-layer that
# rounds where a self-attention does: its norm, its query projection, the
# probabilities and its output (its keys and values are the encoder's)
ROUNDINGS_CROSS_ATTENTION = 4
# a sub-layer multiplies two linear maps of its input (q·kᵀ, gate × in,
# C·B), and d(ab)/ab = da/a + db/b: it passes a relative error on doubled
SUBLAYER_GAIN = 2


def depth(cfg: ArchConfig) -> int:
    """Residual blocks on the path: the layers (an MoE stack's dense and
    MoE layers together), plus the hybrid's shared block applications."""
    shared = cfg.n_layers // cfg.shared_every if cfg.shared_every else 0
    return cfg.n_layers + shared


def roundings(cfg: ArchConfig) -> int:
    """Places on the path where a block rounds to bf16:
    ``ROUNDINGS_PER_BLOCK`` a dense, SSD or shared block,
    ``ROUNDINGS_PER_MOE_BLOCK`` (+ ``ROUNDINGS_SHARED_EXPERT`` with shared
    experts) an MoE block: 6 a block but 8 an OLMoE block and 9 a
    DeepSeek-V2 MoE block; an encoder-decoder's decoder block 6 +
    ``ROUNDINGS_CROSS_ATTENTION``, 10.  Its encoder blocks count nothing:
    the token path's encoder K/V come from the prefill's own encoder code
    (``models.transformer._encode`` and ``cross_kv_init``) on the same
    frames, so both paths start from the same encoder output."""
    if cfg.family == "encdec":
        return (ROUNDINGS_PER_BLOCK + ROUNDINGS_CROSS_ATTENTION) * cfg.n_layers
    if cfg.moe is None:
        return ROUNDINGS_PER_BLOCK * depth(cfg)
    per_moe = ROUNDINGS_PER_MOE_BLOCK + (ROUNDINGS_SHARED_EXPERT
                                         if cfg.moe.n_shared else 0)
    n_moe = cfg.n_layers - cfg.first_dense
    return ROUNDINGS_PER_BLOCK * cfg.first_dense + per_moe * n_moe


def prefill_bound(cfg: ArchConfig) -> float:
    """The relative L2 distance allowed between the prefill's and the
    token-by-token path's last-position logits in bf16: each block rounds
    to bf16 (u = 2^-8) at ``roundings`` places, the two paths round at
    different places, and independent errors add in quadrature over the
    blocks; a sub-layer downstream of a rounding passes its error on up to
    ``SUBLAYER_GAIN`` times larger.  So 2 · sqrt(2 · roundings) · 2^-8,
    2 · sqrt(2 · 6 · depth) · 2^-8 without MoE blocks (0.038 for a 2-layer
    dense model, 0.215 for Zamba2-2.7B's 54 + 9 blocks; 0.125 for
    OLMoE-1B-7B's 16 MoE blocks, 0.121 for Seamless-M4T-medium's 12
    decoder blocks)."""
    return SUBLAYER_GAIN * math.sqrt(2 * roundings(cfg)) * 2.0 ** -8


def prompt_store(vocab: int, *, requests: int, prompt_len: int,
                 prompt_version: str = "-1", wave_size=None, seed: int = 0,
                 device=None, mesh: dict | None = None,
                 log=print) -> np.ndarray:
    """The reference driver's prompts: a CUR workload of 8 versions whose
    records are ``prompt_len`` tokens (mod ``vocab``), partitioned by
    LyreSplit at 2|R|, checked out in ONE fused wave of the requested
    versions, cycled to ``requests`` rows (``mesh``, the shape logged,
    defaults to the host mesh's).  (requests, prompt_len) int32."""
    w = generate("CUR", n_versions=8, inserts=400, n_branches=2,
                 n_attrs=prompt_len, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    sr = lyresplit_for_budget(tree, gamma=2.0 * w.n_records)
    ds = VersionedDataset.from_graph(w.graph, w.data % vocab,
                                     sr.best.assignment, seq_len=prompt_len,
                                     device=device)
    vids = [v if v >= 0 else w.n_versions - 1
            for v in (int(s) for s in prompt_version.split(","))]
    server = BatchedCheckoutServer(ds.store, use_kernel=True,
                                   max_wave=wave_size)
    server.warmup()                     # superblock built+pinned pre-traffic
    waves = server.serve(vids)          # ONE fused cross-partition wave
    server.close()
    per_v = max(requests // len(vids), 1)
    pool = np.concatenate([m[:per_v] for m in waves])
    if len(pool) == 0:
        raise SystemExit(f"prompt versions {vids} contain no rows")
    reps = -(-requests // len(pool))               # cycle to fill the batch
    rows = np.tile(pool, (reps, 1))[:requests]
    rows = rows[:, :prompt_len] % vocab
    log(f"mesh={mesh or host_mesh_shape()} serving {len(rows)} "
        f"requests from prompt CVD versions {vids} "
        f"({server.stats.waves} checkout wave)")
    return rows.astype(np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _all_rows(t: torch.Tensor, ctx) -> torch.Tensor:
    """The global batch from every (pod, data) line's rows of ``t``
    (all-gathered over the batch axes, the first axis major); ``t`` itself
    without a context."""
    if ctx is None:
        return t
    for a in reversed(ctx.dp):
        if ctx.size(a) > 1:
            parts = [torch.empty_like(t) for _ in range(ctx.size(a))]
            dist.all_gather(parts, t.contiguous(), group=ctx.group(a))
            t = torch.cat(parts)
    return t


def _launches() -> dict:
    return {"flash_attention": _fa.LAUNCHES, "ssd_scan": _ss.LAUNCHES}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def prefill_check(prefill_logits: torch.Tensor, fill_logits: torch.Tensor,
                  bound: float) -> dict:
    """Per request: relative L2 distance of the prefill's next-token logits
    (B, vocab) from the token-by-token path's, and argmax agreement; the
    argmax must agree wherever the token-by-token top-2 gap exceeds
    ``bound · max|logit|`` (a gap no error within the bound can close)."""
    a, b = prefill_logits.float(), fill_logits.float()
    rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()
    top2 = b.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    clear = [g > bound * m for g, m in zip(gap, b.abs().amax(-1).tolist())]
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    ok = all(r <= bound for r in rel) and all(
        s for s, c in zip(agree, clear) if c)
    return {"rel_l2": rel, "bound": bound, "top2_gap": gap,
            "gap_clear": clear, "argmax_agree": agree, "ok": ok}


ENCDEC_REFUSED = "encdec serving needs enc_embeds"


def refuse(cfg: ArchConfig, prompt_len: int) -> None:
    """What the serve driver cannot serve: an encoder-decoder (the
    reference's refusal), and a vision-language prompt shorter than its
    patches."""
    if cfg.family == "encdec":
        raise ValueError(ENCDEC_REFUSED)
    if cfg.family == "vlm" and prompt_len < cfg.n_patches:
        raise PlanError(f"{cfg.name}: a prompt of {prompt_len} tokens is "
                        f"shorter than its {cfg.n_patches} patch positions")


def serve(cfg: ArchConfig, *, requests: int = 16, prompt_len: int = 64,
          decode_steps: int = 32, prompt_version: str = "-1",
          wave_size=None, seed: int = 0, device=None, params=None,
          ctx=None, log=print) -> dict:
    """Serve ``requests`` prompts from the versioned prompt store: fill the
    cache token by token, decode ``decode_steps`` tokens greedily, then run
    the serving prefill once on the same prompts and hold its next-token
    logits against the token-by-token path's.  ``params`` defaults to
    ``init_params`` from a generator seeded with ``seed`` on the device.
    With a mesh context ``ctx`` every rank of the mesh calls this: the
    parameters are laid out by ``param_specs``, the cache is the rank's
    part (its length rounded up to a multiple of the model axis, over
    which its sequence splits; the slots past the last token are never
    read), the logits, the tokens and the check are its rows', and the
    check's verdict and worst error are the group's.

    Returns {"result": the reference's JSON fields and the prefill's,
    "prompts", "tokens" (numpy), "fill_logits", "prefill_logits",
    "cache", "launches" per phase, "dropped", "check"}: "dropped" holds
    the routed slots the MoE dispatch dropped, summed over the fill and
    decode (none at B <= 8: a step routes B tokens, and a capacity is at
    least 8) and, for the prefill, a list with one count per MoE layer
    (empty without MoE layers)."""
    check_supported(cfg)
    refuse(cfg, prompt_len)
    dev = resolve_device(device)
    rows = prompt_store(cfg.vocab, requests=requests, prompt_len=prompt_len,
                        prompt_version=prompt_version, wave_size=wave_size,
                        seed=seed, device=dev,
                        mesh=mesh_shape(ctx.mesh) if ctx else None, log=log)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    if ctx is not None:
        distribute(params, param_specs(cfg), ctx.mesh)
    prompts = torch.from_numpy(rows).to(dev)
    b = prompts.shape[0]
    max_len = prompt_len + decode_steps
    if ctx is not None:     # the cache's sequence splits over "model"
        max_len = -(-max_len // ctx.tp_size) * ctx.tp_size
    step = make_serve_step(cfg, ctx, device=dev)

    before = _launches()
    cache = init_cache(cfg, b, max_len, device=dev, ctx=ctx)
    _sync(dev)
    t0 = time.perf_counter()
    with MOE.counting_drops() as fill_drops:
        with trace.span("serve.fill"):
            for i in range(prompt_len):
                logits, cache = step(params, {"tokens": prompts[:, i:i + 1],
                                              "cache": cache})
            _sync(dev)
        t_fill = time.perf_counter() - t0
        fill_logits = logits[:, -1].float()
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = [tok]
        t1 = time.perf_counter()
        with trace.span("serve.decode"):
            for _ in range(decode_steps - 1):
                logits, cache = step(params, {"tokens": _all_rows(tok, ctx)
                                              if b > 1 else tok,
                                              "cache": cache})
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                out.append(tok)
            _sync(dev)
        t_decode = time.perf_counter() - t1
    launches = {"fill_decode": _since(before)}
    dropped = {"fill_decode": sum(MOE.drop_counts(fill_drops))}

    prefill = make_prefill_step(cfg, ctx, device=dev)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patch_embeds"] = whole(params.embed)[
            prompts[:, :cfg.n_patches].long()].to(L.COMPUTE_DTYPE) \
            if ctx is not None else _embed(params, prompts[:, :cfg.n_patches])
    before = _launches()
    t2 = time.perf_counter()
    with MOE.counting_drops() as prefill_drops:
        pre_logits = prefill(params, batch)
        _sync(dev)
    t_prefill = time.perf_counter() - t2
    launches["prefill"] = _since(before)
    dropped["prefill"] = MOE.drop_counts(prefill_drops)
    pre_logits = pre_logits[:, -1, :cfg.vocab].float()
    check = prefill_check(pre_logits, fill_logits, prefill_bound(cfg))
    if ctx is not None:                 # the group's verdict and worst error
        agreed = torch.tensor([float(check["ok"]), -max(check["rel_l2"])],
                              device=dev)
        dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
        check["ok"] = bool(agreed[0])
        check["group_rel_l2_max"] = float(-agreed[1])

    gen = torch.cat(out, dim=1).cpu().numpy()
    tps = b * decode_steps / max(t_decode, 1e-9)
    result = {"arch": cfg.name, "requests": b,
              "prefill_s": round(t_fill, 2),
              "decode_s": round(t_decode, 2),
              "decode_tok_per_s": round(tps, 1),
              "sample": gen[0, :8].tolist(),
              "device": str(dev), "compute_dtype": str(L.COMPUTE_DTYPE),
              "prefill_step_s": t_prefill,
              "ms_per_decode_step": 1e3 * t_decode / max(decode_steps - 1, 1),
              "prefill_rel_l2_max": check.get("group_rel_l2_max",
                                              max(check["rel_l2"])),
              "prefill_bound": check["bound"],
              "prefill_ok": check["ok"], "launches": launches,
              "dropped": dropped,
              "mesh": mesh_shape(ctx.mesh) if ctx else host_mesh_shape()}
    return {"result": result, "prompts": rows, "tokens": gen,
            "fill_logits": fill_logits, "prefill_logits": pre_logits,
            "cache": cache, "launches": launches, "dropped": dropped,
            "check": check}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--prompt-version", type=str, default="-1",
                    help="prompt CVD version(s); comma-separated for a "
                         "fused multi-version wave (-1 = latest)")
    ap.add_argument("--wave-size", type=int, default=None,
                    help="flush the checkout wave once this many prompt "
                         "version requests are pending")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record spans and counters and write them to PATH "
                         "as a Chrome trace")
    args = ap.parse_args(argv)

    cfg = configs.get(configs.canonical(args.arch))
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.family == "encdec":
        raise SystemExit(ENCDEC_REFUSED)
    ctx, log, started = None, print, not dist.is_initialized()
    if args.mesh != "host":
        ctx = make_ctx(make_production_mesh(
            multi_pod=args.mesh == "multi",
            device=resolve_device(args.device)))
        if dist.get_rank() != 0:
            log = _quiet
    if args.trace:
        trace.enable()
    run = serve(cfg, requests=args.requests, prompt_len=args.prompt_len,
                decode_steps=args.decode_steps,
                prompt_version=args.prompt_version,
                wave_size=args.wave_size, seed=args.seed, device=args.device,
                ctx=ctx, log=log)
    if args.trace:
        trace.disable()
        if ctx is None or dist.get_rank() == 0:
            trace.export_chrome(args.trace)
    log(json.dumps(run["result"]))
    if ctx is not None and started:
        dist.destroy_process_group()
    return 0 if run["check"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
