"""Batched serving driver: the port of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch zamba2_2_7b \
        --requests 4 --prompt-len 512 --decode-steps 32
    python -m repro_torch.launch.serve --arch internlm2_1_8b --reduced \
        --device cpu --requests 4 --prompt-len 64 --decode-steps 4

Serves a model against a VERSIONED prompt store, as the reference does: the
requested prompt versions of a CVD are checked out in one fused wave through
the port's ``BatchedCheckoutServer``, and requests round-robin across them.
The cache is filled token by token through ``make_serve_step`` and the model
then decodes greedily; the JSON line the reference prints comes last.

The driver also runs the reference's serving prefill, ``make_prefill_step``,
once on the same prompts: that is the path through the flash-attention and
SSD-scan kernels (the token-by-token path reaches neither).  It reports the
prefill's time, the kernels' launches in each phase, and how far its
next-token logits lie from the token-by-token path's at the last prompt
position: the relative L2 error per request against a bound derived from
bf16 (``prefill_bound``), and whether the argmax agrees wherever the top-2
gap is clear of that bound.

``--device`` defaults to the card; ``--device cpu`` runs the kernels' plain
versions (the CPU tests).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from .. import configs
from ..core import generate, lyresplit_for_budget, to_tree
from ..data import VersionedDataset
from ..kernels import flash_attention as _fa
from ..kernels import ssd_scan as _ss
from ..kernels.ops import resolve_device
from ..models import layers as L
from ..models.transformer import (ArchConfig, check_supported, init_cache,
                                  init_params)
from ..serve.checkout import BatchedCheckoutServer
from ..serve.serve_step import make_prefill_step, make_serve_step
from ..sharding import make_ctx
from .mesh import make_host_mesh

ROUNDINGS_PER_BLOCK = 6   # norm, projections, conv or probabilities, gate, out


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink an assigned arch to host scale, same family/topology (the
    reference's ``launch.train.reduced_config`` for the families the port
    serves; its moe and mla branches wait for their slice)."""
    kw = dict(n_layers=min(cfg.n_layers, 2), d_model=256, vocab=1024,
              remat=False)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=64)
    if cfg.d_ff:
        kw["d_ff"] = 512
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


def depth(cfg: ArchConfig) -> int:
    """Residual blocks on the path: the layers, plus the hybrid's shared
    block applications."""
    shared = cfg.n_layers // cfg.shared_every if cfg.shared_every else 0
    return cfg.n_layers + shared


def prefill_bound(cfg: ArchConfig) -> float:
    """The relative L2 distance allowed between the prefill's and the
    token-by-token path's last-position logits in bf16: each block rounds
    to bf16 (u = 2^-8) at about ``ROUNDINGS_PER_BLOCK`` places, the two
    paths round at different places, and independent errors add in
    quadrature over the blocks: sqrt(2 · k · depth) · 2^-8 (0.107 for
    Zamba2-2.7B's 54 + 9 blocks)."""
    return math.sqrt(2 * ROUNDINGS_PER_BLOCK * depth(cfg)) * 2.0 ** -8


def prompt_store(vocab: int, *, requests: int, prompt_len: int,
                 prompt_version: str = "-1", wave_size=None, seed: int = 0,
                 device=None, log=print) -> np.ndarray:
    """The reference driver's prompts: a CUR workload of 8 versions whose
    records are ``prompt_len`` tokens (mod ``vocab``), partitioned by
    LyreSplit at 2|R|, checked out in ONE fused wave of the requested
    versions, cycled to ``requests`` rows.  (requests, prompt_len) int32."""
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
    log(f"mesh={make_host_mesh(ds.store.device).shape} serving {len(rows)} "
        f"requests from prompt CVD versions {vids} "
        f"({server.stats.waves} checkout wave)")
    return rows.astype(np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


def serve(cfg: ArchConfig, *, requests: int = 16, prompt_len: int = 64,
          decode_steps: int = 32, prompt_version: str = "-1",
          wave_size=None, seed: int = 0, device=None, params=None,
          log=print) -> dict:
    """Serve ``requests`` prompts from the versioned prompt store: fill the
    cache token by token, decode ``decode_steps`` tokens greedily, then run
    the serving prefill once on the same prompts and hold its next-token
    logits against the token-by-token path's.  ``params`` defaults to
    ``init_params`` from a generator seeded with ``seed`` on the device.

    Returns {"result": the reference's JSON fields and the prefill's,
    "prompts", "tokens" (numpy), "fill_logits", "prefill_logits",
    "cache", "launches" per phase, "check"}."""
    check_supported(cfg)
    dev = resolve_device(device)
    rows = prompt_store(cfg.vocab, requests=requests, prompt_len=prompt_len,
                        prompt_version=prompt_version, wave_size=wave_size,
                        seed=seed, device=dev, log=log)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = torch.from_numpy(rows).to(dev)
    b = prompts.shape[0]
    max_len = prompt_len + decode_steps
    step = make_serve_step(cfg, make_ctx(), device=dev)

    before = _launches()
    cache = init_cache(cfg, b, max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(prompt_len):
        logits, cache = step(params, {"tokens": prompts[:, i:i + 1],
                                      "cache": cache})
    _sync(dev)
    t_fill = time.perf_counter() - t0
    fill_logits = logits[:, -1].float()
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    t1 = time.perf_counter()
    for _ in range(decode_steps - 1):
        logits, cache = step(params, {"tokens": tok, "cache": cache})
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    launches = {"fill_decode": _since(before)}

    prefill = make_prefill_step(cfg, make_ctx(), device=dev)
    before = _launches()
    t2 = time.perf_counter()
    pre_logits = prefill(params, {"tokens": prompts})
    _sync(dev)
    t_prefill = time.perf_counter() - t2
    launches["prefill"] = _since(before)
    pre_logits = pre_logits[:, -1, :cfg.vocab].float()
    check = prefill_check(pre_logits, fill_logits, prefill_bound(cfg))

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
              "prefill_rel_l2_max": max(check["rel_l2"]),
              "prefill_bound": check["bound"],
              "prefill_ok": check["ok"], "launches": launches}
    return {"result": result, "prompts": rows, "tokens": gen,
            "fill_logits": fill_logits, "prefill_logits": pre_logits,
            "cache": cache, "launches": launches, "check": check}


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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get(configs.canonical(args.arch))
    if args.reduced:
        cfg = reduced_config(cfg)
    run = serve(cfg, requests=args.requests, prompt_len=args.prompt_len,
                decode_steps=args.decode_steps,
                prompt_version=args.prompt_version,
                wave_size=args.wave_size, seed=args.seed, device=args.device)
    print(json.dumps(run["result"]))
    return 0 if run["check"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
